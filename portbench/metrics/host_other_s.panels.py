"""``host_other_s.value``, read in the panels cell, where no end-to-end time is held."""
from portbench.trace import reader


def read(t):
    return reader("host_other_s.value")(t)
