"""``device_idle.value``, read in the panels cell, where no end-to-end time is held."""
from portbench.trace import reader


def read(t):
    return reader("device_idle.value")(t)
