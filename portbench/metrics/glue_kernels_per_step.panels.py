"""``glue_kernels_per_step.value``, read in the panels cell, where no end-to-end time is held."""
from portbench.trace import reader


def read(t):
    return reader("glue_kernels_per_step.value")(t)
