"""K2 (forward_sim.cu) in the reprice cell: the least time of the traced
calls' forward pass over its launches' summed device time, in percent."""
from portbench import yardstick


def read(t):
    return t.roofline("k2", yardstick.is_k2)
