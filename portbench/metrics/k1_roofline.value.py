"""K1 (backward_update.cu): the least time of the traced calls' K1 work (one
backward update a decision step) over its launches' summed device time,
in percent."""
from portbench import yardstick


def read(t):
    return t.roofline("k1", yardstick.is_k1)
