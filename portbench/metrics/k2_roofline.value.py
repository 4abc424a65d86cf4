"""K2 (forward_sim.cu) in the valuation cells: the least time of the traced
calls' forward pass (with panels where the cell returns them) over its
launches' summed device time, in percent."""
from portbench import yardstick


def read(t):
    return t.roofline("k2", yardstick.is_k2)
