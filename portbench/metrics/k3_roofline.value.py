"""K3 (path_sim.cu) in the valuation cells: the least time of the traced
calls' path sets (drawn again where a set outgrows the path budget) over
its launches' summed device time, in every mode launched, in percent."""
from portbench import yardstick


def read(t):
    return t.roofline("k3", yardstick.is_k3)
