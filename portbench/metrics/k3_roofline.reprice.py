"""K3 (path_sim.cu) in the reprice cell: the least time of the traced calls'
path sets over its launches' summed device time, in percent."""
from portbench import yardstick


def read(t):
    return t.roofline("k3", yardstick.is_k3)
