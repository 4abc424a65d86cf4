"""Device operations in the backward window (first to last K1 launch of a
call) that are neither K1 nor K3, per decision step: the glue between the
backward kernels.  The count repeats exactly from run to run."""
from portbench import yardstick


def read(t):
    windows = t.backward_windows()
    if not windows:
        return None
    glue = sum(1 for w in windows for _, _, n in w if not (yardstick.is_k1(n) or
                                                           yardstick.is_k3(n)))
    return glue / (t.steps * t.calls)
