"""K3 (path_sim.cu) launches per call: one a held path set, and where a set
is over the path budget one checkpoint pass and one launch for each span the
passes draw again.  An exact count; it moves with the span rule or the
budget."""
from portbench import yardstick


def read(t):
    launches = t.kernels(yardstick.is_k3)
    if not launches or t.calls <= 0:
        return None
    return len(launches) / t.calls
