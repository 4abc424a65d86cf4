"""Host time of a valuation outside its four phases: the program's stopwatch
"All" minus the two path simulations, the backward induction and the forward
pass (host compile, intrinsic DP, trigger prices, result assembly), in s per
valuation."""

def read(t):
    if not t.phases:
        return None
    phases = ("RegressionPriceSimulation", "ValuationPriceSimulation", "BackwardInduction",
              "ForwardSimulation")
    return sum(p["All"] - sum(p[k] for k in phases) for p in t.phases) / len(t.phases)
