"""Backward induction of a valuation: the program's BackwardInduction
stopwatch, in s per valuation."""

def read(t):
    if not t.phases:
        return None
    return sum(p["BackwardInduction"] for p in t.phases) / len(t.phases)
