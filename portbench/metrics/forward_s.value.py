"""Forward pass of a valuation: the program's ForwardSimulation stopwatch, in
s per valuation."""

def read(t):
    if not t.phases:
        return None
    return sum(p["ForwardSimulation"] for p in t.phases) / len(t.phases)
