"""Path simulation of a valuation: the program's Regression- and
ValuationPriceSimulation stopwatches (under streaming, the checkpoint passes
only), in s per valuation."""

def read(t):
    if not t.phases:
        return None
    return sum(p["RegressionPriceSimulation"] + p["ValuationPriceSimulation"]
               for p in t.phases) / len(t.phases)
