"""Forward pass of a reprice: the harness's span around engines.lsmc.reprice,
ending in a device synchronise, in ms per reprice."""

def read(t):
    got = [s for name, s in t.spans if name == "forward"]
    return 1e3 * sum(got) / len(got) if got else None
