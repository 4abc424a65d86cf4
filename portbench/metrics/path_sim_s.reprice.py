"""Path simulation of a reprice: the harness's span around
simulate_factor_paths, ending in a device synchronise, in ms per reprice."""

def read(t):
    got = [s for name, s in t.spans if name == "path_sim"]
    return 1e3 * sum(got) / len(got) if got else None
