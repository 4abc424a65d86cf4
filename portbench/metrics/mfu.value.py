"""The whole valuation's share of the card's peak: the least time of the
traced calls' K1, K2 and K3 work, added, over the traced wall, in percent.
It bounds what any one kernel's roofline can give end to end."""

def read(t):
    if not t.events or t.window_s <= 0:
        return None
    return 100.0 * t.calls * sum(t.bounds.values()) / 1e3 / t.window_s
