"""The device's idle share of the traced valuations: one minus the union of
its activity intervals over the traced wall, in percent."""

def read(t):
    if not t.events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
