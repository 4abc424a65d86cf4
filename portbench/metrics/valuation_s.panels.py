"""The wall of one traced valuation in the panels cell: the traced window's
host wall over its calls, in s.  It stands in for ``valuation_s``, which is
not held there: the host's speed drifts too far between runs of a
launch-bound cell for any bound to hold it."""

def read(t):
    if t.window_s <= 0 or not t.calls:
        return None
    return t.window_s / t.calls
