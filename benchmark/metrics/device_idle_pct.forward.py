"""Share of the traced window in which no device operation ran."""


def read(r):
    t = r.timeline
    if t is None or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
