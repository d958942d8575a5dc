"""The device's idle share of the profiled window, in percent: 1 − the
union of the kernels', copies' and fills' intervals ÷ the window's host
clock (first call to the synchronise after the last)."""


def read(t):
    tr = getattr(t, "trace", None)
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
