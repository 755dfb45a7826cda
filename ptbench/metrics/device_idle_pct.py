"""device_idle_pct: the share of the traced slice in which no device
activity runs (the union of kernels, copies and sets)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
