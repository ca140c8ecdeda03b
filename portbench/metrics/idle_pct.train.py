"""idle_pct.train (%): the share of the traced window that no kernel interval
covers (the union of the device's intervals against the window's host
clock)."""


def read(run):
    if run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
