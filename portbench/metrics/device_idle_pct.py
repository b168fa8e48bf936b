"""The share of the traced stretch of the window in which no kernel, copy
or set ran on the card (torch.profiler, portbench.trace.reduce)."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
