"""device_idle_share: the share of the traced slice of the window in
which no kernel, copy or set ran on the card, in percent:
``1 - busy / span`` from torch.profiler's device events."""


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
