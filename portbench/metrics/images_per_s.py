"""images_per_s: every image whose result came back inside the window,
over the window's seconds (client clock)."""


def read(run):
    return run.outcome.images / run.seconds
