"""setup_s: seconds from the process's start to the window's opening:
imports, the kernel build or its cache, weights and inputs, compile,
prewarm of every dispatch level, and the warm-up traffic."""


def read(run):
    return run.setup_s
