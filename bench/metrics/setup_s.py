"""Seconds from the harness's start to the window's: imports, the card,
the inputs made from the seed, the kernels loaded (built on a checkout's
first run) and one warm-up tree."""


def read(run):
    return run.setup_s
