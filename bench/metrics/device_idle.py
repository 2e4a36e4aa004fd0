"""The share, in %, of the traced window's profiled part (its trees from
the first boundary past half of the window) in which no kernel, copy or
fill ran on the card."""


def read(run):
    if run.device is None or run.device.busy_s <= 0:
        return None
    return 100 * (1 - run.device.busy_s / run.device.window_s)
