"""The split gain kernel's share of its roofline, in %: the least time of
the work the profiled trees needed of it (``bench.work``, counted from
the tree: each scored node's cases and histogram cells) over the kernel's
device time in the trace.  None where the trace holds no launch of it."""


def read(run):
    if run.device is None:
        return None
    kernel_s = run.device.kernel_s("split_gain")
    if kernel_s <= 0:
        return None
    return 100 * run.work.split_gain_s() * run.device_trees / kernel_s
