"""The shared-memory split-gain kernel's share of its roofline, in %: the
least time of the split-gain work the profiled trees needed (``bench.work``,
counted from the tree, whatever kernel does it) over the device time of
the operations whose name holds ``split_gain_kernel`` (which the register
kernel, ``split_gain_regs_kernel``, does not).  None where the trace holds
no launch of it."""

KERNEL = "split_gain_kernel"


def read(run):
    if run.device is None:
        return None
    kernel_s = sum(s for name, s in run.device.op_s.items() if KERNEL in name)
    if kernel_s <= 0:
        return None
    return 100 * run.work.split_gain_s() * run.device_trees / kernel_s
