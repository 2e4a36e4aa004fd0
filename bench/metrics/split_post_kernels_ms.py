"""Milliseconds a tree of card time in splitPost's two kernels: the device
time of the operations whose name holds ``split_post_nodes_kernel`` or
``split_post_route_kernel``, summed over the trees the profiler traced and
divided by their number.  The node kernel's work grows with the classes
(left, right and unknown counts of each) and with the children of a
multiway split; the routing kernel's with the live and waiting cases.
None without a device trace or without a launch of either kernel."""

KERNELS = ("split_post_nodes_kernel", "split_post_route_kernel")


def read(run):
    if run.device is None or not run.device_trees:
        return None
    kernel_s = sum(s for name, s in run.device.op_s.items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    return kernel_s / run.device_trees * 1e3
