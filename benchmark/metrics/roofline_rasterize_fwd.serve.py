"""Kernel A's share of its roofline: its least time over its device ms a
view, read by kernel name from the trace."""

from benchmark import workcount


def read(run):
    ms = run["trace"].port_kernel_ms("rasterize_forward_kernel")
    if not ms:
        return None
    return 100.0 * workcount.bound_ms(*workcount.stages(run["work"])["rasterize_forward"]) / ms
