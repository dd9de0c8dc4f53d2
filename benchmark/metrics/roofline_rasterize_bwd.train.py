"""Kernel C's share of its roofline: its least time (bytes over 3.35 TB/s,
17 operations a blended pair over 67 TFLOP/s) over its device ms a step,
read by kernel name from the trace."""

from benchmark import workcount


def read(run):
    ms = run["trace"].port_kernel_ms("rasterize_backward_kernel")
    if not ms:
        return None
    return 100.0 * workcount.bound_ms(*workcount.stages(run["work"])["rasterize_backward"]) / ms
