"""A served view's share of the chip's peak: the least time of a view's
forward stages (projection, binning, rasterize forward) over the measured
ms a view."""

from benchmark import workcount


def read(run):
    if not run.get("view_ms"):
        return None
    return 100.0 * workcount.least_ms(run["work"], workcount.SERVE_STAGES) / run["view_ms"]
