"""The whole training step's share of the chip's peak: the least time of a
step (benchmark/workcount.py, every stage, the reference's counts of the
step's views) over the measured ms a step."""

from benchmark import workcount


def read(run):
    if not run.get("step_ms"):
        return None
    return 100.0 * workcount.least_ms(run["work"]) / run["step_ms"]
