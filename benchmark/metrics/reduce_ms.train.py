"""Device ms a training step in the ``render.reduce`` stage: the per-point
sums of C's per-entry gradients (``reduce_entry_grads``) and the
densification norm. From the stage sub-window's means
(``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    return stages.read(run, "render.reduce")
