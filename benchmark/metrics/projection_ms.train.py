"""Device ms a training step in the projection and its VJP: the
``render.project`` stage (projection, SH, the per-point rows), and the part
of ``train.backward`` after ``render.rasterize_vjp`` ends (every loss term
depends on the image alone, so autograd takes the projection's VJP last).
From the stage sub-window's means (``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    parts = (stages.read(run, "render.project"), stages.read(run, "train.backward", "end_ms"),
             stages.read(run, "render.rasterize_vjp", "end_ms"))
    if None in parts:
        return None
    project, backward_end, vjp_end = parts
    return project + backward_end - vjp_end
