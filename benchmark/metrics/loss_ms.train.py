"""Device ms a training step in the loss (L1 + D-SSIM) and its VJP: the
``train.loss`` stage, and the part of ``train.backward`` before
``render.rasterize_vjp`` starts (autograd reaches the image's producer only
after every loss term's VJP). From the stage sub-window's means
(``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    parts = (stages.read(run, "train.loss"), stages.read(run, "train.backward", "start_ms"),
             stages.read(run, "render.rasterize_vjp", "start_ms"))
    if None in parts:
        return None
    loss, backward_start, vjp_start = parts
    return loss + vjp_start - backward_start
