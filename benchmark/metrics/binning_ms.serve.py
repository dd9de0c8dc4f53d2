"""Device ms a served view in the ``render.bin`` stage (the counts, the
scan, B and the sort): the mean over a request's views of the stage's
interval on the view's own stream, under the other views' overlap. From
the stage sub-window's means (``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    return stages.read(run, "render.bin", "ms")
