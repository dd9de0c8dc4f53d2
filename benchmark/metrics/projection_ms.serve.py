"""Device ms a served view in the ``render.project`` stage: the mean over a
request's views of the stage's interval on the view's own stream. The
views' streams overlap, so the serving stages of a view can add up to more
than its share of the request. From the stage sub-window's means
(``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    return stages.read(run, "render.project", "ms")
