"""Device ms a training step in the ``render.bin`` stage: the touched-tile
counts, their scan, B and the sort of the (tile, depth) keys. From the
stage sub-window's means (``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    return stages.read(run, "render.bin")
