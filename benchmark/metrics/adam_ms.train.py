"""Device ms a training step in the ``train.adam`` stage: the optimizer's
update and the in-place adds to the parameters. From the stage
sub-window's means (``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    return stages.read(run, "train.adam")
