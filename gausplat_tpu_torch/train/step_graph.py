"""The captured step of ``Trainer.fit_scan``: :class:`StepGraph`, which
lives in :mod:`gausplat_tpu_torch.utils.step_graph` since the serving
entry points capture through it too; this path keeps the old import."""

from ..utils.step_graph import StepGraph

__all__ = ["StepGraph"]
