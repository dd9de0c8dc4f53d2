"""The forward render pipeline and camera views."""

from .pipeline import render, render_views, RenderOptions, RenderOutput
from .view import View, Views

__all__ = ["RenderOptions", "RenderOutput", "View", "Views", "render", "render_views"]
