"""The forward render pipeline and camera views."""
