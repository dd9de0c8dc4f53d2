"""Command-line entry points (run with ``python -m gausplat_tpu_torch.scripts.<name>``)."""
