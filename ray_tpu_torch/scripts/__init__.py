"""Command-line entry points of the port (``python -m
ray_tpu_torch.scripts.cli``)."""
