"""Runnable examples of the port (counterparts of the repo's
``examples/``): ``python -m ray_tpu_torch.examples.<name>``. See
README.md."""
