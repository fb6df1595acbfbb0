"""Models of the port."""

from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config

__all__ = ["GPT2", "GPT2Config"]
