"""Models of the port."""

from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
from ray_tpu_torch.models.llama import Llama, LlamaConfig, llama_loss_fn
from ray_tpu_torch.models.moe import (
    MoEBlock,
    MoEConfig,
    MoETransformer,
    SwitchFFN,
    moe_loss_fn,
)
from ray_tpu_torch.models.resnet import ResNet, ResNet50Config, resnet_loss_fn
from ray_tpu_torch.models.vit import ViT, ViTConfig, vit_loss_fn

__all__ = ["GPT2", "GPT2Config", "Llama", "LlamaConfig", "llama_loss_fn",
           "MoEConfig", "SwitchFFN", "MoEBlock", "MoETransformer",
           "moe_loss_fn",
           "ResNet", "ResNet50Config", "resnet_loss_fn", "ViT", "ViTConfig",
           "vit_loss_fn"]
