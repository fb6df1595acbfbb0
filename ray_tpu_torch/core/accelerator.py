"""GPU detection and the default device of the port.

Counterpart of ``ray_tpu/core/accelerator.py`` (which detects TPU chips).
Entry points of ``ray_tpu_torch`` run on the card by default: they call
:func:`default_device`, which raises when no GPU is visible. Only an
explicit ``device="cpu"`` from the caller runs them on the CPU.
"""

from __future__ import annotations

import torch


def detect_gpus() -> int:
    """Number of CUDA devices this process can see."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """``cuda:0``; raises RuntimeError when no GPU is visible."""
    if detect_gpus() == 0:
        raise RuntimeError(
            "no CUDA device is visible to this process; ray_tpu_torch runs "
            "on the GPU by default (pass device='cpu' to run on the CPU)")
    return torch.device("cuda", 0)


def resolve_device(device: str | torch.device | None,
                   mesh=None) -> torch.device:
    """The caller's ``device``; else the device of ``mesh`` (this rank's,
    ``parallel.mesh.Mesh``); else :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    return mesh.device if mesh is not None else default_device()
