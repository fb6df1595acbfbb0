"""``ray_tpu_torch`` and ``chip_smoke.py`` stand alone: they import
nothing of JAX (jax, flax, optax, orbax) and nothing of ``ray_tpu``, and
the port's entry points refuse to run without a GPU unless told to use
the CPU."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"ray_tpu_torch must not import {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())

import ray_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                               "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = {"ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.sharding",
           "ray_tpu_torch.parallel.dryrun",
           "ray_tpu_torch.collective.device"} - set(names)
assert not missing, missing
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked

import torch
from ray_tpu_torch.core.accelerator import default_device
from ray_tpu_torch.models import (GPT2, GPT2Config, Llama, LlamaConfig,
                                  MoEConfig, MoETransformer, ResNet,
                                  ResNet50Config, ViT, ViTConfig)
from ray_tpu_torch.parallel import initialize, make_mesh
from ray_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from ray_tpu_torch.train import prefetch_to_device
assert not torch.cuda.is_available()
for entry in (default_device, initialize, make_mesh,
              lambda: spawn(print, 2), lambda: dryrun_multichip(2),
              lambda: GPT2(GPT2Config.tiny()),
              lambda: Llama(LlamaConfig.tiny()),
              lambda: ResNet(ResNet50Config.tiny()),
              lambda: ViT(ViTConfig.tiny()),
              lambda: MoETransformer(MoEConfig.tiny()),
              lambda: prefetch_to_device([])):
    try:
        entry()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("an entry point ran without a GPU")
GPT2(GPT2Config.tiny(), device="cpu")
Llama(LlamaConfig.tiny(), device="cpu")
ResNet(ResNet50Config.tiny(), device="cpu")
ViT(ViTConfig.tiny(), device="cpu")
MoETransformer(MoEConfig.tiny(), device="cpu")
print("OK", len(names))
"""


def test_package_imports_without_jax_and_needs_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD % (BLOCKED,)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 20   # every module was walked


def test_no_import_statement_names_jax_or_ray_tpu():
    """Also imports inside functions, which the run above cannot reach."""
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {m}" for m in mods
                          if m.split(".")[0] in BLOCKED]
    assert not offenders, offenders
