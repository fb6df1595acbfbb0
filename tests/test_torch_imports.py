"""``ray_tpu_torch`` and ``chip_smoke.py`` stand alone: they import
nothing of JAX (jax, flax, optax, orbax) and nothing of ``ray_tpu``, and
the port's entry points refuse to run without a GPU unless told to use
the CPU. The multi-node host processes (the node daemon, the head
daemon, the op log) and what drives them import no torch either, nor do
the dashboard, job submission and the autoscaler."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest

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
           "ray_tpu_torch.collective.device",
           "ray_tpu_torch.core.runtime", "ray_tpu_torch.core.worker",
           "ray_tpu_torch.core.worker_entry", "ray_tpu_torch.native.store",
           "ray_tpu_torch.runtime_env.plugins", "ray_tpu_torch.util.tracing",
           "ray_tpu_torch.observability.plane",
           "ray_tpu_torch.train.trainer", "ray_tpu_torch.serve.api",
           "ray_tpu_torch.serve.proxy", "ray_tpu_torch.serve.grpc_proxy",
           "ray_tpu_torch.experimental.internal_kv",
           "ray_tpu_torch.cluster_utils", "ray_tpu_torch.tune.tune",
           "ray_tpu_torch.tune.search", "ray_tpu_torch.tune.schedulers",
           "ray_tpu_torch.tune.pb2", "ray_tpu_torch.tune.registry",
           "ray_tpu_torch.tune.classic", "ray_tpu_torch.tune.compat",
           "ray_tpu_torch.tune.optuna", "ray_tpu_torch.train.torch",
           "ray_tpu_torch.train.huggingface",
           "ray_tpu_torch.train.sklearn",
           "ray_tpu_torch.collective.host", "ray_tpu_torch.collective.mesh",
           "ray_tpu_torch.collective.communicator",
           "ray_tpu_torch.rllib.algorithm", "ray_tpu_torch.rllib.catalog",
           "ray_tpu_torch.rllib.checkpoints",
           "ray_tpu_torch.rllib.connectors",
           "ray_tpu_torch.rllib.env_runner", "ray_tpu_torch.rllib.learner",
           "ray_tpu_torch.rllib.learner_group",
           "ray_tpu_torch.rllib.models", "ray_tpu_torch.rllib.multi_agent",
           "ray_tpu_torch.rllib.offline", "ray_tpu_torch.rllib.impala",
           "ray_tpu_torch.rllib.appo", "ray_tpu_torch.rllib.dqn",
           "ray_tpu_torch.rllib.sac", "ray_tpu_torch.rllib.cql",
           "ray_tpu_torch.rllib.bc", "ray_tpu_torch.rllib.marwil",
           "ray_tpu_torch.rllib.dreamer", "ray_tpu_torch.util.queue",
           "ray_tpu_torch.util.multiprocessing", "ray_tpu_torch.util.joblib",
           "ray_tpu_torch.util.scheduling_strategies",
           "ray_tpu_torch.util.chaos", "ray_tpu_torch.util.ha",
           "ray_tpu_torch.util.usage", "ray_tpu_torch.util.logdir",
           "ray_tpu_torch.util.mm_probe",
           "ray_tpu_torch.experimental.pubsub",
           "ray_tpu_torch.core.node_daemon", "ray_tpu_torch.core.head",
           "ray_tpu_torch.core.oplog", "ray_tpu_torch.client_builder",
           "ray_tpu_torch.dashboard.agent", "ray_tpu_torch.dag.dag_node",
           "ray_tpu_torch.dag.compiled_dag", "ray_tpu_torch.dag.comm_channel",
           "ray_tpu_torch.experimental.channel", "ray_tpu_torch.native.channel",
           "ray_tpu_torch.workflow.api", "ray_tpu_torch.workflow.storage",
           "ray_tpu_torch.workflow.common", "ray_tpu_torch.dashboard.head",
           "ray_tpu_torch.dashboard.system_metrics",
           "ray_tpu_torch.dashboard.metrics_config",
           "ray_tpu_torch.job_submission", "ray_tpu_torch.autoscaler",
           "ray_tpu_torch.autoscaler.autoscaler",
           "ray_tpu_torch.autoscaler.node_provider",
           "ray_tpu_torch.autoscaler.fake_provider",
           "ray_tpu_torch.autoscaler.sdk", "ray_tpu_torch.autoscaler.k8s",
           "ray_tpu_torch.autoscaler.launcher",
           "ray_tpu_torch.scripts.cli", "ray_tpu_torch.perf",
           "ray_tpu_torch.cpp", "ray_tpu_torch.cross_language",
           "ray_tpu_torch.observability.chrome_trace",
           "ray_tpu_torch.examples.core_tasks_actors",
           "ray_tpu_torch.examples.cpp_tasks",
           "ray_tpu_torch.examples.data_pipeline",
           "ray_tpu_torch.examples.rllib_dreamer",
           "ray_tpu_torch.examples.rllib_ppo",
           "ray_tpu_torch.examples.serve_compose",
           "ray_tpu_torch.examples.train_gpt2_mesh",
           "ray_tpu_torch.examples.tune_asha",
           "ray_tpu_torch.examples.tune_classic",
           "ray_tpu_torch.examples.workflow_events"} - set(names)
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
from ray_tpu_torch.rllib import TorchLearner
from ray_tpu_torch.rllib.catalog import build_actor_critic
from ray_tpu_torch.rllib.dqn import DQNHyperparams, DQNLearner
from ray_tpu_torch.rllib.dreamer import (DreamerHyperparams, DreamerLearner,
                                         DreamerModelConfig)
from ray_tpu_torch.rllib.sac import SACHyperparams, SACLearner
from ray_tpu_torch.util.mm_probe import achievable_matmul_tflops
assert not torch.cuda.is_available()
for entry in (default_device, initialize, make_mesh,
              lambda: spawn(print, 2), lambda: dryrun_multichip(2),
              lambda: GPT2(GPT2Config.tiny()),
              lambda: Llama(LlamaConfig.tiny()),
              lambda: ResNet(ResNet50Config.tiny()),
              lambda: ViT(ViTConfig.tiny()),
              lambda: MoETransformer(MoEConfig.tiny()),
              lambda: prefetch_to_device([]),
              lambda: TorchLearner({"obs_dim": 4, "num_actions": 2}),
              lambda: build_actor_critic({"obs_dim": 4, "num_actions": 2}),
              lambda: DQNLearner({"obs_dim": 4, "num_actions": 2},
                                 DQNHyperparams()),
              lambda: SACLearner({"obs_dim": 3, "action_dim": 1},
                                 SACHyperparams()),
              lambda: DreamerLearner(DreamerModelConfig(),
                                     DreamerHyperparams()),
              lambda: achievable_matmul_tflops(m=64, k_short=1, k_long=2)):
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
TorchLearner({"obs_dim": 4, "num_actions": 2}, device="cpu")
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


_HOST_CHILD = r"""
import importlib, importlib.abc, sys
BLOCKED = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"%s must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
importlib.import_module("%s")
print("OK")
"""


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.core.node_daemon", "ray_tpu_torch.core.head",
    "ray_tpu_torch.core.oplog", "ray_tpu_torch.cluster_utils",
    "ray_tpu_torch.client_builder", "ray_tpu_torch.dashboard.agent"])
def test_multi_node_host_modules_import_no_torch_and_no_jax(module):
    """A node daemon is a host process: only the workers it spawns touch
    a card. These modules load nothing of torch, JAX or ``ray_tpu``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c",
         _HOST_CHILD % (BLOCKED + ("torch",), module, module)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.dag", "ray_tpu_torch.workflow",
    "ray_tpu_torch.experimental.channel"])
def test_dag_and_workflow_modules_import_no_torch(module):
    """A DAG, its channels and a workflow load no torch (nor JAX, nor
    ``ray_tpu``): torch comes in with a tensor that a value carries."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c",
         _HOST_CHILD % (BLOCKED + ("torch",), module, module)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.dashboard", "ray_tpu_torch.dashboard.system_metrics",
    "ray_tpu_torch.dashboard.metrics_config", "ray_tpu_torch.job_submission",
    "ray_tpu_torch.autoscaler", "ray_tpu_torch.autoscaler.fake_provider",
    "ray_tpu_torch.autoscaler.k8s", "ray_tpu_torch.autoscaler.launcher"])
def test_dashboard_jobs_and_autoscaler_modules_import_no_torch(module):
    """The dashboard, a job's supervisor and the autoscaler run on the
    head's host: they load no torch (nor JAX, nor ``ray_tpu``). A job
    reaches a card only through the ``num_gpus`` tasks of its session."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c",
         _HOST_CHILD % (BLOCKED + ("torch",), module, module)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.scripts.cli", "ray_tpu_torch.perf", "ray_tpu_torch.cpp",
    "ray_tpu_torch.cross_language",
    "ray_tpu_torch.observability.chrome_trace"])
def test_cli_perf_cpp_and_trace_modules_import_no_torch(module):
    """The CLI, the microbenchmarks, C++ tasks and the trace summary are
    host code: they load no torch (nor JAX, nor ``ray_tpu``). ``doctor``
    alone imports torch, inside its own function, to report the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c",
         _HOST_CHILD % (BLOCKED + ("torch",), module, module)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"


_STEP_CHILD = """
import sys
import numpy as np
import torch
from ray_tpu_torch.models import GPT2, GPT2Config, Llama, LlamaConfig
from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
from ray_tpu_torch.models.moe import MoEConfig, MoETransformer
from ray_tpu_torch.train import adamw, init_train_state, make_train_step
import chip_smoke  # noqa: F401 — a job's task imports it
cfg = GPT2Config.tiny(seq_len=64, vocab_size=256, n_embd=128, n_head=2)
model = GPT2(cfg, seed=0, device="cpu")
Llama(LlamaConfig.tiny(), device="cpu")
MoETransformer(MoEConfig.tiny(), device="cpu")
opt = adamw(1e-3)
state = init_train_state(model, opt)
step = make_train_step(gpt2_loss_fn(), opt)
toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
batch = {"tokens": torch.from_numpy(toks),
         "targets": torch.from_numpy(np.roll(toks, -1, 1))}
for _ in range(2):
    state, metrics = step(state, batch)
assert np.isfinite(float(metrics["loss"]))
print(sorted(m for m in %r if m in sys.modules))
"""


def test_a_train_step_imports_no_dynamo_dtensor_or_dcp():
    """A worker that builds the models and runs GPT-2 train steps through
    the flash op loads neither ``torch._dynamo`` nor
    ``torch.distributed.tensor`` (sympy under both) nor
    ``torch.distributed.checkpoint``: importing each costs a worker's
    start seconds. FSDP2, DTensor placements and checkpoints load them
    when they are used."""
    heavy = ("torch._dynamo", "torch.distributed.tensor", "sympy",
             "torch.distributed.checkpoint")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _STEP_CHILD % (heavy,)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
