"""``ray_tpu_torch.train.TorchTrainer`` against the JAX package's
``JaxTrainer``, and against the port's own multi-rank run.

- One worker: the JAX GPT-2 tiny loop under ``JaxTrainer`` and the
  port's under ``TorchTrainer`` (``device="cpu"``, float32, a gloo group
  of one rank), from the same numpy weights (``load_jax_params``) and
  batch, three steps. Reported losses within 2e-5 relative per step,
  ``tests/test_torch_train_step.py``'s tolerance for the same steps; the
  same metric keys; the same trial and checkpoint directory layout.
- Two gloo workers on ``dp = 2``: their losses against the same loop
  run by ``parallel.dryrun.spawn`` on two ranks with no runtime, within
  1e-6 (the same arithmetic: equal in practice).
- A loop that raises once, with ``FailureConfig(max_failures=1)``,
  restarts from its newest checkpoint in both packages.
- ``datasets=``: two workers (gloo on the port) read a ``train``
  dataset of TFRecord files split across them and an unsplit ``eval``
  (``DataConfig(datasets_to_split=["train"])``) through
  ``get_dataset_shard(name).iter_device_batches``, each rank training
  its own GPT-2 tiny from the same weights: per rank the same batches as
  ``JaxTrainer``'s and losses within 2e-5 relative; ``eval`` whole on
  both ranks; the port's mesh route (a ``dp`` mesh of the two ranks)
  gives each rank its half of every batch. ``iter_device_batches``
  yields CPU tensors equal to the numpy batches with ``device="cpu"``
  and raises without a card otherwise.

Each package's runtime starts once for the file (the JAX package's
first, shut down before the port's starts).
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("optax")

import torch_data_programs as data_programs  # noqa: E402
import torch_runtime_programs as programs  # noqa: E402

STEPS = 3
LOSS_RTOL = 2e-5        # test_torch_train_step.py's, per step
DATA_TRAIN_ROWS = 2 * STEPS * 4   # 2 ranks x STEPS batches of 4
DATA_EVAL_ROWS = 8
DP_LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_worker_left():
    """Torn down after the module's runtimes: none leaves a worker
    process behind for the tests that follow."""
    yield
    assert programs.workers_left() == []


def _weights() -> dict:
    import jax.numpy as jnp

    from ray_tpu.models import GPT2, GPT2Config
    params = GPT2(GPT2Config.tiny(dtype=jnp.float32)).init_params(
        jax.random.key(0))
    return jax.tree_util.tree_map(np.array, params)


def _fit(pkg: str, trainer_cls: str, loop, config: dict, storage: str,
         name: str, workers: int = 1, max_failures: int = 0):
    train = importlib.import_module(pkg + ".train")
    # The port's trainer holds a card a worker unless told otherwise.
    cpu = {"gpus_per_worker": 0} if pkg == "ray_tpu_torch" else {}
    trainer = getattr(train, trainer_cls)(
        loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=workers, **cpu),
        run_config=train.RunConfig(
            name=name, storage_path=storage,
            failure_config=train.FailureConfig(max_failures=max_failures)))
    return trainer.fit()


def _fit_data(pkg: str, trainer_cls: str, config: dict, storage: str,
              data_dir: str) -> object:
    """``data_loop`` on two workers over the TFRecord files of
    ``data_dir``: ``train`` split, ``eval`` replicated."""
    train = importlib.import_module(pkg + ".train")
    data = importlib.import_module(pkg + ".data")
    cpu = {"gpus_per_worker": 0} if pkg == "ray_tpu_torch" else {}

    def lm(name):
        return data.read_tfrecords(os.path.join(data_dir, name)
                                   ).map_batches(data_programs.lm_batch_of)
    trainer = getattr(train, trainer_cls)(
        data_programs.data_loop, train_loop_config=dict(config, pkg=pkg),
        scaling_config=train.ScalingConfig(num_workers=2, **cpu),
        run_config=train.RunConfig(name=f"{pkg}_data",
                                   storage_path=storage),
        datasets={"train": lm("train"), "eval": lm("eval")},
        dataset_config=train.DataConfig(datasets_to_split=["train"]))
    return trainer.fit()


def _layout(result) -> dict:
    """Names in the trial directory and in its newest checkpoint."""
    return {"trial": sorted(os.listdir(result.path)),
            "checkpoint": sorted(os.listdir(result.checkpoint_dir))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """Every fit of the file, the JAX package's runtime first."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import spawn

    storage = str(tmp_path_factory.mktemp("trainer_runs"))
    params = _weights()
    batch = programs.lm_batch(256, 64)
    one = {"params": params, "batch": batch, "steps": STEPS,
           "device": "cpu"}
    crash = {"steps": 4, "crash_at": 1}
    data_dir = str(tmp_path_factory.mktemp("trainer_data"))
    data_out = str(tmp_path_factory.mktemp("trainer_data_out"))
    codec = importlib.import_module("ray_tpu_torch.data.tfrecord")
    for name, rows, files in (("train", DATA_TRAIN_ROWS, 4),
                              ("eval", DATA_EVAL_ROWS, 2)):
        data_programs.write_lm_files(
            codec, os.path.join(data_dir, name),
            data_programs.lm_rows(rows, 256, 64, seed=len(name)), files)
    fed = {"params": params, "lr": programs.LR, "wd": programs.WD,
           "out": data_out}
    out = {"data_dir": data_dir, "data_out": data_out}
    ray_tpu.init(num_cpus=4)
    try:
        out["jax_gpt2"] = _fit("ray_tpu", "JaxTrainer",
                               programs.jax_gpt2_loop, one, storage,
                               "jax_gpt2")
        out["jax_crash"] = _fit("ray_tpu", "JaxTrainer",
                                programs.crash_once_loop,
                                dict(crash, pkg="ray_tpu"), storage,
                                "jax_crash", max_failures=1)
        out["jax_data"] = _fit_data("ray_tpu", "JaxTrainer", fed, storage,
                                    data_dir)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        out["torch_gpt2"] = _fit("ray_tpu_torch", "TorchTrainer",
                                 programs.torch_gpt2_loop, one, storage,
                                 "torch_gpt2")
        out["torch_dp2"] = _fit("ray_tpu_torch", "TorchTrainer",
                                programs.torch_gpt2_loop, one, storage,
                                "torch_dp2", workers=2)
        out["torch_crash"] = _fit("ray_tpu_torch", "TorchTrainer",
                                  programs.crash_once_loop,
                                  dict(crash, pkg="ray_tpu_torch"),
                                  storage, "torch_crash", max_failures=1)
        try:
            ray_tpu_torch.train.TorchTrainer(
                programs.torch_gpt2_loop).fit()
        except RuntimeError as e:
            out["default_on_no_card"] = e
        out["torch_data"] = _fit_data("ray_tpu_torch", "TorchTrainer", fed,
                                      storage, data_dir)
        it = ray_tpu_torch.data.read_tfrecords(
            os.path.join(data_dir, "eval")).map_batches(
                data_programs.lm_batch_of).iterator()
        out["cpu_feed"] = list(it.iter_device_batches(
            data_programs.LM_BATCH, device="cpu"))
        try:
            it.iter_device_batches(data_programs.LM_BATCH)
        except RuntimeError as e:
            out["feed_on_no_card"] = e
    finally:
        ray_tpu_torch.shutdown()
    out["spawn_dp2"] = spawn(programs.torch_gpt2_rank, 2, (one,),
                             device="cpu", timeout=120)
    return out


def _losses(result) -> list[float]:
    return [m["loss"] for m in result.metrics_history if "loss" in m]


def test_one_worker_losses_match_jax_trainer(runs):
    jax_r, torch_r = runs["jax_gpt2"], runs["torch_gpt2"]
    assert jax_r.error is None and torch_r.error is None, (
        jax_r.error, torch_r.error)
    want, got = _losses(jax_r), _losses(torch_r)
    assert len(want) == len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert len(set(got)) == STEPS            # the weights really moved


def test_metric_keys_and_directory_layout_match(runs):
    jax_r, torch_r = runs["jax_gpt2"], runs["torch_gpt2"]
    assert [sorted(m) for m in torch_r.metrics_history] == \
        [sorted(m) for m in jax_r.metrics_history]
    assert _layout(torch_r) == _layout(jax_r)
    assert _layout(torch_r) == {
        "trial": ["checkpoint_000003"],
        "checkpoint": [".complete_rank_0", "params", "position.json"]}
    assert os.path.basename(torch_r.path) == "torch_gpt2"


def test_checkpoint_restores_the_train_state(runs):
    """The trainer's checkpoint holds the state after the last step: a
    restored state's next loss is the uninterrupted run's next loss."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn

    result = runs["torch_gpt2"]
    params = _weights()
    batch = {k: torch.from_numpy(v)
             for k, v in programs.lm_batch(256, 64).items()}

    def fresh(seed=None):
        model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                     seed=seed or 0)
        if seed is None:
            model.load_jax_params(params)
        opt = train.adamw(programs.LR, weight_decay=programs.WD,
                          mu_dtype=torch.bfloat16)
        return (train.init_train_state(model, opt),
                train.make_train_step(gpt2_loss_fn(ce_chunk=64), opt))

    state, step = fresh()
    for _ in range(STEPS):
        state, _ = step(state, batch)
    state, m = step(state, batch)
    restored, step2 = fresh(seed=5)
    train.restore_train_state(
        os.path.join(result.checkpoint_dir, "params"), restored)
    restored, m2 = step2(restored, batch)
    assert float(m2["loss"]) == float(m["loss"])


def test_two_gloo_workers_match_the_spawned_dp2_run(runs):
    result = runs["torch_dp2"]
    assert result.error is None, result.error
    ranks = runs["spawn_dp2"]
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose(_losses(result), ranks[0],
                               rtol=DP_LOSS_RTOL)
    assert len(set(ranks[0])) == STEPS


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_failed_loop_restarts_from_its_checkpoint(runs, pkg):
    result = runs[f"{pkg}_crash"]
    assert result.error is None, result.error
    # The second attempt resumed after step 1 (the crash came after its
    # checkpoint) and reported steps 2 and 3 only.
    assert [m["step"] for m in result.metrics_history] == [2, 3]
    assert all(m["resumed"] for m in result.metrics_history)
    assert os.path.basename(result.checkpoint_dir) == "checkpoint_000003"


def _rank_files(runs, pkg: str) -> list[dict]:
    import json
    out = []
    for rank in (0, 1):
        with open(os.path.join(runs["data_out"],
                               f"{pkg}_rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _numpy_batches(name: str, shard: int | None = None) -> list[dict]:
    """The LM batches of dataset ``name`` straight from numpy: the whole
    dataset, or the rows of blocks (files) ``shard``, ``shard + 2``, ...
    as ``streaming_split(2)`` gives rank ``shard``."""
    rows = data_programs.lm_rows(
        DATA_TRAIN_ROWS if name == "train" else DATA_EVAL_ROWS, 256, 64,
        seed=len(name)).astype(np.int32)
    if shard is not None:
        rows = np.concatenate(np.array_split(rows, 4)[shard::2])
    b = data_programs.LM_BATCH
    return [{"tokens": rows[i:i + b, :-1], "targets": rows[i:i + b, 1:]}
            for i in range(0, len(rows), b)]


def test_dataset_shards_give_each_rank_the_jax_trainers_batches(runs):
    for pkg in ("jax", "torch"):
        assert runs[f"{pkg}_data"].error is None, runs[f"{pkg}_data"].error
    jax_ranks = _rank_files(runs, "ray_tpu")
    torch_ranks = _rank_files(runs, "ray_tpu_torch")
    for rank in (0, 1):
        want = [data_programs._checksums(b)
                for b in _numpy_batches("train", rank)]
        assert len(want) == STEPS
        assert torch_ranks[rank]["sums"] == jax_ranks[rank]["sums"] == want


def test_losses_on_dataset_shards_match_jax_trainer(runs):
    jax_ranks = _rank_files(runs, "ray_tpu")
    torch_ranks = _rank_files(runs, "ray_tpu_torch")
    for want, got in zip(jax_ranks, torch_ranks):
        assert len(got["losses"]) == len(want["losses"]) == STEPS
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    assert torch_ranks[0]["losses"] != torch_ranks[1]["losses"]
    reported = [m["loss"] for m in runs["torch_data"].metrics_history]
    assert reported == torch_ranks[0]["losses"]


def test_unsplit_dataset_replicates_to_both_ranks(runs):
    want = [data_programs._checksums(b) for b in _numpy_batches("eval")]
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        assert [r["eval"] for r in _rank_files(runs, pkg)] == [want, want]


def test_mesh_route_gives_each_rank_its_half(runs):
    half = data_programs.LM_BATCH // 2
    for rank, r in enumerate(_rank_files(runs, "ray_tpu_torch")):
        want = [data_programs._checksums(
            {k: v[rank * half:(rank + 1) * half] for k, v in b.items()})
            for b in _numpy_batches("eval")]
        assert r["halves"] == want
        assert r["half_types"] == [f"Tensor:cpu:({half}, 64)"]
        # A block task submitted from inside the train worker ran in
        # another process, which holds no card.
        assert r["probe"]["cuda"] == "" and r["probe"]["loaded"] == ""
        assert int(r["probe"]["pid"]) != r["loop_pid"]


def test_iter_device_batches_on_the_cpu_and_without_a_card(runs):
    got = runs["cpu_feed"]
    want = _numpy_batches("eval")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == ["tokens", "targets"]
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == \
                "cpu" and g[k].dtype == torch.int32
            assert np.array_equal(g[k].numpy(), w[k])
    err = runs.get("feed_on_no_card")
    assert err is not None and "no CUDA device" in str(err), err


def test_trainer_asks_for_the_card_by_default(runs):
    """Workers hold a GPU each unless the caller asks for the CPU; on a
    cluster without cards fit() says so instead of waiting."""
    from ray_tpu_torch.train import ScalingConfig
    default = ScalingConfig()
    assert default.gpus_per_worker == 1 and default.device == "cuda"
    assert default.worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    cpu = ScalingConfig(gpus_per_worker=0)
    assert cpu.device == "cpu" and "GPU" not in cpu.worker_resources()
    err = runs.get("default_on_no_card")
    assert err is not None and "gpus_per_worker=0" in str(err), err


_RENDEZVOUS_CHILD = r"""
import errno, socket
import torch
import torch.distributed as dist
from ray_tpu_torch.train.worker_group import TrainWorker
worker = TrainWorker._cls(0, 1, {})
host, port = worker.get_coordinator().rsplit(":", 1)
s = socket.socket()
try:
    s.bind((host, int(port)))
    s.listen()
    taken = False
except OSError as e:
    taken = e.errno == errno.EADDRINUSE
finally:
    s.close()
assert taken, f"port {port} was free between its choice and the group"
worker.setup_distributed(f"{host}:{port}", "cpu")
t = torch.ones(3)
dist.all_reduce(t)
assert dist.get_world_size() == 1 and t.tolist() == [1.0, 1.0, 1.0]
dist.destroy_process_group()
print("OK")
"""


def test_rendezvous_port_is_held_from_its_choice_to_the_group():
    """Rank 0's rendezvous port is bound from ``get_coordinator`` on (a
    listening socket cannot take it), and the gang's env:// rendezvous
    in that process joins through it. A port picked free and released
    again was taken in between under load (EADDRINUSE at the group's
    start)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _RENDEZVOUS_CHILD],
                          cwd=root, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
