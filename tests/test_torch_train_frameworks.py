"""The framework modules of the port's Train (``train.torch``,
``train.huggingface``, ``train.sklearn``) against the JAX package's, and
remote (``mock-s3://``) checkpoints.

The programs of tests/test_train_frameworks.py run on both packages, the
JAX package's runtime first, each with ``num_cpus=4``: a sklearn
estimator fitted by ``SklearnTrainer``, a local ``nn.Linear`` trained by
``TransformersTrainer`` (no download), and DDP loops through
``prepare_model`` and ``prepare_data_loader`` on 2 and 4 gloo ranks,
where each rank's loss trajectory must agree within 1e-6 relative and
each rank's sampler shard must be equal. The compat surface is asserted
per package, with the port's differences (README): ``TorchConfig()``'s
backend is the device's (nccl on the card, gloo on the CPU) where the
JAX package allows gloo alone; ``get_device()`` is the rank's device in a
process group and the card outside one (so it raises on a host without
one), where the JAX package always answers ``cpu``.

Remote checkpoints, on the port: ``save_pytree``/``restore_pytree`` and
``save_train_state``/``restore_train_state`` round trip through
``mock-s3://`` bit-equal, as does a ``TorchTrainer`` whose
``storage_path`` is ``mock-s3://``.
"""

from __future__ import annotations

import importlib
import os
import tempfile

import numpy as np
import pytest
import torch

import torch_runtime_programs
import torch_tune_programs as programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_worker_left():
    yield
    assert torch_runtime_programs.workers_left() == []


def _scaling(pkg: str, n: int):
    train = importlib.import_module(f"{pkg}.train")
    if pkg == "ray_tpu":
        return train.ScalingConfig(num_workers=n)
    return train.ScalingConfig(num_workers=n, gpus_per_worker=0)


def ddp_loop(config):
    """A linear model under DDP on 32 rows in shuffled batches of 4, two
    epochs; rank 0 reports every rank's losses and the rows it saw."""
    import torch.distributed as dist
    from torch import nn
    from torch.utils.data import DataLoader, TensorDataset

    train = programs._train()
    tt = importlib.import_module(f"{train.__name__}.torch")
    torch.set_num_threads(1)
    torch.manual_seed(0)
    model = tt.prepare_model(nn.Linear(4, 1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, 4)).astype(np.float32))
    loader = tt.prepare_data_loader(DataLoader(
        TensorDataset(torch.arange(32), x, x.sum(1, keepdim=True)),
        batch_size=4, shuffle=True))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    losses, seen = [], []
    for _ in range(2):
        for idx, xb, yb in loader:
            opt.zero_grad()
            loss = ((model(xb) - yb) ** 2).mean()
            loss.backward()
            opt.step()
            losses.append(float(loss))
            seen.append(idx.tolist())
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"losses": losses, "seen": seen})
    train.report({"ranks": ranks, "world": dist.get_world_size()})


def _ddp(pkg: str, n: int, storage: str):
    tt = importlib.import_module(f"{pkg}.train.torch")
    train = importlib.import_module(f"{pkg}.train")
    kwargs = {} if pkg == "ray_tpu" else {"torch_config": tt.TorchConfig()}
    result = tt.TorchTrainer(
        ddp_loop, scaling_config=_scaling(pkg, n),
        run_config=train.RunConfig(storage_path=storage), **kwargs).fit()
    assert result.error is None, result.error
    return result.metrics


def _sklearn(pkg: str, storage: str):
    from sklearn.linear_model import LogisticRegression

    data = importlib.import_module(f"{pkg}.data")
    train = importlib.import_module(f"{pkg}.train")
    sk = importlib.import_module(f"{pkg}.train.sklearn")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3)).astype(np.float64)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    ds = data.from_numpy({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                          "label": y})
    result = sk.SklearnTrainer(
        estimator=LogisticRegression(), datasets={"train": ds},
        label_column="label", cv=3,
        run_config=train.RunConfig(storage_path=storage)).fit()
    est = sk.SklearnTrainer.get_estimator(result.checkpoint)
    return {"metrics": result.metrics,
            "predict": est.predict(np.array([[2.0, 1.0, 0.0]])).tolist()}


def hf_init_trainer(config):
    """The JAX package's test's local model (tests/test_train_frameworks.py)
    under ``transformers.Trainer`` on the CPU."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    from torch import nn
    from transformers import Trainer, TrainingArguments

    class TinyModel(nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.lin = nn.Linear(4, 2)

        def forward(self, x=None, labels=None):
            logits = self.lin(x)
            return {"loss": nn.functional.cross_entropy(logits, labels),
                    "logits": logits}

    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    args = TrainingArguments(
        output_dir=config["out"], num_train_epochs=2,
        per_device_train_batch_size=16, logging_steps=2, report_to=[],
        use_cpu=True, save_strategy="no", seed=0)
    return Trainer(model=TinyModel(), args=args,
                   train_dataset=[{"x": X[i], "labels": int(y[i])}
                                  for i in range(len(y))])


def _transformers(pkg: str, storage: str):
    hf = importlib.import_module(f"{pkg}.train.huggingface")
    train = importlib.import_module(f"{pkg}.train")
    result = hf.TransformersTrainer(
        hf_init_trainer,
        train_loop_config={"out": os.path.join(storage, "hf"),
                           "__ckpt_dir__": storage},
        scaling_config=_scaling(pkg, 1),
        run_config=train.RunConfig(
            storage_path=os.path.join(storage, "store"))).fit()
    assert result.error is None, result.error
    return {"final_loss": result.metrics["final_loss"],
            "logged": [m.get("loss") for m in result.metrics_history],
            "checkpoint": result.checkpoint is not None and os.path.exists(
                os.path.join(result.checkpoint.path, "model.safetensors"))}


@pytest.fixture(scope="module")
def outcomes() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    pytest.importorskip("sklearn")
    pytest.importorskip("transformers")
    out = {}
    for pkg in PACKAGES:
        rt = importlib.import_module(pkg)
        rt.init(num_cpus=4)
        try:
            with tempfile.TemporaryDirectory() as d:
                out[pkg] = {"sklearn": _sklearn(pkg, d),
                            "transformers": _transformers(pkg, d)}
                for n in WORLDS:
                    out[pkg][f"ddp{n}"] = _ddp(pkg, n, d)
        finally:
            rt.shutdown()
    return out


def test_sklearn_trainer_on_both_packages(outcomes):
    port = outcomes["ray_tpu_torch"]["sklearn"]
    assert port == outcomes["ray_tpu"]["sklearn"]
    assert port["metrics"]["n_samples"] == 200
    assert port["metrics"]["cv_mean"] > 0.8
    assert port["predict"] == [1]


def test_transformers_trainer_on_both_packages(outcomes):
    jax_out, port = (outcomes[pkg]["transformers"] for pkg in PACKAGES)
    assert port["checkpoint"] and jax_out["checkpoint"]
    np.testing.assert_allclose(port["final_loss"], jax_out["final_loss"],
                               rtol=1e-6)
    assert len(port["logged"]) == len(jax_out["logged"]) > 1


@pytest.mark.parametrize("n", WORLDS)
def test_ddp_loops_agree_rank_by_rank(outcomes, n):
    jax_out, port = (outcomes[pkg][f"ddp{n}"] for pkg in PACKAGES)
    assert port["world"] == jax_out["world"] == n
    for r in range(n):
        mine, ref = port["ranks"][r], jax_out["ranks"][r]
        assert mine["seen"] == ref["seen"]
        np.testing.assert_allclose(mine["losses"], ref["losses"],
                                   rtol=1e-6)
    for epoch in range(2):
        steps = 32 // 4 // n
        rows = [i for rank in port["ranks"]
                for b in rank["seen"][epoch * steps:(epoch + 1) * steps]
                for i in b]
        assert sorted(rows) == list(range(32))   # disjoint shards
    assert port["ranks"][0]["seen"][:2] != port["ranks"][0]["seen"][
        32 // 4 // n:32 // 4 // n + 2]           # epochs reshuffle


@pytest.fixture
def _restore_env():
    saved = {k: os.environ.get(k) for k in ("CUBLAS_WORKSPACE_CONFIG",
                                            "PYTHONHASHSEED")}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.parametrize("pkg", PACKAGES)
def test_train_torch_compat_surface(pkg, _restore_env):
    """train.torch's members on each package; the TorchConfig and
    get_device differences asserted per package."""
    import torch.distributed as dist
    from torch import nn

    tt = importlib.import_module(f"{pkg}.train.torch")
    if pkg == "ray_tpu":
        assert tt.get_device().type == "cpu"
        with pytest.raises(ValueError, match="gloo"):
            tt.TorchConfig(backend="nccl")
        assert tt.TorchConfig().backend == "gloo"
        scaling = {}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.get_device()
        assert tt.TorchConfig().backend is None
        assert tt.TorchConfig().backend_for("cuda") == "nccl"
        assert tt.TorchConfig().backend_for("cpu") == "gloo"
        with pytest.raises(ValueError, match="'nccl' does not fit the "
                           "trainer's device 'cpu'"):
            tt.TorchTrainer(lambda: None, scaling_config=_scaling(pkg, 1),
                            torch_config=type("C", (), {"backend": "nccl"})())
        with pytest.raises(ValueError, match="nccl.*or gloo"):
            tt.TorchConfig(backend="mpi")
        scaling = {"scaling_config": _scaling(pkg, 1)}
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            assert tt.get_devices() == [torch.device("cpu")]
            model = nn.Linear(4, 2, device="meta")
            with pytest.raises(ValueError, match="not on this rank's "
                               "device cpu"):
                tt.prepare_model(model)
            plain = nn.Linear(4, 2)
            assert tt.prepare_model(plain) is plain
        finally:
            dist.destroy_process_group()
    tr = tt.TorchTrainer(lambda: None,
                         torch_config=tt.TorchConfig(timeout_s=60), **scaling)
    assert tr._backend_setup_extra == {"timeout_s": 60}
    opt = object()
    assert tt.prepare_optimizer(opt) is opt
    x = torch.tensor(2.0, requires_grad=True)
    tt.backward(x * 3)
    assert x.grad == 3.0
    try:
        tt.enable_reproducibility(7)
        a = torch.rand(3)
        tt.enable_reproducibility(7)
        assert torch.equal(a, torch.rand(3))
        if pkg == "ray_tpu_torch":
            assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(False)
        torch.manual_seed(torch.seed())
    m = nn.Linear(4, 2)
    with tempfile.TemporaryDirectory() as d:
        ck = tt.TorchCheckpoint.from_model(m, directory=d)
        m2 = ck.get_model(nn.Linear(4, 2))
    assert torch.equal(m.weight, m2.weight)


# -- remote checkpoints (the port) -----------------------------------------


@pytest.fixture
def mock_s3(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_MOCK_S3_DIR", str(tmp_path / "s3"))
    return "mock-s3://bucket"


def test_pytree_round_trip_through_mock_s3(mock_s3):
    from ray_tpu_torch.train import restore_pytree, save_pytree
    tree = {"w": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
            "inner": {"ids": torch.arange(7), "bf": torch.ones(4).bfloat16()},
            "step": 3}
    uri = f"{mock_s3}/tree"
    assert save_pytree(tree, uri) == uri
    whole = restore_pytree(uri)
    into = restore_pytree(uri, {"w": torch.zeros(3, 5),
                                "inner": {"ids": torch.zeros(7, dtype=torch.long),
                                          "bf": torch.zeros(4).bfloat16()},
                                "step": 0})
    for got in (whole, into):
        assert torch.equal(got["w"], tree["w"])
        assert torch.equal(got["inner"]["ids"], tree["inner"]["ids"])
        assert torch.equal(got["inner"]["bf"], tree["inner"]["bf"])
        assert got["step"] == 3


def _gpt2_state(seed: int):
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.train import adamw, init_train_state
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                 seed=seed)
    return init_train_state(model, adamw(1e-3, weight_decay=0.1))


def _tensors(state) -> list:
    from ray_tpu_torch.train.checkpoint import state_tree
    tree = state_tree(state)
    return ([t for t in tree["params"].values()]
            + [t for v in tree["opt_state"].values()
               for t in (v.values() if isinstance(v, dict) else [v])])


def _steps(state, n: int):
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.train import adamw, make_train_step
    batch = {k: torch.from_numpy(v) for k, v in
             torch_runtime_programs.lm_batch(256, 64, seed=1).items()}
    step = make_train_step(gpt2_loss_fn(ce_chunk=64),
                           adamw(1e-3, weight_decay=0.1))
    return [step(state, batch)[1]["loss"].item() for _ in range(n)]


def test_train_state_round_trip_through_mock_s3(mock_s3):
    from ray_tpu_torch.train import restore_train_state, save_train_state
    state = _gpt2_state(0)
    _steps(state, 2)
    save_train_state(state, f"{mock_s3}/state")
    other = _gpt2_state(5)
    restore_train_state(f"{mock_s3}/state", other)
    assert other.step == state.step == 2
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state),
                                                 _tensors(other)))


def mock_s3_loop(config):
    """Two GPT-2 tiny steps on the CPU, the train state checkpointed."""
    from ray_tpu_torch import train
    torch.set_num_threads(1)
    state = _gpt2_state(0)
    losses = _steps(state, 2)
    with tempfile.TemporaryDirectory() as d:
        train.save_train_state(state, os.path.join(d, "state"))
        train.report({"losses": losses},
                     checkpoint=train.Checkpoint.from_directory(d))


def test_trainer_with_mock_s3_storage(mock_s3):
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (
        RunConfig,
        TorchTrainer,
        restore_train_state,
    )
    from ray_tpu_torch.util.storage import storage_for_uri
    rt.init(num_cpus=2)
    try:
        result = TorchTrainer(
            mock_s3_loop, scaling_config=_scaling("ray_tpu_torch", 1),
            run_config=RunConfig(name="remote", storage_path=mock_s3)).fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    assert result.path == f"{mock_s3}/remote"
    uri = result.remote_checkpoint_uri
    assert uri and uri.startswith(result.path)
    assert storage_for_uri(uri).list_keys(uri)
    here = _gpt2_state(0)
    assert _steps(here, 2) == result.metrics["losses"]
    restored = _gpt2_state(7)
    restore_train_state(f"{uri}/state", restored)
    assert restored.step == 2
    assert all(torch.equal(a, b) for a, b in zip(_tensors(here),
                                                 _tensors(restored)))
