"""The port's checkpoints (``ray_tpu_torch.train.checkpoint``): a train
state saved on one mesh restores on another.

One world of 4 gloo ranks (``ray_tpu_torch.parallel.dryrun.spawn``) runs
``torch_mesh_ranks.checkpoint_cases``: GPT-2 tiny (float32 compute, the
JAX model's own initialisation) takes one AdamW step on ``dp 2 × tp 2``,
its ``TrainState`` (parameters, each rank writing its ``tp`` blocks; the
AdamW moments and count; the step) is saved, and it takes two more
steps. The checkpoint then restores, into models of other weights, on
``dp 4`` (whole replicated tensors), on ``fsdp 4`` (FSDP2's shards) and
on ``tp 4`` (other ``tp`` blocks), and each takes the same two steps:
their losses must match the uninterrupted run's within 2e-5 (the second
reads the restored moments and count), and the step count must be
restored. A restore with no target gives whole tensors of the model's
shapes. In this process, outside any process group: a tree of whole
tensors and a step round-trips bit for bit, and so does a ``scheme://``
directory with a storage backend (``mock-s3://``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks  # noqa: E402
from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu_torch.models import GPT2, GPT2Config  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402
from ray_tpu_torch.train.checkpoint import (  # noqa: E402
    restore_pytree,
    save_pytree,
)

LOSS_RTOL = 2e-5
RESTORED = ("restored_dp4", "restored_fsdp4", "restored_tp4")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32)).init_params(
        jax.random.key(1))
    batches = []
    for i in range(3):
        toks = np.random.default_rng(30 + i).integers(0, 256, (8, 64))
        batches.append({"tokens": toks, "targets": np.roll(toks, -1, 1)})
    inputs = {"params": jax.tree_util.tree_map(np.asarray, params),
              "batches": batches}
    directory = str(tmp_path_factory.mktemp("ckpt") / "state")
    return spawn(torch_mesh_ranks.checkpoint_cases, 4, (inputs, directory),
                 device="cpu", timeout=240)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        assert "error" not in r, r.get("error")
    return results


@pytest.mark.parametrize("name", RESTORED)
def test_checkpoint_from_dp2_tp2_restores_on_another_mesh(world, name):
    want = _case(world, "saved_dp2_tp2")
    assert len({tuple(r["losses"]) for r in want}) == 1
    for r in _case(world, name):
        assert r["step_at_restore"] == want[0]["step_at_restore"] == 1
        np.testing.assert_allclose(r["losses"], want[0]["losses"],
                                   rtol=LOSS_RTOL)


def test_restore_without_a_target_gives_whole_tensors(world):
    model = GPT2(GPT2Config.tiny(), device="cpu")
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for r in _case(world, "whole"):
        assert r == want


def test_whole_tree_round_trips_outside_a_process_group(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"step": 7, "params": {"w": torch.randn(3, 5, generator=gen)},
            "opt_state": {"count": torch.tensor(7.0),
                          "mu": {"w": torch.randn(3, 5, generator=gen)
                                 .to(torch.bfloat16)}}}
    save_pytree(tree, str(tmp_path / "ckpt"))
    got = restore_pytree(str(tmp_path / "ckpt"))
    assert got["step"] == 7
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["opt_state"]["mu"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["opt_state"]["mu"]["w"], tree["opt_state"]["mu"]["w"])
    target = {"step": 0, "params": {"w": torch.zeros(3, 5)},
              "opt_state": {"count": torch.tensor(0.0),
                            "mu": {"w": torch.zeros(3, 5,
                                                    dtype=torch.bfloat16)}}}
    assert restore_pytree(str(tmp_path / "ckpt"), target) is target
    assert target["step"] == 7 and float(target["opt_state"]["count"]) == 7
    assert torch.equal(target["params"]["w"], tree["params"]["w"])


def test_remote_directory_raises_until_storage_is_ported(tmp_path,
                                                         monkeypatch):
    """util.storage is ported: a ``scheme://`` directory goes through its
    backend (``mock-s3://`` here; tests/test_torch_train_frameworks.py has
    the train-state round trips), and a scheme with no backend raises,
    naming ``register_storage``."""
    monkeypatch.setenv("RAY_TPU_MOCK_S3_DIR", str(tmp_path / "s3"))
    tree = {"w": torch.arange(6.0).reshape(2, 3), "step": 4}
    save_pytree(tree, "mock-s3://bucket/ckpt")
    back = restore_pytree("mock-s3://bucket/ckpt")
    assert torch.equal(back["w"], tree["w"]) and back["step"] == 4
    with pytest.raises(ValueError, match="register_storage"):
        save_pytree({"w": torch.zeros(2)}, "gs://bucket/ckpt")
    with pytest.raises(ValueError, match="register_storage"):
        restore_pytree("s3://bucket/ckpt")
