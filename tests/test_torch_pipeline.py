"""The port's ``spmd_pipeline`` against the JAX package's, on four gloo
ranks on the CPU.

One world of 4 ranks (``ray_tpu_torch.parallel.dryrun.spawn``) runs the
cases of ``torch_mesh_ranks.pipeline_cases``: ``tanh(x @ w)`` stages on
``pp 4`` (8 microbatches, the batch on every rank) and on ``dp 2 × pp 2``
(4 microbatches of each data shard), as ``tests/test_pipeline_moe.py``
runs the JAX pipeline. Each rank returns the pipeline's output and the
gradients of ``sum(y · w_out)`` with respect to its stage's weights and
its input. The outputs are held against the JAX ``spmd_pipeline`` under
``shard_map`` on the virtual CPU devices and against the stages applied
in sequence, within 1e-5; the gradients against ``jax.grad`` of the
sequential stages on the rank's data shard, within 1e-5 (the input's
gradient lands on the first stage's rank; the others never read it).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_mesh_ranks  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu.parallel.pipeline import spmd_pipeline  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402

TOL = 1e-5
D = 16
# name: (mesh axes, microbatches, batch, numpy seed)
CASES = {"pp4": ({"pp": 4}, 8, 32, 0), "dp2_pp2": ({"dp": 2, "pp": 2}, 4,
                                                   16, 1)}


def _inputs() -> dict:
    out = {}
    for name, (axes, _, b, seed) in CASES.items():
        rng = np.random.default_rng(seed)
        out[name] = ((rng.standard_normal((axes["pp"], D, D)) * 0.3)
                     .astype(np.float32),
                     rng.standard_normal((b, D)).astype(np.float32),
                     rng.standard_normal((b, D)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs):
    return spawn(torch_mesh_ranks.pipeline_cases, 4, (inputs,),
                 device="cpu", timeout=180)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        if isinstance(r, dict):
            assert "error" not in r, r.get("error")
    return results


def _sequential(ws, x):
    for w in ws:
        x = jnp.tanh(x @ w)
    return x


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmd_pipeline_matches_jax(world, inputs, name):
    axes, micro, _, _ = CASES[name]
    ws, x, w_out = inputs[name]
    dp = axes.get("dp", 1)
    mesh = make_mesh(axes)
    batch = P("dp") if dp > 1 else P()
    f = jax.jit(jax.shard_map(
        spmd_pipeline(lambda w, a: jnp.tanh(a @ w), micro, axis="pp"),
        mesh=mesh, in_specs=(P("pp"), batch), out_specs=batch,
        check_vma=False))
    y_jax = np.asarray(f(ws, x))
    y_seq = np.asarray(_sequential(ws, x))
    np.testing.assert_allclose(y_jax, y_seq, atol=TOL, rtol=TOL)

    def loss(ws, xs, wo):
        return jnp.sum(_sequential(ws, xs) * wo)

    grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
    shards = [grad(ws, xs, wo) for xs, wo in
              zip(np.split(x, dp), np.split(w_out, dp))]
    results = _case(world, name)
    assert sorted((r["dp"], r["pp"]) for r in results) == sorted(
        (i, j) for i in range(dp) for j in range(axes["pp"]))
    for r in results:
        i, j = r["dp"], r["pp"]
        rows = np.split(y_jax, dp)[i]
        np.testing.assert_allclose(r["y"], rows, atol=TOL, rtol=TOL)
        dws, dx = shards[i]
        np.testing.assert_allclose(r["dw"], np.asarray(dws)[j], atol=TOL,
                                   rtol=TOL)
        if j == 0:
            np.testing.assert_allclose(r["dx"], np.asarray(dx), atol=TOL,
                                       rtol=TOL)
        else:
            assert r["dx"] is None


def test_shard_stages_needs_a_stage_dimension_of_pp(world):
    for r in _case(world, "shapes_raise"):
        assert "leading dimension of pp=4" in r
