"""The port's device-plane collectives (``ray_tpu_torch.collective.device``)
against ``ray_tpu.collective.ici`` under ``shard_map``, on four gloo
ranks on the CPU.

One world of 4 ranks (``ray_tpu_torch.parallel.dryrun.spawn``) runs every
case of ``torch_mesh_ranks.collective_cases``: the wrappers on a ``dp =
4`` mesh, the compositions and the group API on a ``dp 2 × tp 2`` mesh,
as ``tests/test_collective.py`` runs them on the virtual CPU devices,
and the gradient of each differentiable wrapper, held against the
transposed collective written out in numpy. The JAX results are
computed here, on 4 of the 8 virtual devices, from the same inputs.
Values are exact (small integers in float32) but for the bf16 wire
(rtol 1e-2, as the JAX test) and the norm (rtol 1e-5).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_mesh_ranks  # noqa: E402
from ray_tpu.collective import ici  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402

N = 4


def _weights() -> dict:
    rng = np.random.default_rng(0)
    w = {"x": rng.standard_normal((N, 8)).astype(np.float32)}
    for name in ("allreduce", "mean", "allgather", "reducescatter",
                 "all_to_all", "ring_shift"):
        w[name] = rng.standard_normal((N, 32)).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def world(weights):
    return spawn(torch_mesh_ranks.collective_cases, N, (weights,),
                 device="cpu", timeout=180)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        assert "error" not in r, r.get("error")
    return results


def _shard_map(fn, mesh, spec, n_out):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                 out_specs=(spec,) * n_out,
                                 check_vma=False))


def test_wrappers_match_ici(world):
    mesh = make_mesh({"dp": N})

    def f(x):
        r = ici.axis_index("dp")
        return (ici.allreduce(x, "dp"), ici.allreduce(x, "dp", "mean"),
                ici.allreduce(x, "dp", "max"), r.reshape(1),
                ici.allgather(x, "dp").reshape(-1),
                ici.allgather(x, "dp", tiled=True),
                ici.ring_shift(x, "dp", 1),
                ici.ppermute(x, "dp", [(0, 2), (2, 0), (1, 3)]),
                ici.broadcast(x, "dp", root=3),
                ici.barrier("dp").reshape(1))

    outs = [np.asarray(o).reshape(N, -1) for o in
            _shard_map(f, mesh, P("dp"), 10)(jnp.arange(4.0))]
    total, mean, mx, idx, gathered, tiled, shifted, perm, bcast, token = outs
    for r, got in enumerate(_case(world, "wrappers")):
        np.testing.assert_array_equal(got["total"], total[r])
        np.testing.assert_array_equal(got["mean"], mean[r])
        np.testing.assert_array_equal(got["max"], mx[r])
        assert got["idx"] == idx[r][0] == r and got["size"] == N
        np.testing.assert_array_equal(got["gathered"].reshape(-1),
                                      gathered[r])
        np.testing.assert_array_equal(got["tiled"], tiled[r])
        np.testing.assert_array_equal(got["shifted"], shifted[r])
        np.testing.assert_array_equal(got["perm"], perm[r])
        np.testing.assert_array_equal(got["bcast"], bcast[r])
        assert int(got["barrier"]) == int(token[r][0]) == N
        np.testing.assert_array_equal(got["fenced"]["x"], [float(r)])


def test_reducescatter_and_all_to_all_match_ici(world):
    mesh = make_mesh({"dp": N})

    def f(x):
        x = x.reshape(-1)
        r = ici.axis_index("dp")
        scaled = jnp.arange(8.0) * (r + 1)
        return (ici.reducescatter(scaled, "dp"),
                ici.all_to_all(jnp.arange(8.0) + 10 * r, "dp"))

    rs, a2a = (np.asarray(o).reshape(N, -1) for o in
               _shard_map(f, mesh, P("dp"), 2)(jnp.zeros(N)))
    for r, got in enumerate(_case(world, "wrappers")):
        np.testing.assert_array_equal(got["rs"], rs[r])
        np.testing.assert_array_equal(got["a2a"], a2a[r])


def test_compositions_match_ici_on_a_2x2_mesh(world):
    mesh = make_mesh({"dp": 2, "tp": 2})

    def f(x):
        return (ici.allreduce(x, ("tp", "dp")),
                ici.hierarchical_allreduce(x, "tp", "dp"),
                ici.allreduce_lowprec(x, ("tp", "dp")),
                ici.broadcast(ici.axis_index("tp").astype(jnp.float32),
                              "tp", root=1).reshape(1),
                ici.global_norm({"g": x}, ("tp", "dp")).reshape(1),
                ici.tree_allreduce({"a": x, "b": [2 * x]}, "tp")["a"])

    spec = P(("dp", "tp"))
    outs = [np.asarray(o).reshape(N, -1) for o in
            _shard_map(f, mesh, spec, 6)(jnp.arange(16.0))]
    direct, hier, lowp, bcast, gnorm, tree_a = outs
    for r, got in enumerate(_case(world, "compositions")):
        np.testing.assert_array_equal(got["direct"], direct[r])
        np.testing.assert_array_equal(got["hier"], hier[r])
        np.testing.assert_allclose(got["lowp"], lowp[r], rtol=1e-2)
        np.testing.assert_allclose(got["lowp"], direct[r], rtol=1e-2)
        np.testing.assert_array_equal(float(got["bcast"]), bcast[r][0])
        assert float(got["bcast"]) == 1.0
        np.testing.assert_allclose(float(got["gnorm"]), gnorm[r][0],
                                   rtol=1e-5)
        np.testing.assert_array_equal(got["tree"]["a"], tree_a[r])
        np.testing.assert_array_equal(got["tree"]["b"][0], 2 * tree_a[r])
        np.testing.assert_allclose(got["tree_lowp"][0], direct[r] / N,
                                   rtol=1e-2)


def test_group_api_matches_ici(world):
    mesh = make_mesh({"dp": 2, "tp": 2})
    gtp = ici.DeviceCollectiveGroup(mesh, "tp")
    g2 = ici.DeviceCollectiveGroup(mesh, ("tp", "dp"))

    def f(x):
        return (gtp.allreduce(x), g2.hierarchical_allreduce(x),
                gtp.broadcast(x, root=1))

    tp_sum, hier, bcast = (np.asarray(o).reshape(N, -1) for o in
                           _shard_map(f, mesh, P(("dp", "tp")), 3)(
                               jnp.arange(16.0)))
    for r, got in enumerate(_case(world, "group_api")):
        assert "nope" in got["bad"] and "single-axis" in got["single"]
        assert got["size2"] == 4 and got["size_tp"] == 2
        np.testing.assert_array_equal(got["tp_sum"], tp_sum[r])
        np.testing.assert_array_equal(got["hier"], hier[r])
        np.testing.assert_array_equal(got["hier"], got["direct"])
        np.testing.assert_array_equal(got["bcast"], bcast[r])
        assert int(got["barrier"]) == 4


def _want_grads(w: dict) -> dict:
    """d/dx_r of sum over ranks j of w_j · op(x)_j, the transposed
    collective of each op in numpy."""
    x = w["x"]
    n, m = x.shape
    want = {}
    s = w["allreduce"][:, :m].sum(0)
    want["allreduce"] = np.stack([s] * n)
    want["mean"] = np.stack([w["mean"][:, :m].sum(0) / n] * n)
    g = w["allgather"][:, :n * m].sum(0).reshape(n, m)
    want["allgather"] = g
    want["reducescatter"] = np.stack(
        [np.concatenate([w["reducescatter"][j, :m // n] for j in range(n)])
         for _ in range(n)])
    # all_to_all: block j of rank r lands as block r of rank j.
    b = m // n
    a2a = w["all_to_all"][:, :m].reshape(n, n, b)
    want["all_to_all"] = np.stack(
        [np.concatenate([a2a[j, r] for j in range(n)]) for r in range(n)])
    want["ring_shift"] = np.roll(w["ring_shift"][:, :m], -1, axis=0)
    return want


def test_gradients_are_the_transposed_collectives(world, weights):
    want = _want_grads(weights)
    for r, got in enumerate(_case(world, "gradients")):
        for name, g in want.items():
            np.testing.assert_allclose(got[name], g[r], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
