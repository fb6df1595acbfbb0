"""The port's sequence-parallel attention against the JAX package's, on
four gloo ranks on the CPU.

One world of 4 ranks (``ray_tpu_torch.parallel.dryrun.spawn``, one torch
thread a rank) runs every case of ``torch_mesh_ranks.ring_cases``: ring
attention on ``sp = 4`` and on ``dp 2 × sp 2``, Ulysses on both, and the
errors of ``make_sharded_causal_attention`` (Ulysses on a rank's tp-local
heads that do not split over ``sp`` among them). Each rank returns its block
of the output and the gradients of ``sum(out²)`` with respect to its
blocks of q, k and v; the test process assembles them and holds them
against ``ray_tpu.ops.attention``'s ring and Ulysses under ``shard_map``
on the virtual CPU devices, the gradients through ``jax.grad``. On CPU
tensors the ring's hops run the flash kernels' plain versions in
float32. Tolerances are ``tests/test_parallel.py``'s: forward 2e-5,
gradients 5e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks  # noqa: E402
from ray_tpu.ops.attention import make_sharded_causal_attention  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
# name: (B, T, H, D), numpy seed
SHAPES = {"sp4": ((2, 64, 4, 16), 1), "dp2_sp2": ((4, 32, 4, 8), 2),
          "sp4_h8": ((2, 64, 8, 16), 7)}
CASES = {"ring_sp4": ("sp4", {"sp": 4}, "ring"),
         "ring_dp2_sp2": ("dp2_sp2", {"dp": 2, "sp": 2}, "auto"),
         "ulysses_sp4": ("sp4_h8", {"sp": 4}, "ulysses"),
         "ulysses_dp2_sp2": ("dp2_sp2", {"dp": 2, "sp": 2}, "ulysses")}


def _inputs() -> dict:
    out = {}
    for key, (shape, seed) in SHAPES.items():
        rng = np.random.default_rng(seed)
        out[key] = tuple(rng.standard_normal(shape).astype(np.float32)
                         for _ in range(3))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs):
    return spawn(torch_mesh_ranks.ring_cases, 4, (inputs,), device="cpu",
                 timeout=240)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        assert "error" not in r, r.get("error")
    return results


def _assemble(results, key, axes):
    dp, sp = axes.get("dp", 1), axes.get("sp", 1)
    rows = []
    for i in range(dp):
        blocks = sorted((r for r in results if r["dp"] == i),
                        key=lambda r: r["sp"])
        assert len(blocks) == sp
        rows.append(np.concatenate([r[key] for r in blocks], axis=1))
    return np.concatenate(rows, axis=0)


def _jax_reference(q, k, v, axes, impl):
    mesh = make_mesh(axes)
    fn = jax.jit(make_sharded_causal_attention(mesh, impl=impl))

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) ** 2)

    out = fn(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_attention_matches_jax(world, inputs, name):
    key, axes, impl = CASES[name]
    q, k, v = inputs[key]
    results = _case(world, name)
    out, grads = _jax_reference(q, k, v, axes, impl)
    np.testing.assert_allclose(_assemble(results, "out", axes), out,
                               atol=FWD_TOL, rtol=FWD_TOL)
    for g, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_assemble(results, g, axes), want,
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=g)


@pytest.mark.parametrize("what", ["dense_on_sp", "ulysses_no_sp",
                                  "ring_no_sp", "unknown"])
def test_value_errors_match_jax(world, what):
    """The same ValueError, with the same message, as the JAX function."""
    mesh = {"dense_on_sp": {"sp": 4}}.get(what, {"dp": 4})
    impl = {"dense_on_sp": "dense", "ulysses_no_sp": "ulysses",
            "ring_no_sp": "ring", "unknown": "flash"}[what]
    with pytest.raises(ValueError) as want:
        make_sharded_causal_attention(make_mesh(mesh), impl=impl)
    for r in _case(world, "errors"):
        assert r[what] == str(want.value)


def test_ulysses_needs_this_ranks_heads_to_split_over_sp(world):
    """On sp 2 x tp 2 a rank holds H/tp heads: 3 of them do not split
    over sp = 2, a ValueError."""
    for r in _case(world, "errors"):
        assert "3 heads of this rank do not split over sp=2" in \
            r["ulysses_tp_heads"]
