"""The port's achievable-matmul probe against the JAX package's.

``ray_tpu_torch.util.mm_probe`` on the CPU: its inputs and its chain
against the reference's arithmetic, written here in ``jax.numpy`` (the
reference's chain is nested inside ``achievable_matmul_tflops``); its
two-point fit and validity rule against the JAX package's own function
under one scripted clock; no CPU fallback; and a chain whose carry does
not feed the product failing the chain check.
"""

from __future__ import annotations

import ast
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.util.mm_probe as jax_probe
import ray_tpu_torch.util.mm_probe as port_probe

ROOT = pathlib.Path(__file__).resolve().parent.parent
M, K = 128, 3
# The chain check: every element within one bf16 ulp of the top binade
# [0.5, 1) (2^-8; the carry is normalised to max |r| = 1), and at most 1%
# of the elements off at all. The products' f32 accumulation order is
# the two libraries' own; the inputs are bit-equal.
CHAIN_ATOL = 2.0 ** -8
CHAIN_OFF_SHARE = 0.01
# m=64, k_short=1, k_long=2: one 64^3 product between the two chains.
FIT = dict(m=64, k_short=1, k_long=2)
FIT_FLOPS = 2 * 64 ** 3
SHORT_S = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_inputs(m: int):
    """``a`` and ``r0`` as ``ray_tpu/util/mm_probe.py:37-41`` draws them."""
    rng = np.random.default_rng(0)
    a = jnp.eye(m, dtype=jnp.bfloat16) + 0.01 * jnp.asarray(
        rng.standard_normal((m, m)).astype(np.float32), jnp.bfloat16)
    r0 = jnp.asarray(
        rng.standard_normal((m, m)).astype(np.float32), jnp.bfloat16)
    return r0, a


def reference_chain(r, a, k: int):
    """The chain of ``ray_tpu/util/mm_probe.py``: its scan body
    (``:45-48``) verbatim, scanned ``k`` times (``:49``)."""
    def body(r, _):
        r2 = r @ a
        return (r2 / jnp.maximum(
            jnp.abs(r2).max(), 1e-6)).astype(jnp.bfloat16), None
    r, _ = jax.lax.scan(body, r, None, length=k)
    return np.asarray(r.astype(jnp.float32))


def chain_agrees(port: torch.Tensor, ref: np.ndarray) -> tuple[bool, str]:
    """The chain check (CHAIN_ATOL, CHAIN_OFF_SHARE) and its reading."""
    diff = np.abs(port.float().numpy() - ref)
    off = float((diff > 0).mean())
    return (float(diff.max()) <= CHAIN_ATOL and off <= CHAIN_OFF_SHARE,
            f"max |diff| {diff.max()}, {off:.4%} of elements off")


def unfed_chain(r, a, k: int) -> torch.Tensor:
    """A wrong probe's chain: each link multiplies the first carry, so
    the product does not depend on the link before it."""
    out = r
    for _ in range(k):
        r2 = torch.matmul(r, a)
        out = (r2 / torch.clamp(r2.abs().amax(), min=1e-6)).to(torch.bfloat16)
    return out


def test_inputs_are_bit_equal_to_the_reference():
    r0, a = port_probe.chain_inputs(M, "cpu")
    ref_r0, ref_a = reference_inputs(M)
    assert r0.dtype == a.dtype == torch.bfloat16
    assert np.array_equal(r0.float().numpy(), np.asarray(ref_r0, np.float32))
    assert np.array_equal(a.float().numpy(), np.asarray(ref_a, np.float32))


def test_chain_matches_the_reference_arithmetic():
    r0, a = port_probe.chain_inputs(M, "cpu")
    out = port_probe.matmul_chain(r0, a, K)
    ok, reading = chain_agrees(out, reference_chain(*reference_inputs(M), K))
    assert out.dtype == torch.bfloat16 and out.shape == (M, M)
    assert float(out.float().abs().max()) == 1.0
    assert ok, reading


@pytest.mark.parametrize("chain", [port_probe.matmul_chain, unfed_chain],
                         ids=["carry_feeds_product", "carry_unfed"])
def test_chain_check_fails_a_chain_whose_carry_does_not_feed(chain):
    """The check passes the port's chain and fails the unfed one."""
    r0, a = port_probe.chain_inputs(M, "cpu")
    ok, reading = chain_agrees(chain(r0, a, K),
                               reference_chain(*reference_inputs(M), K))
    assert ok == (chain is port_probe.matmul_chain), reading


def _scripted(long_s: float, short_s: float):
    """A ``time`` module whose ``perf_counter`` gives each chain's reps
    the elapsed times ``long_s`` (the long chain, timed first) and
    ``short_s``: reads 0, elapsed, 0, elapsed for each of the two reps."""
    reads = iter([0.0, long_s] * 2 + [0.0, short_s] * 2)
    return types.SimpleNamespace(perf_counter=lambda: next(reads))


def _both(monkeypatch, long_s: float, short_s: float) -> tuple:
    """(the JAX package's rate, the port's) under the same script."""
    monkeypatch.setattr(jax_probe, "time", _scripted(long_s, short_s))
    jax_rate = jax_probe.achievable_matmul_tflops(**FIT)
    monkeypatch.setattr(port_probe, "time", _scripted(long_s, short_s))
    port_rate = port_probe.achievable_matmul_tflops(**FIT, device="cpu")
    return jax_rate, port_rate


@pytest.mark.parametrize("tflops", [60.0, 120.0, 190.0])
def test_rate_inside_both_windows_is_the_same(monkeypatch, tflops):
    """49.47 < rate <= 197: both give the scripted rate, exactly the same
    float (one expression on one difference), within 1e-9 of it."""
    diff = FIT_FLOPS / (tflops * 1e12)
    jax_rate, port_rate = _both(monkeypatch, SHORT_S + diff, SHORT_S)
    assert port_rate == jax_rate
    assert abs(port_rate - tflops) / tflops < 1e-9


def test_rate_above_v5e_peak_is_valid_on_the_card(monkeypatch):
    """300 TFLOP/s: over v5e's 197 peak (JAX 0.0), inside the H100's."""
    diff = FIT_FLOPS / 300e12
    jax_rate, port_rate = _both(monkeypatch, SHORT_S + diff, SHORT_S)
    assert jax_rate == 0.0
    assert abs(port_rate - 300.0) / 300.0 < 1e-9


def test_rate_under_a_twentieth_of_the_h100_peak_is_invalid(monkeypatch):
    """20 TFLOP/s: inside v5e's window (> 9.85), under 989.4 / 20."""
    diff = FIT_FLOPS / 20e12
    jax_rate, port_rate = _both(monkeypatch, SHORT_S + diff, SHORT_S)
    assert abs(jax_rate - 20.0) / 20.0 < 1e-9
    assert port_rate == 0.0


def test_rate_above_the_h100_peak_is_invalid(monkeypatch):
    """1000 TFLOP/s: over both peaks, so both 0.0."""
    diff = FIT_FLOPS / 1000e12
    assert _both(monkeypatch, SHORT_S + diff, SHORT_S) == (0.0, 0.0)


@pytest.mark.parametrize("long_s", [SHORT_S, SHORT_S / 2],
                         ids=["equal", "long_faster"])
def test_non_positive_difference_is_invalid_on_both(monkeypatch, long_s):
    assert _both(monkeypatch, long_s, SHORT_S) == (0.0, 0.0)


def test_each_time_is_the_best_of_two_reps(monkeypatch):
    """A stall in one rep of the short chain does not shrink the
    difference: its best rep is taken."""
    diff = FIT_FLOPS / 100e12
    reads = iter([0.0, SHORT_S + diff] * 2 + [0.0, 5 * SHORT_S, 0.0, SHORT_S])
    monkeypatch.setattr(port_probe, "time",
                        types.SimpleNamespace(perf_counter=lambda: next(reads)))
    rate = port_probe.achievable_matmul_tflops(**FIT, device="cpu")
    assert abs(rate - 100.0) / 100.0 < 1e-9


def test_peak_is_the_h100_sxm_dense_bf16_rate():
    assert port_probe.PEAK_BF16_TFLOPS == 989.4


def test_no_cpu_fallback():
    """Without a card, ``device=None`` raises; ``"cpu"`` is the opt-in."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_probe.achievable_matmul_tflops(**FIT)


def test_module_imports_torch_numpy_and_the_standard_library_only():
    tree = ast.parse((ROOT / "ray_tpu_torch/util/mm_probe.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add((node.module or "").split(".")[0])
    allowed = {"torch", "numpy", "ray_tpu_torch", "__future__"}
    assert mods - allowed <= set(sys.stdlib_module_names), mods
    calls = {node.attr for node in ast.walk(tree)
             if isinstance(node, ast.Attribute)}
    assert "compile" not in calls   # the product stays eager torch.matmul
