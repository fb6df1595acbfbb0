"""The port's causal split (``RAY_TPU_FLASH_SPLIT``) on the CPU against
the JAX Pallas band kernels.

On CPU tensors the band wrappers run the plain versions
(``flash_fwd_rect_reference``, ``flash_bwd_rect_reference``). They are
held here against ``_rect_fwd`` and ``_rect_core_bwd`` of
``ray_tpu.ops.pallas.flash_attention`` in interpret mode, at band shapes
``(tq, tk)`` with the diagonal bottom-right aligned, fed the same numpy
inputs (and, for the backward, the same o and lse). The whole split is
held against the JAX ``flash_attention`` under the same environment
variable, and ``resolved_flash_config`` against the JAX one.

Tolerances. float32: forward and lse 2e-5, gradients 5e-4 absolute, the
JAX suite's own. bfloat16: each output within two units in the last
place of its largest entry (2 * 2^-8 * max|ref|): both sides round p and
ds to bf16 before their products and the outputs to bf16 at the end, so
they differ by a rounding flip where float32 sums differ in order; lse
(float32 on both sides) within 2e-5. The CUDA band kernels are held
against these plain versions on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _rect_core_bwd,
    _rect_fwd,
    flash_attention as jax_flash_attention,
    resolved_flash_config as jax_resolved_flash_config,
)
from ray_tpu_torch.ops import resolved_flash_config  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
BANDS = [(128, 128), (128, 256), (256, 512)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SCALE = 64 ** -0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module. Tier-1 runs six test processes on
    one host, so more threads would only starve timing-sensitive runtime
    tests in the others; and a second OpenMP thread's first ``exp`` in a
    process has come out at reduced precision on an AMX CPU with
    torch 2.13 (ROADMAP §3), so the plain versions run on the main thread
    only."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tiling_env(monkeypatch):
    for name in ("RAY_TPU_FLASH_SPLIT", "RAY_TPU_FLASH_BQ",
                 "RAY_TPU_FLASH_BK"):
        monkeypatch.delenv(name, raising=False)


def _band(tq, tk, seed, bh=4, d=64):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((bh, tq, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((bh, tk, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, g


def _assert_close(got: torch.Tensor, want, kind: str, f32_tol: float):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = f32_tol if kind == "f32" else 2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("tq,tk", BANDS)
def test_band_forward_matches_pallas_rect_fwd(tq, tk, kind):
    jdt, tdt = DTYPES[kind]
    arrs = _band(tq, tk, seed=tq + tk)[:3]
    o_ref, lse_ref = _rect_fwd(*(jnp.asarray(x, jdt) for x in arrs),
                               SCALE, True, True)
    o, lse = fa.flash_fwd_rect(*(torch.from_numpy(x).to(tdt) for x in arrs),
                               SCALE)
    assert o.dtype == tdt and lse.dtype == torch.float32
    _assert_close(o, o_ref, kind, FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("tq,tk", BANDS)
def test_band_backward_matches_pallas_rect_core_bwd(tq, tk, kind):
    """Both sides take JAX's own o and lse; the port's dq comes from
    ``flash_bwd_dq_rect`` and dk, dv from ``flash_bwd_dkv_rect``, each
    equal to the whole plain band backward."""
    jdt, tdt = DTYPES[kind]
    q, k, v, g = (jnp.asarray(x, jdt) for x in _band(tq, tk, seed=tq * tk))
    o, lse = _rect_fwd(q, k, v, SCALE, True, True)
    ref = _rect_core_bwd(SCALE, True, True, (q, k, v, o, lse), g)

    def to_torch(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
            tdt)

    tq_, tk_, tv_, tg, to = (to_torch(x) for x in (q, k, v, g, o))
    tlse = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    delta = (to.float() * tg.float()).sum(-1)
    bwd = (tq_, tk_, tv_, tg, tlse, delta, SCALE)
    got = (fa.flash_bwd_dq_rect(*bwd), *fa.flash_bwd_dkv_rect(*bwd))
    whole = fa.flash_bwd_rect_reference(tq_, tk_, tv_, to, tlse, tg, SCALE)
    for g_, w_, r_ in zip(got, whole, ref):
        assert torch.equal(g_, w_)
        _assert_close(g_, r_, kind, GRAD_TOL)
    assert got[1].shape == (4, tk, 64)


def test_band_autograd_function_matches_plain_autograd():
    """FlashRectFn's forward and backward give what autograd takes
    through plain bottom-right-aligned causal attention."""
    q, k, v, g = (torch.from_numpy(x) for x in _band(96, 160, seed=7))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.FlashRectFn.apply(*ins, SCALE)
    grads = torch.autograd.grad(out, ins, g)
    ref_ins = [x.clone().requires_grad_() for x in (q, k, v)]
    s = ref_ins[0] @ ref_ins[1].transpose(-1, -2) * SCALE
    keep = torch.ones(96, 160, dtype=torch.bool).tril(160 - 96)
    ref_out = torch.softmax(s.masked_fill(~keep, -1e30), -1) @ ref_ins[2]
    ref_grads = torch.autograd.grad(ref_out, ref_ins, g)
    torch.testing.assert_close(out, ref_out, atol=FWD_TOL, rtol=0)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("n_split", [2, 4])
@pytest.mark.parametrize("t", [256, 512])
def test_split_matches_jax_flash_attention(t, n_split, monkeypatch):
    """Output and gradients of the whole attention under
    RAY_TPU_FLASH_SPLIT, in float32. At t=256 split 4 gives 64-row bands,
    which neither package splits (t / n must be a multiple of 128)."""
    monkeypatch.setenv("RAY_TPU_FLASH_SPLIT", str(n_split))
    rng = np.random.default_rng(t + n_split)
    q, k, v, g = (rng.standard_normal((1, t, 2, 64)).astype(np.float32)
                  for _ in range(4))

    def loss(q, k, v):
        return (jax_flash_attention(q, k, v, interpret=True) * g).sum()

    ref_out = jax_flash_attention(q, k, v, interpret=True)
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    bands = []
    split = fa._flash_causal_split

    def spy(*args):
        bands.append(args[-1])
        return split(*args)

    monkeypatch.setattr(fa, "_flash_causal_split", spy)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*ins)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))
    expected = jax_resolved_flash_config(t)["split"]
    assert bands == ([expected] if expected else [])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=FWD_TOL, rtol=0)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("split", [None, "1", "2", "3", "4", "8"])
def test_resolved_flash_config_matches_jax(split, monkeypatch):
    if split is not None:
        monkeypatch.setenv("RAY_TPU_FLASH_SPLIT", split)
    for t in (64, 256, 512, 1000, 1024, 2048):
        for causal in (True, False):
            ours = resolved_flash_config(t, causal)
            assert ours == {"split": jax_resolved_flash_config(
                t, causal)["split"]}, (t, causal, split)


def test_split_launches_no_kernel_on_cpu(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FLASH_SPLIT", "2")
    fa.reset_launch_counts()
    q = torch.zeros(1, 256, 2, 64, requires_grad=True)
    fa.flash_attention(q, q, q).sum().backward()
    assert set(fa.launch_counts().values()) == {0}


def test_band_input_checks():
    """What the band wrappers validate before a launch (checked on CPU
    tensors: the checks read shapes, types, strides and addresses)."""
    base = torch.zeros(2, 256, 64, dtype=torch.bfloat16)
    rows = torch.zeros(2, 128)
    q, kv = base[:, 128:], base[:, :256]        # a band read in place
    assert q.stride(0) == 256 * 64 and not q.is_contiguous()
    fa.check_rect_inputs((q, q), (kv, kv), (rows, rows))
    misaligned = base.view(-1)[4:4 + 2 * 128 * 64].view(2, 128, 64)
    bad = [
        (((base.float()[:, :128],), (base.float(),)), "bf16 or fp16"),
        (((base[:, :128],), (base[:, :64],)), "tk >= tq"),
        (((base[:, :128],), (base, base.half())), "share BH"),
        (((base[:, :128].unsqueeze(0),), (base,)), r"\[BH, T, D\]"),
        (((base[:, :, :32][:, :128],), (base[:, :, :32],)), "head_dim"),
        (((torch.zeros(2, 64, 128, dtype=torch.bfloat16).transpose(1, 2),),
          (base,)), "contiguous, 16-byte aligned rows"),
        (((misaligned,), (base,)), "contiguous, 16-byte aligned rows"),
    ]
    for (q_side, kv_side), match in bad:
        with pytest.raises(ValueError, match=match):
            fa.check_rect_inputs(q_side, kv_side)
    with pytest.raises(ValueError, match="lse/delta"):
        fa.check_rect_inputs((q,), (kv,), (torch.zeros(2, 256),))
