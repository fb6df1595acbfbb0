"""The port's flash attention on the CPU against the JAX Pallas kernel.

On CPU tensors ``ray_tpu_torch`` runs the kernels' plain versions
(``flash_fwd_reference`` / ``flash_bwd_reference``) through the same
autograd Function the card uses. They are held here against
``ray_tpu.ops.pallas.flash_attention`` run in interpret mode, as
``tests/test_flash_attention.py`` runs it: at T=128 with the default
blocks (the single-block ``_fwd_single_kernel``/``_bwd_fused_kernel``
of the training path) and at T=256 with 64-blocks (the streaming
``_fwd_kernel``/``_bwd_dq_kernel``/``_bwd_dkv_kernel``). Inputs are
float32 from a numpy seed; tolerances are the JAX suite's: forward
2e-5, gradients 5e-4. The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda_kernels.py).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _flash_fwd,
    _pick_block,
    flash_attention as jax_flash_attention,
)
from ray_tpu_torch.ops.attention import causal_attention  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
# (T, block): T=128 resolves to one 128 block (single-block kernels);
# T=256 with 64-blocks runs the streaming kernels.
CASES = [(128, None), (256, 64)]


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


def _arrays(b, t, h, d, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(n)]


def _jax_flash(q, k, v, causal, block):
    return jax_flash_attention(q, k, v, causal=causal, block_q=block,
                               block_k=block, interpret=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", CASES)
def test_forward_and_lse_match_jax_pallas(t, block, causal):
    b, h, d = 2, 4, 64
    q, k, v, _ = _arrays(b, t, h, d)
    ref = np.asarray(_jax_flash(q, k, v, causal, block))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_TOL, rtol=0)

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, t, d)

    bq = block or _pick_block(t)
    _, lse_ref = _flash_fwd(*(jnp.asarray(fold(x)) for x in (q, k, v)),
                            d ** -0.5, causal, bq, bq, True)
    _, lse = fa.flash_fwd_reference(
        *(torch.from_numpy(fold(x)) for x in (q, k, v)), d ** -0.5, causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", CASES)
def test_gradients_match_jax_pallas(t, block, causal):
    q, k, v, g = _arrays(2, t, 3, 64, seed=1)

    def loss(q, k, v):
        return (_jax_flash(q, k, v, causal, block) * g).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("t", [1, 37, 100])
def test_ragged_seq_matches_dense_jax(t):
    """The kernels take any T; the Pallas kernel does not, so a ragged T
    is held against jax.nn.dot_product_attention."""
    q, k, v, g = _arrays(2, t, 3, 64, seed=2)

    def loss(q, k, v):
        return (jax.nn.dot_product_attention(q, k, v, is_causal=True)
                * g).sum()

    ref_out = jax.nn.dot_product_attention(q, k, v, is_causal=True)
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = causal_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=FWD_TOL, rtol=0)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=0)


def _naive_attention(q, k, v, causal):
    """[BH, T, D] attention in differentiable torch ops."""
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -1e30)
    return torch.softmax(s, -1) @ v


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_plain_autograd(causal):
    """The autograd Function (kernel wrappers + plain versions on CPU)
    gives the gradients autograd takes through plain attention."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(
        rng.standard_normal((5, 70, 64)).astype(np.float32)) for _ in range(4))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*ins, 64 ** -0.5, causal)
    grads = torch.autograd.grad(out, ins, g)
    ref_ins = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out = _naive_attention(*ref_ins, causal)
    ref_grads = torch.autograd.grad(ref_out, ref_ins, g)
    torch.testing.assert_close(out, ref_out, atol=FWD_TOL, rtol=0)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, atol=GRAD_TOL, rtol=0)


def test_plain_forward_is_bit_identical_beside_a_busy_thread():
    """The CPU path gives the same bits on every run. With two torch
    threads, the second OpenMP thread's first ``exp`` in a process came
    out about 1e-4 relative off now and then under load, and the port's
    forward then missed the JAX kernel by 7.9e-5 against FWD_TOL
    (ROADMAP §3). So the module runs torch on one thread, and the plain
    forward, run twice while a second thread keeps the host busy, is
    bit-identical."""
    assert torch.get_num_threads() == 1
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).reshape(8, 128, 64)
                                .copy()) for x in _arrays(2, 128, 4, 64, 3))
    stop = threading.Event()

    def busy():
        a = np.random.default_rng(0).standard_normal((256, 256))
        while not stop.is_set():
            np.exp(a @ a / 256)

    thread = threading.Thread(target=busy, daemon=True)
    thread.start()
    try:
        runs = [fa.flash_fwd_reference(q, k, v, 0.125, True)
                for _ in range(2)]
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive()
    (o1, lse1), (o2, lse2) = runs
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_cpu_path_launches_no_kernel():
    fa.reset_launch_counts()
    q, k, v, _ = (torch.from_numpy(x) for x in _arrays(1, 32, 2, 64))
    out = causal_attention(q.requires_grad_(), k, v)
    out.sum().backward()
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0, "flash_fwd_rect": 0,
                                  "flash_bwd_dq_rect": 0,
                                  "flash_bwd_dkv_rect": 0,
                                  "flash_fwd_nc_rect": 0,
                                  "flash_bwd_dq_nc_rect": 0,
                                  "flash_bwd_dkv_nc_rect": 0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or all"):
        fa.flash_fwd(q, q, q, 0.125)
    with pytest.raises(ValueError, match="CPU or all"):
        fa.flash_fwd(torch.zeros(2, 8, 64), q, q, 0.125)


def test_kernel_input_checks():
    """What the CUDA wrappers validate before a launch (checked on CPU
    tensors: the checks read shapes, types and strides only)."""
    ok = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    rows = torch.zeros(2, 8)
    fa.check_kernel_inputs((ok, ok, ok, ok), (rows, rows))
    bad = [
        ((ok.float(),), "bf16 or fp16"),
        ((torch.zeros(2, 8, 96, dtype=torch.bfloat16),), "head_dim"),
        ((ok, torch.zeros(2, 9, 64, dtype=torch.bfloat16)), "share shape"),
        ((ok, ok.half()), "share shape"),
        ((torch.zeros(2, 64, 8, dtype=torch.bfloat16).transpose(1, 2),),
         "contiguous"),
        ((torch.zeros(8, 64, dtype=torch.bfloat16),), r"\[BH, T, D\]"),
    ]
    for tensors, match in bad:
        with pytest.raises(ValueError, match=match):
            fa.check_kernel_inputs(tensors)
    with pytest.raises(ValueError, match="lse/delta"):
        fa.check_kernel_inputs((ok,), (rows.double(),))
    with pytest.raises(ValueError, match="lse/delta"):
        fa.check_kernel_inputs((ok,), (torch.zeros(2, 9),))


def test_shapes_ok():
    assert fa.flash_attention_shapes_ok(1024, 64)
    assert fa.flash_attention_shapes_ok(37, 128)
    assert not fa.flash_attention_shapes_ok(1024, 96)
    assert not fa.flash_attention_shapes_ok(0, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plain_backward_matches_whole(dtype):
    """The dq and dk/dv plain versions (what the CPU wrappers run) give
    exactly what the whole plain backward gives."""
    q, k, v, do = (torch.from_numpy(x.reshape(6, 96, 64)).to(dtype)
                   for x in _arrays(2, 96, 3, 64, seed=4))
    o, lse = fa.flash_fwd_reference(q, k, v, 0.125, True)
    delta = (o.float() * do.float()).sum(-1)
    whole = fa.flash_bwd_reference(q, k, v, o, lse, do, 0.125, True)
    bwd = (q, k, v, do, lse, delta, 0.125, True)
    split = (fa.flash_bwd_dq(*bwd), *fa.flash_bwd_dkv(*bwd))
    for got, want in zip(split, whole):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_agreement_passes_rounding_and_fails_a_dropped_tile(dtype):
    """The measure the card holds each kernel to: one unit in the last
    place on a tenth of the elements passes; attention that skips one
    64-key tile in the last 64 query rows of 512 fails."""
    bh, t, d = 4, 512, 64
    q, k, v = (torch.from_numpy(x.reshape(bh, t, d)).to(dtype)
               for x in _arrays(1, t, bh, d, n=3, seed=5))
    want, _ = fa.flash_fwd_reference(q, k, v, d ** -0.5, True)
    flip = torch.from_numpy(
        np.random.default_rng(6).random(want.shape) < 0.1).to(torch.int16)
    got = (want.view(torch.int16) + flip).view(dtype)
    reading = fa.agreement(got, want)
    assert reading["ok"] and reading["max_abs_err"] > 0, reading

    s = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    keep = torch.ones(t, t, dtype=torch.bool).tril()
    keep[t - 64:, 192:256] = False
    p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
    faulty = (p.to(dtype).float() @ v.float()).to(dtype)
    reading = fa.agreement(faulty, want)
    assert not reading["ok"], reading


# The non-causal rectangle: a hop of the bidirectional ring (ViT on sp),
# the rank's padded query block of tq rows against the tk <= tq valid
# rows of a source block. (50, 47) and (25, 22) are ViT-B/16's last
# blocks on sp 4 and 8, (3, 0) the tiny config's empty blocks on sp 8.
NC_RECT_CASES = [(50, 47), (50, 50), (25, 22), (17, 5), (3, 0)]


def _nc_rect_inputs(tq, tk, seed=3):
    """bf16 q, do [B, tq, H, D] and k, v [B, tk, H, D] (as float32 numpy
    arrays of bf16 values, so both packages read the same numbers)."""
    rng = np.random.default_rng(seed)
    b, h, d = 2, 3, 64
    shapes = [(b, tq, h, d), (b, tk, h, d), (b, tk, h, d), (b, tq, h, d)]
    return [np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                       .astype(jnp.float32)) for s in shapes]


def _fold_np(x, dtype):
    b, t, h, d = x.shape
    return (torch.from_numpy(x.copy()).to(dtype).transpose(1, 2)
            .reshape(b * h, t, d).contiguous())


def _unfold_np(x, b, h):
    bh, t, d = x.shape
    return x.float().view(b, h, t, d).transpose(1, 2).numpy()


@pytest.mark.parametrize("tq,tk", NC_RECT_CASES)
def test_nc_rect_plain_forward_matches_jax_in_bf16(tq, tk):
    """o in bf16 against ``jax.nn.dot_product_attention`` on the same bf16
    inputs within two bf16 units of the largest output (one rounding of
    o, and p rounded to bf16 before p·v on both sides, in other orders);
    lse against the float32 log-sum-exp of the same scores within
    FWD_TOL. With tk = 0 both give o = 0 (and the port lse = -inf, the
    log of an empty sum), and the port launches nothing."""
    q, k, v, _ = _nc_rect_inputs(tq, tk)
    b, _, h, d = q.shape
    ref = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        .astype(jnp.float32))
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd_nc_rect(*(_fold_np(x, torch.bfloat16)
                                    for x in (q, k, v)), d ** -0.5)
    assert sum(fa.launch_counts().values()) == 0
    got = _unfold_np(o, b, h)
    assert o.dtype == torch.bfloat16 and got.shape == ref.shape
    atol = 2.0 ** -6 * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    lse_ref = np.asarray(jax.nn.logsumexp(jnp.asarray(scores), axis=-1))
    np.testing.assert_allclose(lse.numpy(), lse_ref.reshape(b * h, tq),
                               atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("tq,tk", NC_RECT_CASES)
def test_nc_rect_plain_gradients_match_jax(tq, tk):
    """dq, dk, dv of the plain rectangle (what the CPU wrappers run), fed
    their own lse and delta = rowsum(o·do), against ``jax.grad`` of
    ``jax.nn.dot_product_attention`` on the same inputs in float32,
    within GRAD_TOL."""
    q, k, v, g = _nc_rect_inputs(tq, tk, seed=4)
    b, _, h, d = q.shape

    def loss(q, k, v):
        return (jax.nn.dot_product_attention(q, k, v) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qf, kf, vf, gf = (_fold_np(x, torch.float32) for x in (q, k, v, g))
    o, lse = fa.flash_fwd_nc_rect(qf, kf, vf, d ** -0.5)
    delta = (o * gf).sum(-1)
    dq = fa.flash_bwd_dq_nc_rect(qf, kf, vf, gf, lse, delta, d ** -0.5)
    dk, dv = fa.flash_bwd_dkv_nc_rect(qf, kf, vf, gf, lse, delta, d ** -0.5)
    for got, ref in zip((dq, dk, dv), want):
        got = _unfold_np(got, b, h)
        assert got.shape == np.asarray(ref).shape
        np.testing.assert_allclose(got, np.asarray(ref), atol=GRAD_TOL,
                                   rtol=0)


def test_nc_rect_input_checks():
    """The rectangle takes 1 <= tk <= tq (the causal band tk >= tq), rows
    read in place through the head stride of a padded block."""
    q = torch.zeros(4, 50, 64, dtype=torch.bfloat16)
    block = torch.zeros(4, 50, 64, dtype=torch.bfloat16)
    rows = torch.zeros(4, 50)
    nc = {"band": True, "causal": False}
    fa.check_inputs((q, q), (block[:, :47], block[:, :47]), (rows, rows),
                    **nc)
    fa.check_inputs((q,), (block, block), **nc)
    with pytest.raises(ValueError, match="1 <= tk <= tq"):
        fa.check_inputs((q[:, :40],), (block, block), **nc)
    with pytest.raises(ValueError, match="1 <= tk <= tq"):
        fa.check_inputs((q,), (block[:, :0], block[:, :0]), **nc)
    with pytest.raises(ValueError, match="tk >= tq"):
        fa.check_rect_inputs((q,), (block[:, :47], block[:, :47]))
