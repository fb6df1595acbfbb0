"""Card-only tests of the port's CUDA flash-attention kernels.

Each kernel is held against its plain PyTorch version on the same
inputs on the card, over ragged and tile-aligned sequence lengths, both
head dims, both element types, causal and not. Marked ``cuda``: run on
an H100 with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

They skip, from inside the test, where no GPU is visible.

The band routes of the causal split (``flash_fwd_rect``,
``flash_bwd_dq_rect``, ``flash_bwd_dkv_rect``) are held the same way at
ragged ``(tq, tk)`` that cut the 128-row tiles, read in place from bands
of a longer tensor, and through the split and remat paths of a small
GPT-2; so is the non-causal rectangle of the bidirectional ring
(``*_nc_rect``, tk <= tq, the valid rows of a padded block read in
place). Two launches on the same inputs give the same bits. T = 197 is
ViT-B/16's length; a small ViT trains through the non-causal route, and
a tiny float32 ResNet's train-mode forward (cuDNN, ``channels_last``,
TF32 off) is held against the same module on the CPU.

Tolerances: ``flash_attention.agreement`` with the limits of
``AGREEMENT_TOL`` for the input type. Per element, |kernel - plain| is
within two units in the last place of the element plus sixteen of the
tensor's rms; overall, ||kernel - plain|| / ||plain|| is within 4e-3
for bf16 and 5e-4 for fp16. The forward rounds p to the input type at a
running max where the plain version rounds it at the final max; the
backward kernels take the plain lse and delta, so only summation order
and the odd rounding flip differ. lse is float32 throughout: 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda

LSE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")
    return torch.device("cuda", 0)


def _assert_agrees(got, want):
    reading = fa.agreement(got, want)
    assert reading["ok"], reading


def _inputs(bh, t, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, t, d), np.float32))
            .to(device=device, dtype=dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
# T around the tiles of the kernels: 64 rows (dk/dv's key blocks, dq's key
# tiles at D = 128), 128 rows (the forward's and dq's query and key tiles)
# and their edges; 197 is ViT-B/16's (196 patches and the CLS token).
@pytest.mark.parametrize("t", [1, 37, 64, 127, 128, 129, 130, 197, 255, 256,
                               2048])
def test_kernels_match_plain(cuda, t, d, causal, dtype):
    q, k, v, do = _inputs(3, t, d, dtype, cuda)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal)
    torch.cuda.synchronize()
    _assert_agrees(o, o_ref)
    assert float((lse - lse_ref).abs().max()) < LSE_TOL

    delta = (o_ref.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse_ref, delta, scale, causal)
    dq = fa.flash_bwd_dq(*bwd)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    ref = (fa.flash_bwd_dq_reference(*bwd), *fa.flash_bwd_dkv_reference(*bwd))
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), ref):
        assert torch.isfinite(got).all()
    if t == 1:
        # One key: p = 1 and dp = delta, so dq and dk vanish on both
        # sides up to float32 rounding of delta; only dv (= do) is left.
        for got in (dq, dk):
            assert float(got.float().abs().max()) < 1e-5
        _assert_agrees(dv, ref[2])
        return
    for got, want in zip((dq, dk, dv), ref):
        _assert_agrees(got, want)


def test_autograd_function_and_launch_counts(cuda):
    b, t, h, d = 2, 200, 3, 64
    rng = np.random.default_rng(1)
    qkv = [torch.from_numpy(rng.standard_normal((b, t, h, d), np.float32))
           .to(cuda, torch.bfloat16).requires_grad_() for _ in range(3)]
    g = torch.from_numpy(rng.standard_normal((b, t, h, d), np.float32)).to(
        cuda, torch.bfloat16)

    fa.reset_launch_counts()
    out = fa.flash_attention(*qkv)
    grads = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1, "flash_fwd_rect": 0,
                                  "flash_bwd_dq_rect": 0,
                                  "flash_bwd_dkv_rect": 0,
                                  "flash_fwd_nc_rect": 0,
                                  "flash_bwd_dq_nc_rect": 0,
                                  "flash_bwd_dkv_nc_rect": 0}

    def fold(x):
        return x.detach().transpose(1, 2).reshape(b * h, t, d).contiguous()

    q, k, v, do = (fold(x) for x in (*qkv, g))
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, d ** -0.5, True)
    ref = fa.flash_bwd_reference(q, k, v, o_ref, lse_ref, do, d ** -0.5, True)
    _assert_agrees(fold(out), o_ref)
    for got, want in zip(grads, ref):
        _assert_agrees(fold(got), want)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(2, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        fa.flash_fwd(q.float(), k.float(), v.float(), 0.125)
    q96 = torch.zeros(2, 64, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q96, q96, q96, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2), k, v, 0.125)
    with pytest.raises(ValueError, match="CPU or all"):
        fa.flash_fwd(q, k.cpu(), v, 0.125)
    with pytest.raises(ValueError, match="scale > 0"):
        fa.flash_fwd(q, k, v, -0.125)


@pytest.mark.parametrize("band", [False, True])
def test_two_launches_give_the_same_bits(cuda, band):
    """No atomics and a fixed order of sums: the same inputs give the same
    o, lse, dq, dk and dv to the bit, square and band."""
    q, k, v, do = _inputs(6, 640, 64, torch.bfloat16, cuda, seed=7)
    if band:
        q, do = q[:, 384:], do[:, 384:]
        fwd, dq_fn, dkv_fn = fa.flash_fwd_rect, fa.flash_bwd_dq_rect, \
            fa.flash_bwd_dkv_rect
        extra = ()
    else:
        fwd, dq_fn, dkv_fn = fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv
        extra = (True,)
    runs = []
    for _ in range(2):
        o, lse = fwd(q, k, v, 0.125, *extra)
        delta = (o.float() * do.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, 0.125, *extra)
        runs.append((o, lse, dq_fn(*bwd), *dkv_fn(*bwd)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_prefetch_to_device_on_card(cuda):
    """Pinned host copies on the side stream, handed to the consumer's
    stream through an event: the values arrive intact."""
    from ray_tpu_torch.train import prefetch_to_device

    batches = [{"x": np.full((256, 1024), i, np.float32)} for i in range(6)]
    with prefetch_to_device(iter(batches), cuda, depth=2) as pf:
        sums = [float((b["x"] * 2).sum()) for b in pf]
    assert sums == [2.0 * i * 256 * 1024 for i in range(6)]
    assert pf.batches == 6


def test_gpt2_train_step_on_card_matches_cpu(cuda):
    """One train step of a small bf16 GPT-2 (head_dim 64) on the card,
    through the kernels, against the same step on the CPU through the
    plain versions: loss within 1e-2 relative, gradient norm within 5e-2
    (bf16 compute rounds differently on the two devices)."""
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    cfg = GPT2Config.tiny(n_embd=128, n_head=2, seq_len=128)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 128)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    metrics = {}
    for dev in ("cpu", cuda):
        model = GPT2(cfg, device="cpu", seed=0).to(dev)
        opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
        step = make_train_step(gpt2_loss_fn(ce_chunk=128), opt)
        fa.reset_launch_counts()
        _, m = step(init_train_state(model, opt),
                    {k: v.to(dev) for k, v in batch.items()})
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
        launched = fa.launch_counts()
    assert launched == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                        "flash_fwd_rect": 0, "flash_bwd_dq_rect": 0,
                        "flash_bwd_dkv_rect": 0,
                        "flash_fwd_nc_rect": 0, "flash_bwd_dq_nc_rect": 0,
                        "flash_bwd_dkv_nc_rect": 0}
    cpu, card = metrics["cpu"], metrics[str(cuda)]
    assert abs(card["loss"] - cpu["loss"]) < 1e-2 * cpu["loss"]
    assert abs(card["grad_norm"] - cpu["grad_norm"]) < 5e-2 * cpu["grad_norm"]


def test_gpt2_grads_through_kernels_match_plain_attention(cuda):
    """Every gradient of a small bf16 GPT-2 (head_dim 64) on the card
    through the kernels, against the same model on the card through the
    plain attention (autograd through ``flash_fwd_reference``): relative
    norm error within 2e-2. Both run the same bf16 model, so they differ
    only where the kernels round o, dq, dk and dv to bf16 differently."""
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn

    cfg = GPT2Config.tiny(n_embd=256, n_head=4, seq_len=256)
    model = GPT2(cfg, device=cuda, seed=0)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 256))).to(cuda)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}

    def plain(q, k, v):
        b, t, h, d = q.shape

        def fold(x):
            return x.transpose(1, 2).reshape(b * h, t, d)

        o, _ = fa.flash_fwd_reference(fold(q), fold(k), fold(v), d ** -0.5)
        return o.view(b, h, t, d).transpose(1, 2)

    params = list(model.parameters())
    grads = {}
    for name, attn in (("kernels", model.attn_fn), ("plain", plain)):
        model.attn_fn = attn
        fa.reset_launch_counts()
        grads[name] = torch.autograd.grad(
            gpt2_loss_fn(ce_chunk=256)(model, batch), params)
        launched = fa.launch_counts()
        assert launched["flash_bwd_dkv"] == (cfg.n_layer if name == "kernels"
                                             else 0)
    for (pname, _), gk, gp in zip(model.named_parameters(), grads["kernels"],
                                  grads["plain"]):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        assert rel < 2e-2, (pname, rel)


RECT_BANDS = [(1, 70), (37, 100), (64, 64), (100, 37 + 100), (130, 259),
              (128, 512), (200, 1000)]


def _band_inputs(bh, tq, tk, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def make(t):
        return torch.from_numpy(rng.standard_normal((bh, t, d), np.float32)
                                ).to(device=device, dtype=dtype)

    return make(tq), make(tk), make(tk), make(tq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", RECT_BANDS)
def test_rect_kernels_match_plain(cuda, tq, tk, d, dtype):
    q, k, v, do = _band_inputs(3, tq, tk, d, dtype, cuda)
    scale = d ** -0.5
    o, lse = fa.flash_fwd_rect(q, k, v, scale)
    o_ref, lse_ref = fa.flash_fwd_rect_reference(q, k, v, scale)
    torch.cuda.synchronize()
    _assert_agrees(o, o_ref)
    assert float((lse - lse_ref).abs().max()) < LSE_TOL

    delta = (o_ref.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse_ref, delta, scale)
    dq = fa.flash_bwd_dq_rect(*bwd)
    dk, dv = fa.flash_bwd_dkv_rect(*bwd)
    ref = fa.flash_bwd_rect_reference(q, k, v, o_ref, lse_ref, do, scale)
    torch.cuda.synchronize()
    assert dk.shape == (3, tk, d) and dv.shape == (3, tk, d)
    for got, want in zip((dq, dk, dv), ref):
        _assert_agrees(got, want)


def test_bands_are_read_in_place(cuda):
    """A band view of a longer tensor (head stride T * D) gives, bit for
    bit, what the kernels give on a contiguous copy of it, and the forward
    of a band whose diagonal sits on a tile boundary equals the square
    kernel's rows bit for bit."""
    bh, t, d = 6, 512, 64
    q, k, v, do = _inputs(bh, t, d, torch.bfloat16, cuda, seed=3)
    scale = d ** -0.5
    o_sq, lse_sq = fa.flash_fwd(q, k, v, scale, True)
    for off, s in ((256, 256), (128, 128), (384, 128)):
        qb, kb, vb, dob = (q[:, off:off + s], k[:, :off + s],
                           v[:, :off + s], do[:, off:off + s])
        assert not qb.is_contiguous()
        o, lse = fa.flash_fwd_rect(qb, kb, vb, scale)
        o_c, lse_c = fa.flash_fwd_rect(*(x.contiguous()
                                         for x in (qb, kb, vb)), scale)
        assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
        assert torch.equal(o, o_sq[:, off:off + s])
        assert torch.equal(lse, lse_sq[:, off:off + s])
        delta = (o.float() * dob.float()).sum(-1)
        got = (fa.flash_bwd_dq_rect(qb, kb, vb, dob, lse, delta, scale),
               *fa.flash_bwd_dkv_rect(qb, kb, vb, dob, lse, delta, scale))
        contiguous = [x.contiguous() for x in (qb, kb, vb, dob)]
        want = (fa.flash_bwd_dq_rect(*contiguous, lse, delta, scale),
                *fa.flash_bwd_dkv_rect(*contiguous, lse, delta, scale))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_rect_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _band_inputs(2, 64, 128, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="tk >= tq"):
        fa.flash_fwd_rect(k, q, q, 0.125)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_fwd_rect(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v, 0.125)
    flat = torch.zeros(2 * 64 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    misaligned = flat[4:].view(2, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_fwd_rect(misaligned, k, v, 0.125)
    with pytest.raises(ValueError, match="CPU or all"):
        fa.flash_fwd_rect(q, k.cpu(), v, 0.125)


def test_dq_band_refuses_a_view_tma_cannot_read(cuda):
    """A band view that passes the input check but that TMA cannot read
    (heads that overlap: a head stride shorter than one head) is refused
    with ValueError by the tensor-map geometry, before any launch."""
    _, k, v, do = _band_inputs(2, 64, 128, 64, torch.bfloat16, cuda)
    lse, delta = (torch.zeros(2, 64, device=cuda) for _ in range(2))
    overlap = torch.zeros(80 * 64, device=cuda, dtype=torch.bfloat16
                          ).as_strided((2, 64, 64), (16 * 64, 64, 1))
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="head stride"):
        fa.flash_bwd_dq_rect(overlap, k, v, do, lse, delta, 0.125)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_bwd_dq_rect"] == 0


# The non-causal rectangle (a hop of the bidirectional ring, ViT on sp):
# the padded query block of tq rows against the tk <= tq valid rows of a
# padded key/value block, read in place. (50, 47) and (25, 22) are
# ViT-B/16's last blocks on sp 4 and 8; the others cut the tiles.
NC_RECTS = [(50, 47), (50, 50), (25, 22), (129, 1), (197, 130), (256, 255),
            (300, 129)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", NC_RECTS)
def test_nc_rect_kernels_match_plain(cuda, tq, tk, d, dtype):
    q, block_k, block_v, do = _band_inputs(3, tq, tq, d, dtype, cuda, seed=5)
    k, v = block_k[:, :tk], block_v[:, :tk]
    scale = d ** -0.5
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd_nc_rect(q, k, v, scale)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, False)
    torch.cuda.synchronize()
    _assert_agrees(o, o_ref)
    assert float((lse - lse_ref).abs().max()) < LSE_TOL

    delta = (o_ref.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse_ref, delta, scale)
    dq = fa.flash_bwd_dq_nc_rect(*bwd)
    dk, dv = fa.flash_bwd_dkv_nc_rect(*bwd)
    ref = (fa.flash_bwd_dq_reference(*bwd, False),
           *fa.flash_bwd_dkv_reference(*bwd, False))
    torch.cuda.synchronize()
    assert dk.shape == (3, tk, d) and dv.shape == (3, tk, d)
    counts = fa.launch_counts()
    assert [counts[f"{n}_nc_rect"] for n in
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [1, 1, 1]
    assert sum(counts.values()) == 3
    if tk == 1:
        # One key, as test_kernels_match_plain's T = 1: dq and dk vanish.
        for got in (dq, dk):
            assert float(got.float().abs().max()) < 1e-5
        _assert_agrees(dv, ref[2])
        return
    for got, want in zip((dq, dk, dv), ref):
        _assert_agrees(got, want)


def test_nc_rect_reads_valid_rows_in_place_and_skips_empty_blocks(cuda):
    """The valid rows of a padded block give, bit for bit, what a
    contiguous copy of them gives; a block without a valid row launches
    nothing (o = 0, lse = -inf, dq = 0, dk and dv empty); tk > tq is
    refused before any launch."""
    q, kb, vb, do = _band_inputs(6, 50, 50, 64, torch.bfloat16, cuda, seed=6)
    scale = 0.125
    k, v = kb[:, :47], vb[:, :47]
    assert not k.is_contiguous()
    o, lse = fa.flash_fwd_nc_rect(q, k, v, scale)
    o_c, lse_c = fa.flash_fwd_nc_rect(q, k.contiguous(), v.contiguous(),
                                      scale)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    delta = (o.float() * do.float()).sum(-1)
    got = (fa.flash_bwd_dq_nc_rect(q, k, v, do, lse, delta, scale),
           *fa.flash_bwd_dkv_nc_rect(q, k, v, do, lse, delta, scale))
    want = (fa.flash_bwd_dq_nc_rect(q, k.contiguous(), v.contiguous(), do,
                                    lse, delta, scale),
            *fa.flash_bwd_dkv_nc_rect(q, k.contiguous(), v.contiguous(), do,
                                      lse, delta, scale))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fa.reset_launch_counts()
    o0, lse0 = fa.flash_fwd_nc_rect(q, kb[:, :0], vb[:, :0], scale)
    dq0 = fa.flash_bwd_dq_nc_rect(q, kb[:, :0], vb[:, :0], do, lse, delta,
                                  scale)
    dk0, dv0 = fa.flash_bwd_dkv_nc_rect(q, kb[:, :0], vb[:, :0], do, lse,
                                        delta, scale)
    torch.cuda.synchronize()
    assert sum(fa.launch_counts().values()) == 0
    assert not o0.any() and not dq0.any() and torch.isneginf(lse0).all()
    assert dk0.shape == (6, 0, 64) and dv0.shape == (6, 0, 64)
    with pytest.raises(ValueError, match="1 <= tk <= tq"):
        fa.flash_fwd_nc_rect(q[:, :40], kb, vb, scale)
    assert sum(fa.launch_counts().values()) == 0


@pytest.mark.parametrize("n_split", [2, 4])
def test_split_attention_on_card(cuda, n_split, monkeypatch):
    """The split through autograd: o equal to the unsplit kernels' bit
    for bit, gradients held against the plain whole backward, n launches
    of each band kernel and none of the square ones."""
    b, t, h, d = 2, 512, 3, 64
    rng = np.random.default_rng(n_split)
    qkv = [torch.from_numpy(rng.standard_normal((b, t, h, d), np.float32))
           .to(cuda, torch.bfloat16).requires_grad_() for _ in range(3)]
    g = torch.from_numpy(rng.standard_normal((b, t, h, d), np.float32)).to(
        cuda, torch.bfloat16)
    monkeypatch.delenv("RAY_TPU_FLASH_SPLIT", raising=False)
    whole = fa.flash_attention(*qkv)
    monkeypatch.setenv("RAY_TPU_FLASH_SPLIT", str(n_split))
    fa.reset_launch_counts()
    out = fa.flash_attention(*qkv)
    grads = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_fwd_rect": n_split, "flash_bwd_dq_rect": n_split,
        "flash_bwd_dkv_rect": n_split,
        "flash_fwd_nc_rect": 0, "flash_bwd_dq_nc_rect": 0,
        "flash_bwd_dkv_nc_rect": 0}
    assert torch.equal(out, whole)

    def fold(x):
        return x.detach().transpose(1, 2).reshape(b * h, t, d).contiguous()

    q, k, v, do = (fold(x) for x in (*qkv, g))
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, d ** -0.5, True)
    ref = fa.flash_bwd_reference(q, k, v, o_ref, lse_ref, do, d ** -0.5, True)
    for got, want in zip(grads, ref):
        _assert_agrees(fold(got), want)


@pytest.mark.parametrize("route", ["split2", "nothing", "dots",
                                   "dots_no_batch", "everything"])
def test_gpt2_split_and_remat_grads_match_plain(cuda, route, monkeypatch):
    """Every gradient of a small bf16 GPT-2 on the card through the
    kernels under the causal split or a remat policy, against the same
    model through the plain attention: relative norm error within 2e-2
    (as the unsplit test above). Launches per layer: the split runs 2
    bands of each band kernel; remat runs the forward twice, except under
    "everything", and each backward kernel once."""
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn

    split = route == "split2"
    if split:
        monkeypatch.setenv("RAY_TPU_FLASH_SPLIT", "2")
    else:
        monkeypatch.delenv("RAY_TPU_FLASH_SPLIT", raising=False)
    cfg = GPT2Config.tiny(n_embd=256, n_head=4, seq_len=256,
                          remat=not split,
                          remat_policy="nothing" if split else route)
    model = GPT2(cfg, device=cuda, seed=0)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 256))).to(cuda)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}

    def plain(q, k, v):
        b, t, h, d = q.shape

        def fold(x):
            return x.transpose(1, 2).reshape(b * h, t, d)

        o, _ = fa.flash_fwd_reference(fold(q), fold(k), fold(v), d ** -0.5)
        return o.view(b, h, t, d).transpose(1, 2)

    params = list(model.parameters())
    grads = {}
    for name, attn in (("kernels", model.attn_fn), ("plain", plain)):
        model.attn_fn = attn
        fa.reset_launch_counts()
        grads[name] = torch.autograd.grad(
            gpt2_loss_fn(ce_chunk=256)(model, batch), params)
        torch.cuda.synchronize()
        if name == "kernels":
            launched = fa.launch_counts()
    n = cfg.n_layer
    if split:
        want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_fwd_rect": 2 * n, "flash_bwd_dq_rect": 2 * n,
                "flash_bwd_dkv_rect": 2 * n,
                "flash_fwd_nc_rect": 0, "flash_bwd_dq_nc_rect": 0,
                "flash_bwd_dkv_nc_rect": 0}
    else:
        want = {"flash_fwd": n * (1 if route == "everything" else 2),
                "flash_bwd_dq": n, "flash_bwd_dkv": n, "flash_fwd_rect": 0,
                "flash_bwd_dq_rect": 0, "flash_bwd_dkv_rect": 0,
                "flash_fwd_nc_rect": 0, "flash_bwd_dq_nc_rect": 0,
                "flash_bwd_dkv_nc_rect": 0}
    assert launched == want
    for (pname, _), gk, gp in zip(model.named_parameters(), grads["kernels"],
                                  grads["plain"]):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        assert rel < 2e-2, (pname, rel)


@pytest.fixture
def no_tf32(cuda):
    """float32 products and convolutions in full float32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("size", [32, 33])
def test_resnet_train_forward_on_card_matches_cpu(no_tf32, size):
    """A tiny float32 ResNet's train-mode forward on the card (cuDNN,
    channels_last, TF32 off) against the same module on the CPU: logits
    within 1e-4 absolute and each new running statistic within 1e-5 of its
    layer's largest; only summation order differs. The buffers stay as
    they were: the forward is functional."""
    from ray_tpu_torch.models import ResNet, ResNet50Config

    model = ResNet(ResNet50Config.tiny(dtype=torch.float32), device="cpu",
                   seed=0)
    rng = np.random.default_rng(6)
    image = torch.from_numpy(
        rng.standard_normal((4, size, size, 3)).astype(np.float32))
    with torch.no_grad():
        want, want_stats = model(image, train=True)
        card = model.to(no_tf32)
        before = {k: v.clone() for k, v in card.batch_stats().items()}
        got, got_stats = card(image.to(no_tf32), train=True)
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) < 1e-4
    assert sorted(got_stats) == sorted(want_stats)
    for name, w in want_stats.items():
        err = float((got_stats[name].cpu() - w).abs().max() / w.abs().max())
        assert err < 1e-5, (name, err)
        assert torch.equal(card.batch_stats()[name], before[name])


def test_vit_train_step_on_card_matches_cpu(cuda):
    """One adamw step of a small bf16 ViT (head_dim 64, T = 17) on the
    card, through the kernels with causal=False, against the same step on
    the CPU through the plain versions: loss within 1e-2 relative,
    gradient norm within 5e-2, one launch of each square kernel per layer
    and none of the band routes."""
    from ray_tpu_torch.models import ViT, ViTConfig, vit_loss_fn
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    cfg = ViTConfig.tiny(n_embd=128, n_head=2)
    rng = np.random.default_rng(7)
    batch = {"images": torch.from_numpy(
                 rng.standard_normal((4, 32, 32, 3)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, 4))}
    metrics = {}
    for dev in ("cpu", cuda):
        model = ViT(cfg, device="cpu", seed=0).to(dev)
        opt = adamw(3e-3)
        step = make_train_step(vit_loss_fn(), opt)
        fa.reset_launch_counts()
        _, m = step(init_train_state(model, opt),
                    {k: v.to(dev) for k, v in batch.items()})
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
        launched = fa.launch_counts()
    assert launched == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                        "flash_fwd_rect": 0, "flash_bwd_dq_rect": 0,
                        "flash_bwd_dkv_rect": 0,
                        "flash_fwd_nc_rect": 0, "flash_bwd_dq_nc_rect": 0,
                        "flash_bwd_dkv_nc_rect": 0}
    cpu, card = metrics["cpu"], metrics[str(cuda)]
    assert abs(card["loss"] - cpu["loss"]) < 1e-2 * cpu["loss"]
    assert abs(card["grad_norm"] - cpu["grad_norm"]) < 5e-2 * cpu["grad_norm"]


def test_vit_refuses_a_head_dim_the_kernels_do_not_take(cuda):
    """ViTConfig.tiny() has head_dim 16: on the card its attention raises
    and nothing falls back to another attention."""
    from ray_tpu_torch.models import ViT, ViTConfig

    model = ViT(ViTConfig.tiny(), device=cuda, seed=0)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        model(torch.zeros(2, 32, 32, 3, device=cuda))
    assert sum(fa.launch_counts().values()) == 0
