"""Card-only tests of the port's CUDA flash-attention kernels.

Each kernel is held against its plain PyTorch version on the same
inputs on the card, over ragged and tile-aligned sequence lengths, both
head dims, both element types, causal and not. Marked ``cuda``: run on
an H100 with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

They skip, from inside the test, where no GPU is visible.

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
@pytest.mark.parametrize("t", [1, 37, 64, 130, 256])
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
                                  "flash_bwd_dkv": 1}

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
    assert launched == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
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
