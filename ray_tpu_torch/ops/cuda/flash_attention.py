"""Causal flash attention on hand-written CUDA kernels (fwd + bwd).

Counterpart of ``ray_tpu/ops/pallas/flash_attention.py``. Three kernels
in ``csrc/`` cover the seven Pallas calls the JAX package has on its
main path and beside it:

- ``flash_fwd`` (``csrc/flash_fwd.cu``): o and lse, by streaming softmax
  over 64-row key tiles. Replaces ``_fwd_single_kernel`` and
  ``_fwd_kernel``.
- ``flash_bwd_dq`` (``csrc/flash_bwd_dq.cu``) and ``flash_bwd_dkv``
  (``csrc/flash_bwd_dkv.cu``): the backward, split by output so that no
  block needs atomics. Together they replace ``_bwd_fused_kernel``,
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``.

The kernels work on the folded ``[B*H, T, D]`` layout, bf16 or fp16,
with D in {64, 128} and any T >= 1. ``lse`` and ``delta`` are float32
``[B*H, T]``. The causal mask is in absolute coordinates and filled with
-1e30; the softmax denominator is guarded at 1e-30; ``p`` is rounded to
the input type before ``p·v`` and ``ds`` before the dq/dk products, all
as in the reference.

Each kernel wrapper takes its kernel for CUDA tensors and raises if the
inputs do not suit it or the launch fails; it takes the plain PyTorch
version beside it (``flash_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``) only for CPU tensors. Each counts its
launches (:func:`launch_counts`). :func:`agreement` is the measure by
which a kernel is held against its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops.cuda import build

_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _Kernel:
    """One kernel of ``csrc/``: its C entry point and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(build.load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, _P(stream))
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError_t {rc}")
        self.launches += 1


_KERNELS = {
    "flash_fwd": _Kernel("flash_fwd", "rtt_flash_fwd",
                         [_P] * 5 + [_I] * 3 + [_F, _I, _I, _P]),
    "flash_bwd_dq": _Kernel("flash_bwd_dq", "rtt_flash_bwd_dq",
                            [_P] * 7 + [_I] * 3 + [_F, _I, _I, _P]),
    "flash_bwd_dkv": _Kernel("flash_bwd_dkv", "rtt_flash_bwd_dkv",
                             [_P] * 8 + [_I] * 3 + [_F, _I, _I, _P]),
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: k.launches for name, k in _KERNELS.items()}


def reset_launch_counts() -> None:
    for k in _KERNELS.values():
        k.launches = 0


def flash_attention_available() -> bool:
    """True when the kernels can run here: a CUDA card of compute
    capability 9.0 (the kernels are built for sm_90a only)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


def flash_attention_shapes_ok(t: int, d: int) -> bool:
    return t >= 1 and d in _HEAD_DIMS


# ---------------------------------------------------------------------------
# plain versions (the arithmetic of the kernels, in torch ops)
# ---------------------------------------------------------------------------

def _scores(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2:]
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_reference(q, k, v, scale: float, causal: bool = True):
    """Plain ``(o, lse)`` for ``[BH, T, D]`` inputs: one-pass softmax over
    the whole row, as ``_fwd_single_kernel`` computes it."""
    s = _scores(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _delta(o, do):
    return (o.float() * do.float()).sum(-1)


def _bwd_p_ds(q, k, v, do, lse, delta, scale, causal):
    """p, and ds rounded to the input type, in float32."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dov = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dov - delta[..., None]) * scale).to(q.dtype).float()
    return p, ds


def _dkv(q, do, p, ds):
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(q.dtype), dv.to(do.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale: float,
                           causal: bool = True):
    """Plain dq, on the inputs of the ``flash_bwd_dq`` kernel."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale: float,
                            causal: bool = True):
    """Plain ``(dk, dv)``, on the inputs of the ``flash_bwd_dkv`` kernel."""
    return _dkv(q, do, *_bwd_p_ds(q, k, v, do, lse, delta, scale, causal))


def flash_bwd_reference(q, k, v, o, lse, do, scale: float,
                        causal: bool = True):
    """Plain ``(dq, dk, dv)``, as ``_bwd_fused_kernel`` computes them,
    with ``delta = rowsum(o * do)`` taken in float32."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, _delta(o, do), scale, causal)
    return (torch.matmul(ds, k.float()).to(q.dtype), *_dkv(q, do, p, ds))


# How a kernel's output is held against its plain version (chip_smoke.py
# and the card tests). Per element: |got - want| <= atol + rtol * |want|,
# with rtol two units in the last place of the type (relative: a
# rounding flip across a power of two is one unit of the binade above,
# two of want's) and atol sixteen such units of the tensor's rms: p and
# ds are rounded to the type before their products in both versions, and
# one term that rounds the other way moves a sum by a unit of that term,
# which is many units of the sum where its terms cancel (most of all in
# ds = p * (dp - delta) at a near-uniform softmax). Overall:
# ||got - want|| / ||want|| <= rel_fro. An error divided by the global
# max would not do: at T = 1024 the first rows' values are tens of times
# the late rows', so it would let a late row's wrong sum through.
AGREEMENT_TOL = {
    torch.bfloat16: {"rtol": 2.0 ** -6, "atol_rms": 2.0 ** -3,
                     "rel_fro": 4e-3},
    torch.float16: {"rtol": 2.0 ** -9, "atol_rms": 2.0 ** -6,
                    "rel_fro": 5e-4},
}


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a kernel's output ``got`` is from its plain version's
    ``want`` (bf16 or fp16, same shape): ``rel_fro``, ``elem`` (the
    largest ``|got - want| / (atol + rtol * |want|)``, at most 1 within
    the limit), ``max_abs_err``, and ``ok`` when both are within
    :data:`AGREEMENT_TOL`."""
    tol = AGREEMENT_TOL[want.dtype]
    w = want.float()
    diff = (got.float() - w).abs()
    w_norm = float(torch.linalg.vector_norm(w))
    atol = tol["atol_rms"] * w_norm / w.numel() ** 0.5
    rel_fro = float(torch.linalg.vector_norm(diff)) / max(w_norm, 1e-30)
    elem = float((diff / (atol + tol["rtol"] * w.abs()).clamp_min(1e-30))
                 .max())
    return {"rel_fro": rel_fro, "elem": elem,
            "max_abs_err": float(diff.max()),
            "ok": rel_fro <= tol["rel_fro"] and elem <= 1.0}


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    """True for CPU tensors, False for CUDA tensors on one device; raises
    for anything else, so no tensor silently takes the wrong path."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError("flash attention takes tensors all on the CPU or all "
                     f"on one CUDA device, got {[str(t.device) for t in tensors]}")


def check_kernel_inputs(seq_tensors, row_tensors=()) -> None:
    """Raise ValueError unless the ``[BH, T, D]`` operands and the float32
    ``[BH, T]`` row statistics suit the kernels."""
    ref = seq_tensors[0]
    if ref.dim() != 3:
        raise ValueError(f"expected [BH, T, D] operands, got shape "
                         f"{tuple(ref.shape)}")
    bh, t, d = ref.shape
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernels take bf16 or fp16, got {ref.dtype}")
    if not flash_attention_shapes_ok(t, d):
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS} and "
                         f"seq >= 1, got T={t}, D={d}")
    if bh < 1 or bh * t >= 2 ** 31:
        raise ValueError(f"B*H={bh} with T={t} is out of the kernels' range")
    for x in seq_tensors:
        if x.shape != ref.shape or x.dtype != ref.dtype:
            raise ValueError("q, k, v (and do) must share shape and dtype: "
                             f"{tuple(x.shape)}/{x.dtype} vs "
                             f"{tuple(ref.shape)}/{ref.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash kernels take contiguous, 16-byte aligned "
                             "operands")
    for x in row_tensors:
        if (x.shape != (bh, t) or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"lse/delta must be contiguous float32 "
                             f"[{bh}, {t}], got {tuple(x.shape)}/{x.dtype}")


def flash_fwd(q, k, v, scale: float, causal: bool = True):
    """``(o, lse)`` for ``[BH, T, D]`` inputs: the ``flash_fwd`` kernel for
    CUDA tensors, :func:`flash_fwd_reference` for CPU tensors."""
    if _on_cpu(q, k, v):
        return flash_fwd_reference(q, k, v, scale, causal)
    check_kernel_inputs((q, k, v))
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), device=q.device, dtype=torch.float32)
    _KERNELS["flash_fwd"].launch(
        q.device, _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
        _P(o.data_ptr()), _P(lse.data_ptr()), bh, t, d, float(scale),
        int(causal), int(q.dtype == torch.float16))
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool = True):
    """dq: the ``flash_bwd_dq`` kernel for CUDA tensors, the plain
    backward for CPU tensors."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal)
    check_kernel_inputs((q, k, v, do), (lse, delta))
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    _KERNELS["flash_bwd_dq"].launch(
        q.device, _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
        _P(do.data_ptr()), _P(lse.data_ptr()), _P(delta.data_ptr()),
        _P(dq.data_ptr()), bh, t, d, float(scale), int(causal),
        int(q.dtype == torch.float16))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool = True):
    """(dk, dv): the ``flash_bwd_dkv`` kernel for CUDA tensors, the plain
    backward for CPU tensors."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale,
                                       causal)
    check_kernel_inputs((q, k, v, do), (lse, delta))
    bh, t, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _KERNELS["flash_bwd_dkv"].launch(
        q.device, _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
        _P(do.data_ptr()), _P(lse.data_ptr()), _P(delta.data_ptr()),
        _P(dk.data_ptr()), _P(dv.data_ptr()), bh, t, d, float(scale),
        int(causal), int(q.dtype == torch.float16))
    return dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``o = attention(q, k, v)`` on ``[BH, T, D]`` with the kernels as
    forward and backward (the counterpart of the ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = _delta(o, do)
        do = do.to(q.dtype).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Flash attention on ``[B, T, H, D]``; differentiable.

    CUDA tensors run the kernels and raise ValueError for shapes or
    dtypes the kernels do not take (check ``flash_attention_shapes_ok``);
    CPU tensors run the plain versions."""
    b, t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    out = FlashAttentionFn.apply(fold(q), fold(k), fold(v), float(scale),
                                 causal)
    return out.view(b, h, t, d).transpose(1, 2)
