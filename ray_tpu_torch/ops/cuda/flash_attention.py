"""Flash attention on hand-written CUDA kernels (fwd + bwd), causal for
the language models and not (``causal=False``) for ViT.

Counterpart of ``ray_tpu/ops/pallas/flash_attention.py``. Three kernels
in ``csrc/`` cover the seven Pallas calls of the JAX package:

- ``flash_fwd`` (``csrc/flash_fwd.cu``): o and lse, by streaming softmax
  over 128-row key tiles, on TMA loads and ``wgmma``. Replaces
  ``_fwd_single_kernel``, ``_fwd_kernel`` and, on a band,
  ``_fwd_rect_kernel``.
- ``flash_bwd_dq`` (``csrc/flash_bwd_dq.cu``) and ``flash_bwd_dkv``
  (``csrc/flash_bwd_dkv.cu``), both on TMA and ``wgmma``: the backward,
  split by output so that no block needs atomics. Together they replace
  ``_bwd_fused_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and, on
  a band, ``_bwd_rect_kernel``.

The kernels work on the folded ``[B*H, T, D]`` layout, bf16 or fp16,
with D in {64, 128} and any T >= 1. ``lse`` and ``delta`` are float32
``[B*H, T]``. The causal mask is in absolute coordinates and filled with
-1e30; the softmax denominator is guarded at 1e-30; ``p`` is rounded to
the input type before ``p·v`` and ``ds`` before the dq/dk products, all
as in the reference.

A band of the causal split (``RAY_TPU_FLASH_SPLIT``, see
:func:`flash_attention`) is ``q [BH, tq, D]`` against the key/value
prefix ``k, v [BH, tk, D]``, ``tk >= tq``, with the causal diagonal
bottom-right aligned: query row ``i`` sits at absolute row ``tk - tq +
i``. The square attention is the case ``tq = tk``. The non-causal
rectangle (``flash_fwd_nc_rect`` and its backward) is ``q [BH, tq, D]``
against ``k, v [BH, tk, D]`` with ``tk <= tq`` and no mask but the
ragged end of k: a hop of the bidirectional ring
(``ops.attention._bidir_ring_attention``), whose source block holds
``tk`` valid keys of a padded block of ``tq`` rows. Each kernel has one
custom op, one input check (:func:`check_inputs`) and one autograd
Function (:class:`FlashAttentionFn`) for every route; the band and
rectangle routes read q, k, v and do in place through their head
strides, so a band of a longer tensor, or the valid rows of a padded
block, are not copied. The kernels take each operand as a TMA tensor map
whose geometry :func:`tensor_map_geometry` computes.

Each kernel wrapper takes its kernel for CUDA tensors and raises if the
inputs do not suit it or the launch fails; it takes the plain PyTorch
version beside it (``flash_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``, which also serve the bands) only for CPU
tensors. Each wrapper runs as an operator of the ``ray_tpu_torch``
``torch.library`` namespace, so that selective activation checkpointing
(models' ``remat_policy``) sees one op it can save or recompute, never
the launch inside it. The operators are defined on a ``Library`` rather
than with ``torch.library.custom_op``: custom_op wraps each kernel in
``torch._disable_dynamo``, whose first call imports ``torch._dynamo`` and
with it sympy, seconds of every worker's start. Each kernel
counts its launches per route (:func:`launch_counts`: ``flash_fwd``,
``flash_fwd_rect``, ``flash_fwd_nc_rect`` and so on). A launch captured
into a CUDA graph runs only when the graph replays, so it is counted
then: the capture records it (:func:`record_launches`) and each replay
adds what its graph holds (:func:`count_replay`). :func:`agreement` is
the measure by which a kernel is held against its plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import os

import torch
from torch import Tensor

from ray_tpu_torch.ops.cuda import build

_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MAPS = ctypes.POINTER(ctypes.c_uint64)


class _Kernel:
    """One kernel of ``csrc/``: its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
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
        if device.index == torch.cuda.current_device():
            rc = self._launch_on_current_stream(args)
        else:
            with torch.cuda.device(device):
                rc = self._launch_on_current_stream(args)
        if rc < 0:
            raise RuntimeError(f"{self.symbol}: cuTensorMapEncodeTiled failed: "
                               f"CUresult {-rc}")
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError_t {rc}")

    def _launch_on_current_stream(self, args) -> int:
        """Launch on the current stream and count the launch: now, or, when
        the stream is capturing a CUDA graph, in the innermost
        :func:`record_launches` (raising outside one, before the launch)."""
        tally = None
        if torch.cuda.is_current_stream_capturing():
            if not _CAPTURES:
                raise RuntimeError(
                    f"{self.name} launched into a CUDA graph outside "
                    "record_launches(): its replays would not be counted")
            tally = _CAPTURES[-1]
        rc = self._fn(*args, _P(torch.cuda.current_stream().cuda_stream))
        if rc == 0:
            if tally is None:
                self.launches += 1
            else:
                tally[self.name] = tally.get(self.name, 0) + 1
        return rc


# Each route of a kernel (square; causal band: ``*_rect``; non-causal
# rectangle: ``*_nc_rect``) counts its launches apart, so that a run shows
# which route ran. Each kernel has one C entry
# point for both routes (tensor maps, the output and row pointers, bh, tq,
# tk, row0, d, scale, causal, fp16, stream).
_FWD_ARGS = [_MAPS, _P, _P] + [_I] * 5 + [_F, _I, _I, _P]
_DQ_ARGS = [_MAPS] + [_P] * 3 + [_I] * 5 + [_F, _I, _I, _P]
_DKV_ARGS = [_MAPS] + [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P]
_KERNELS = {k.name: k for k in (
    _Kernel("flash_fwd", "flash_fwd", "rtt_flash_fwd", _FWD_ARGS),
    _Kernel("flash_bwd_dq", "flash_bwd_dq", "rtt_flash_bwd_dq", _DQ_ARGS),
    _Kernel("flash_bwd_dkv", "flash_bwd_dkv", "rtt_flash_bwd_dkv", _DKV_ARGS),
    _Kernel("flash_fwd_rect", "flash_fwd", "rtt_flash_fwd", _FWD_ARGS),
    _Kernel("flash_bwd_dq_rect", "flash_bwd_dq", "rtt_flash_bwd_dq",
            _DQ_ARGS),
    _Kernel("flash_bwd_dkv_rect", "flash_bwd_dkv", "rtt_flash_bwd_dkv",
            _DKV_ARGS),
    _Kernel("flash_fwd_nc_rect", "flash_fwd", "rtt_flash_fwd", _FWD_ARGS),
    _Kernel("flash_bwd_dq_nc_rect", "flash_bwd_dq", "rtt_flash_bwd_dq",
            _DQ_ARGS),
    _Kernel("flash_bwd_dkv_nc_rect", "flash_bwd_dkv", "rtt_flash_bwd_dkv",
            _DKV_ARGS),
)}
# The launches each CUDA graph under capture holds, innermost capture last
# (see record_launches).
_CAPTURES: list[dict[str, int]] = []

# Rows of one tensor-map box: the tiles of csrc/flash_fwd.cu (kFwdBQ,
# kFwdBK), csrc/flash_bwd_dq.cu (kDqBQ, DqSmem::kBK) and
# csrc/flash_bwd_dkv.cu (DkvSmem::kBQ, kDkvBK), which refuse a geometry
# whose box differs. The box is 64 columns wide, one 128-byte swizzle row;
# D = 128 is two boxes.
_FWD_BOX_ROWS = (128, 128)                       # (q, k and v)
_DQ_BOX_ROWS = {64: (128, 128), 128: (128, 64)}  # D: (q and do, k and v)
_DKV_BOX_ROWS = {64: (64, 64), 128: (32, 64)}    # D: (q and do, k and v)
_BOX_COLS = 64


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: k.launches for name, k in _KERNELS.items()}


def reset_launch_counts() -> None:
    for k in _KERNELS.values():
        k.launches = 0


@contextlib.contextmanager
def record_launches():
    """Around the capture of a CUDA graph: yields ``{kernel: launches}``,
    the launches the graph holds, which the capture records in place of
    counting them (a captured launch does not run). Pass it to
    :func:`count_replay` at each replay."""
    tally: dict[str, int] = {}
    _CAPTURES.append(tally)
    try:
        yield tally
    finally:
        _CAPTURES.pop()          # captures nest: this one is innermost


def count_replay(tally: dict[str, int], times: int = 1) -> None:
    """Count the launches of ``times`` replays of a graph whose capture
    recorded ``tally``."""
    for name, n in tally.items():
        _KERNELS[name].launches += n * times


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
    """Scaled q·kᵀ in float32, the causal mask bottom-right aligned (query
    row i at absolute row tk - tq + i): the square mask when tq == tk."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2:]
        keep = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=s.device).tril(t_k - t_q)
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_reference(q, k, v, scale: float, causal: bool = True):
    """Plain ``(o, lse)`` for q ``[BH, tq, D]`` and k, v ``[BH, tk, D]``:
    one-pass softmax over the whole row, as ``_fwd_single_kernel`` (tq =
    tk) and ``_fwd_rect_kernel`` (a band, tq <= tk) compute it."""
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
    """Plain ``(dq, dk, dv)``, as ``_bwd_fused_kernel`` (and, on a band,
    ``_bwd_rect_kernel``) computes them, with ``delta = rowsum(o * do)``
    taken in float32."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, _delta(o, do), scale, causal)
    return (torch.matmul(ds, k.float()).to(q.dtype), *_dkv(q, do, p, ds))


def flash_fwd_rect_reference(q, k, v, scale: float):
    """Plain ``(o, lse)`` of one causal band: q ``[BH, tq, D]`` against
    k, v ``[BH, tk, D]``, tk >= tq, the diagonal at ``row0 = tk - tq``
    (``_fwd_rect_kernel``)."""
    return flash_fwd_reference(q, k, v, scale, True)


def flash_bwd_rect_reference(q, k, v, o, lse, do, scale: float):
    """Plain ``(dq, dk, dv)`` of one causal band (``_bwd_rect_kernel``),
    with ``delta = rowsum(o * do)`` in float32 (``_rect_core_bwd``)."""
    return flash_bwd_reference(q, k, v, o, lse, do, scale, True)


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


def _rows_ok(x: torch.Tensor) -> bool:
    """Rows contiguous (row stride D) and 16-byte aligned, any head
    stride: what the band route reads in place."""
    return (x.stride(2) == 1 and x.stride(1) == x.shape[2]
            and x.stride(0) % 8 == 0 and x.stride(0) < 2 ** 31
            and x.data_ptr() % 16 == 0)


def check_inputs(q_side, kv_side=(), row_tensors=(), band: bool = False,
                 causal: bool = True) -> None:
    """Raise ValueError unless the operands suit the kernels: ``q`` (and
    ``do``) ``[BH, tq, D]`` and ``k``, ``v`` ``[BH, tk, D]`` of one dtype
    (bf16 or fp16), D in (64, 128), and contiguous float32 ``[BH, tq]``
    row statistics. The square route (``band`` False) takes every operand
    of one shape, contiguous and 16-byte aligned (``kv_side`` may be
    empty). A rectangle (``band`` True) takes rows contiguous and 16-byte
    aligned with any head stride, so that a band of a longer tensor, or
    the valid rows of a padded block, are read in place: the causal band
    takes tk >= tq, the non-causal rectangle (``causal`` False, a hop of
    the bidirectional ring) 1 <= tk <= tq."""
    ref = q_side[0]
    if ref.dim() != 3 or (band and any(x.dim() != 3 for x in kv_side)):
        raise ValueError(f"expected [BH, T, D] operands, got shape "
                         f"{tuple(ref.shape)}")
    bh, tq, d = ref.shape
    tk = kv_side[0].shape[1] if band else tq
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernels take bf16 or fp16, got {ref.dtype}")
    if not flash_attention_shapes_ok(tq, d):
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS} and "
                         f"seq >= 1, got T={tq}, D={d}")
    if causal and tk < tq:
        raise ValueError(f"a band needs tk >= tq, got tq={tq}, tk={tk}")
    if not causal and not 1 <= tk <= tq:
        raise ValueError(f"a non-causal rectangle needs 1 <= tk <= tq, got "
                         f"tq={tq}, tk={tk}")
    if bh < 1 or bh * tk >= 2 ** 31:
        raise ValueError(f"B*H={bh} with T={tk} is out of the kernels' range")
    for x, rows in [(x, tq) for x in q_side] + [(x, tk) for x in kv_side]:
        if x.shape != (bh, rows, d) or x.dtype != ref.dtype:
            what = ("q, do [BH, tq, D] and k, v [BH, tk, D] must share BH, D"
                    if band else "q, k, v (and do) must share shape")
            raise ValueError(f"{what} and dtype: {tuple(x.shape)}/{x.dtype} "
                             f"vs {tuple(ref.shape)}/{ref.dtype}")
        if not (_rows_ok(x) if band
                else x.is_contiguous() and x.data_ptr() % 16 == 0):
            raise ValueError("flash kernels take operands with contiguous, "
                             "16-byte aligned rows")
    for x in row_tensors:
        if (x.shape != (bh, tq) or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"lse/delta must be contiguous float32 "
                             f"[{bh}, {tq}], got {tuple(x.shape)}/{x.dtype}")


def check_kernel_inputs(seq_tensors, row_tensors=()) -> None:
    """:func:`check_inputs` on the square route: every ``[BH, T, D]``
    operand of one shape."""
    check_inputs(tuple(seq_tensors), (), row_tensors, band=False)


def check_rect_inputs(q_side, kv_side, row_tensors=()) -> None:
    """:func:`check_inputs` on the band route."""
    check_inputs(q_side, kv_side, row_tensors, band=True)


def tensor_map_geometry(x: torch.Tensor, box_rows: int) -> tuple[int, ...]:
    """The 3-D TMA tensor map through which the Hopper kernels read the
    ``[BH, rows, D]`` operand ``x``: ``(address, D, rows, BH, row stride,
    head stride, 64, box_rows, 1)``, dims innermost first and strides in
    bytes; a box is 64 columns (one 128-byte swizzle row) by ``box_rows``
    rows of one head, and D = 128 is read as two boxes. A band view of a
    longer tensor keeps that tensor's head stride and a base address
    inside it; the hardware zero-fills box rows at or past ``rows``.
    Raises ValueError where TMA cannot read ``x``: rows not contiguous, a
    base address or head stride not a multiple of 16 bytes, heads that
    overlap, or D not a multiple of 64."""
    if x.dim() != 3:
        raise ValueError(f"expected a [BH, rows, D] operand, got shape "
                         f"{tuple(x.shape)}")
    bh, rows, d = x.shape
    s_head, s_row, s_col = x.stride()
    es = x.element_size()
    addr = x.data_ptr()
    if d % _BOX_COLS or rows < 1 or bh < 1:
        raise ValueError(f"tensor maps take D a multiple of {_BOX_COLS} and "
                         f"at least one row and head, got {tuple(x.shape)}")
    if s_col != 1 or s_row != d:
        raise ValueError("tensor maps take operands with contiguous rows, "
                         f"got strides {x.stride()}")
    if addr % 16:
        raise ValueError("tensor maps take a 16-byte aligned base address, "
                         f"got {addr:#x}")
    head = s_head * es if bh > 1 else rows * d * es
    if head % 16 or head < rows * d * es:
        raise ValueError("tensor maps take a head stride that is a multiple "
                         "of 16 bytes and at least one head, got "
                         f"{s_head} elements")
    return (addr, d, rows, bh, d * es, head, _BOX_COLS, box_rows, 1)


def _tensor_maps(*operands) -> ctypes.Array:
    """The geometry of each ``(tensor, box_rows)``, in order, as the C
    entry points take it."""
    words = [w for x, rows in operands for w in tensor_map_geometry(x, rows)]
    return (ctypes.c_uint64 * len(words))(*words)


def _bwd_maps(q, k, v, do, box_rows: tuple[int, int]) -> ctypes.Array:
    """The four tensor maps of a backward kernel, q, k, v, do in that
    order, with ``box_rows`` = (rows of a q and do box, of a k and v box):
    a band view is read in place through its head stride."""
    bq, bk = box_rows
    return _tensor_maps((q, bq), (k, bk), (v, bk), (do, bq))


# Each kernel call is one custom op: its body launches the kernel for
# CUDA tensors (the wrapper below has checked them) and runs the plain
# version for CPU tensors. The ops return new tensors and mutate nothing.


def _route(kernel: str, causal: bool, band: bool) -> _Kernel:
    """The counted route of ``kernel``: square, causal band (``*_rect``)
    or non-causal rectangle (``*_nc_rect``)."""
    if not band:
        return _KERNELS[kernel]
    return _KERNELS[f"{kernel}_rect" if causal else f"{kernel}_nc_rect"]


def _row0(tq: int, tk: int, causal: bool) -> int:
    """Query row 0's absolute row: ``tk - tq`` on a causal band (0 on the
    square), 0 where no diagonal is drawn."""
    return tk - tq if causal else 0


_LIB = torch.library.Library("ray_tpu_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, float scale, "
            "bool causal, bool band) -> (Tensor, Tensor)")
_LIB.define("flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor do, "
            "Tensor lse, Tensor delta, float scale, bool causal, bool band) "
            "-> Tensor")
_LIB.define("flash_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor do, "
            "Tensor lse, Tensor delta, float scale, bool causal, bool band) "
            "-> (Tensor, Tensor)")


def _flash_fwd_impl(q: Tensor, k: Tensor, v: Tensor, scale: float,
                    causal: bool, band: bool) -> tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale, causal)
    bh, tq, d = q.shape
    tk = k.shape[1]
    o = torch.empty((bh, tq, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((bh, tq), device=q.device, dtype=torch.float32)
    bq, bk = _FWD_BOX_ROWS
    _route("flash_fwd", causal, band).launch(
        q.device, _tensor_maps((q, bq), (k, bk), (v, bk)), _P(o.data_ptr()),
        _P(lse.data_ptr()), bh, tq, tk, _row0(tq, tk, causal), d, scale,
        int(causal), int(q.dtype == torch.float16))
    return o, lse


def _flash_bwd_dq_impl(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                       lse: Tensor, delta: Tensor, scale: float, causal: bool,
                       band: bool) -> Tensor:
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal)
    bh, tq, d = q.shape
    tk = k.shape[1]
    dq = torch.empty((bh, tq, d), device=q.device, dtype=q.dtype)
    _route("flash_bwd_dq", causal, band).launch(
        q.device, _bwd_maps(q, k, v, do, _DQ_BOX_ROWS[d]),
        _P(lse.data_ptr()), _P(delta.data_ptr()), _P(dq.data_ptr()), bh, tq,
        tk, _row0(tq, tk, causal), d, scale, int(causal),
        int(q.dtype == torch.float16))
    return dq


def _flash_bwd_dkv_impl(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                        lse: Tensor, delta: Tensor, scale: float,
                        causal: bool, band: bool) -> tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale,
                                       causal)
    bh, tq, d = q.shape
    tk = k.shape[1]
    dk = torch.empty((bh, tk, d), device=q.device, dtype=k.dtype)
    dv = torch.empty((bh, tk, d), device=q.device, dtype=v.dtype)
    _route("flash_bwd_dkv", causal, band).launch(
        q.device, _bwd_maps(q, k, v, do, _DKV_BOX_ROWS[d]),
        _P(lse.data_ptr()), _P(delta.data_ptr()), _P(dk.data_ptr()),
        _P(dv.data_ptr()), bh, tq, tk, _row0(tq, tk, causal), d, scale,
        int(causal), int(q.dtype == torch.float16))
    return dk, dv


for _name, _impl in (("flash_fwd", _flash_fwd_impl),
                     ("flash_bwd_dq", _flash_bwd_dq_impl),
                     ("flash_bwd_dkv", _flash_bwd_dkv_impl)):
    _LIB.impl(_name, _impl, "CompositeExplicitAutograd")
_flash_fwd_op = torch.ops.ray_tpu_torch.flash_fwd.default
_flash_bwd_dq_op = torch.ops.ray_tpu_torch.flash_bwd_dq.default
_flash_bwd_dkv_op = torch.ops.ray_tpu_torch.flash_bwd_dkv.default


def _fwd(q, k, v, scale, causal, band):
    if not _on_cpu(q, k, v):
        check_inputs((q,), (k, v), band=band, causal=causal)
        if not scale > 0:
            raise ValueError(f"the flash forward kernel takes scale > 0, got "
                             f"{scale}")
    return _flash_fwd_op(q, k, v, float(scale), bool(causal), bool(band))


def _bwd_dq(q, k, v, do, lse, delta, scale, causal, band):
    if not _on_cpu(q, k, v, do, lse, delta):
        check_inputs((q, do), (k, v), (lse, delta), band=band, causal=causal)
    return _flash_bwd_dq_op(q, k, v, do, lse, delta, float(scale),
                            bool(causal), bool(band))


def _bwd_dkv(q, k, v, do, lse, delta, scale, causal, band):
    if not _on_cpu(q, k, v, do, lse, delta):
        check_inputs((q, do), (k, v), (lse, delta), band=band, causal=causal)
    return _flash_bwd_dkv_op(q, k, v, do, lse, delta, float(scale),
                             bool(causal), bool(band))


def flash_fwd(q, k, v, scale: float, causal: bool = True):
    """``(o, lse)`` for ``[BH, T, D]`` inputs: the ``flash_fwd`` kernel for
    CUDA tensors, :func:`flash_fwd_reference` for CPU tensors."""
    return _fwd(q, k, v, scale, causal, False)


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool = True):
    """dq: the ``flash_bwd_dq`` kernel for CUDA tensors, the plain
    backward for CPU tensors."""
    return _bwd_dq(q, k, v, do, lse, delta, scale, causal, False)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool = True):
    """(dk, dv): the ``flash_bwd_dkv`` kernel for CUDA tensors, the plain
    backward for CPU tensors."""
    return _bwd_dkv(q, k, v, do, lse, delta, scale, causal, False)


def flash_fwd_rect(q, k, v, scale: float):
    """``(o, lse)`` of one causal band (q ``[BH, tq, D]``, k, v ``[BH, tk,
    D]``): the ``flash_fwd`` kernel's band route for CUDA tensors,
    :func:`flash_fwd_rect_reference` for CPU tensors."""
    return _fwd(q, k, v, scale, True, True)


def flash_bwd_dq_rect(q, k, v, do, lse, delta, scale: float):
    """dq of one causal band: the ``flash_bwd_dq`` kernel's band route for
    CUDA tensors, the plain backward for CPU tensors."""
    return _bwd_dq(q, k, v, do, lse, delta, scale, True, True)


def flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) of one causal band, ``[BH, tk, D]``: the ``flash_bwd_dkv``
    kernel's band route for CUDA tensors, the plain backward for CPU
    tensors."""
    return _bwd_dkv(q, k, v, do, lse, delta, scale, True, True)


def flash_fwd_nc_rect(q, k, v, scale: float):
    """``(o, lse)`` of the non-causal rectangle: q ``[BH, tq, D]`` against
    every one of the ``tk <= tq`` keys of k, v ``[BH, tk, D]`` (the valid
    rows of a padded block, read in place): the ``flash_fwd`` kernel's
    rectangle route for CUDA tensors, :func:`flash_fwd_reference` with
    ``causal=False`` for CPU tensors. With no key (``tk == 0``) it
    launches nothing and returns o = 0 and lse = -inf, the attention over
    an empty row (``jax.nn.dot_product_attention`` gives 0)."""
    if k.shape[1] == 0:
        _on_cpu(q, k, v)
        return (torch.zeros_like(q), torch.full(q.shape[:2], -torch.inf,
                                                dtype=torch.float32,
                                                device=q.device))
    return _fwd(q, k, v, scale, False, True)


def flash_bwd_dq_nc_rect(q, k, v, do, lse, delta, scale: float):
    """dq of the non-causal rectangle: the ``flash_bwd_dq`` kernel's
    rectangle route for CUDA tensors, the plain backward for CPU tensors;
    0 with no key (no launch)."""
    if k.shape[1] == 0:
        _on_cpu(q, k, v, do, lse, delta)
        return torch.zeros_like(q)
    return _bwd_dq(q, k, v, do, lse, delta, scale, False, True)


def flash_bwd_dkv_nc_rect(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) ``[BH, tk, D]`` of the non-causal rectangle: the
    ``flash_bwd_dkv`` kernel's rectangle route for CUDA tensors, the plain
    backward for CPU tensors; empty with no key (no launch)."""
    if k.shape[1] == 0:
        _on_cpu(q, k, v, do, lse, delta)
        return torch.zeros_like(k), torch.zeros_like(v)
    return _bwd_dkv(q, k, v, do, lse, delta, scale, False, True)


class FlashAttentionFn(torch.autograd.Function):
    """``o = attention(q, k, v)`` with the kernels as forward and backward:
    on ``[BH, T, D]`` (the counterpart of the ``jax.custom_vjp``) or, with
    ``band``, on one causal band (q ``[BH, tq, D]``, k, v ``[BH, tk, D]``;
    the counterpart of the ``_rect_core`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, band=False):
        o, lse = _fwd(q, k, v, scale, causal, band)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.band = scale, causal, band
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = _delta(o, do)
        do = do.to(q.dtype)
        if not (_rows_ok(do) if ctx.band else do.is_contiguous()):
            do = do.contiguous()
        args = (q, k, v, do, lse, delta, ctx.scale, ctx.causal, ctx.band)
        dq = _bwd_dq(*args)
        dk, dv = _bwd_dkv(*args)
        # Trailing Nones past the inputs given (band is optional) are dropped.
        return dq, dk, dv, None, None, None


class FlashRectFn:
    """:class:`FlashAttentionFn` on one causal band:
    ``FlashRectFn.apply(q, k, v, scale)``."""

    @staticmethod
    def apply(q, k, v, scale):
        return FlashAttentionFn.apply(q, k, v, scale, True, True)


def _flash_causal_split(q, k, v, scale: float, n_split: int):
    """Causal attention on ``[BH, T, D]`` as ``n_split`` row bands: band r
    is query rows ``[r*s, (r+1)*s)`` against the key/value prefix of
    length ``(r+1)*s`` (``s = T / n_split``), one band
    :class:`FlashAttentionFn` each, read in place. Autograd sums each
    band's dk/dv into the prefix, as JAX autodiff of the slices does
    (``_flash_causal_split``)."""
    s = q.shape[1] // n_split
    outs = [FlashAttentionFn.apply(q[:, r * s:(r + 1) * s],
                                   k[:, :(r + 1) * s], v[:, :(r + 1) * s],
                                   scale, True, True)
            for r in range(n_split)]
    return torch.cat(outs, dim=1)


def _pick_block(t: int, target: int = 1024) -> int:
    """Largest divisor of t that is <= target and a multiple of 8 (0 if
    none): the JAX package's block choice, which decides whether the
    causal split may engage."""
    best = 0
    for b in range(8, min(t, target) + 1, 8):
        if t % b == 0:
            best = b
    return best


def _split_bands(t: int, causal: bool) -> int:
    """The number of bands ``RAY_TPU_FLASH_SPLIT`` asks for, where the JAX
    package engages its split at this ``t``; else 0."""
    n = int(os.environ.get("RAY_TPU_FLASH_SPLIT", 0))
    if (causal and n > 1 and _pick_block(t) == t and t % n == 0
            and (t // n) % 128 == 0):
        return n
    return 0


def resolved_flash_config(t: int, causal: bool = True) -> dict:
    """``{"split": n}``: the number of causal-split bands
    :func:`flash_attention` runs at seq len ``t`` under the current
    ``RAY_TPU_FLASH_SPLIT``, 0 for the unsplit kernels. The JAX version
    also reports its TPU block sizes, which the port does not have."""
    return {"split": _split_bands(t, causal)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Flash attention on ``[B, T, H, D]``; differentiable.

    CUDA tensors run the kernels and raise ValueError for shapes or
    dtypes the kernels do not take (check ``flash_attention_shapes_ok``);
    CPU tensors run the plain versions. ``RAY_TPU_FLASH_SPLIT=n`` runs
    causal attention as n row bands on the band kernels, under the JAX
    package's condition (T at most 1024 and a multiple of 8, T / n a
    multiple of 128; see :func:`resolved_flash_config`)."""
    b, t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    n_split = _split_bands(t, causal)
    if n_split:
        out = _flash_causal_split(fold(q), fold(k), fold(v), float(scale),
                                  n_split)
    else:
        out = FlashAttentionFn.apply(fold(q), fold(k), fold(v), float(scale),
                                     causal)
    return out.view(b, h, t, d).transpose(1, 2)
