"""What the Hopper flash kernels are told about their operands, checked on
the CPU.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` read q, k, v and
do through TMA tensor maps. The C entry points encode each map from the
geometry that ``flash_attention.tensor_map_geometry`` computes in Python
(address, dims innermost first, byte strides, box), so that geometry is
held here: square ``[BH, T, D]`` operands at D = 64 and 128, every band
view of split 2 and 4 taken in place from a ``[BH, 1024, D]`` tensor,
ragged T, and the refusal of what TMA cannot read. The box rows the
wrapper asks for are held against the tile constants of the CUDA
sources, which refuse any other box, and the two routes of each kernel
against its one C entry point.

The square and band routes share one input check
(``flash_attention.check_inputs``); its verdicts are held on the cases
of the two checks it replaced. Exact comparisons: the geometry is
integer arithmetic on shapes, strides and addresses.
"""

from __future__ import annotations

import ctypes
import os
import re

import pytest
import torch

from ray_tpu_torch.ops.cuda import build
from ray_tpu_torch.ops.cuda import flash_attention as fa

BF16 = torch.bfloat16


def _expected(x, base_ptr, row_off, rows, head_stride, box_rows):
    bh, _, d = x.shape
    return (base_ptr + row_off * d * 2, d, rows, bh, d * 2, head_stride * 2,
            64, box_rows, 1)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [1, 37, 128, 130, 1024])
def test_square_geometry(t, d):
    x = torch.zeros(3, t, d, dtype=BF16)
    geo = fa.tensor_map_geometry(x, 128)
    assert geo == _expected(x, x.data_ptr(), 0, t, t * d, 128)
    # D = 128 is two 64-column boxes of the same map.
    assert geo[6] * (d // 64) == d


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_split", [2, 4])
def test_band_views_are_read_in_place(n_split, d):
    """Every band of the causal split of a [BH, 1024, D] tensor: the q band
    starts inside the tensor at its first row, the k/v prefix at row 0,
    both with the whole tensor's head stride."""
    bh, t = 4, 1024
    q, k = (torch.zeros(bh, t, d, dtype=BF16) for _ in range(2))
    s = t // n_split
    for r in range(n_split):
        lo, hi = r * s, (r + 1) * s
        qb, kb = q[:, lo:hi], k[:, :hi]
        assert fa.tensor_map_geometry(qb, 64) == _expected(
            qb, q.data_ptr(), lo, s, t * d, 64)
        assert fa.tensor_map_geometry(kb, 128) == _expected(
            kb, k.data_ptr(), 0, hi, t * d, 128)


def test_one_head_takes_its_own_extent_as_head_stride():
    x = torch.zeros(4, 256, 64, dtype=BF16)[:1, 100:137]
    geo = fa.tensor_map_geometry(x, 128)
    assert geo[2:4] == (37, 1) and geo[5] == 37 * 64 * 2


def test_refuses_what_tma_cannot_read():
    flat = torch.zeros(2 * 64 * 64 + 8, dtype=BF16)
    cases = [
        (flat[4:4 + 2 * 64 * 64].view(2, 64, 64), "16-byte aligned base"),
        (torch.zeros(2 * (64 * 64 + 4), dtype=BF16).as_strided(
            (2, 64, 64), (64 * 64 + 4, 64, 1)), "head stride"),
        (torch.zeros(2, 64, 64, dtype=BF16).as_strided(
            (2, 64, 64), (64 * 16, 64, 1)), "head stride"),
        (torch.zeros(2, 64, 64, dtype=BF16).transpose(1, 2),
         "contiguous rows"),
        (torch.zeros(2, 64, 32, dtype=BF16), "multiple of 64"),
        (torch.zeros(64, 64, dtype=BF16), r"\[BH, rows, D\]"),
    ]
    for x, match in cases:
        with pytest.raises(ValueError, match=match):
            fa.tensor_map_geometry(x, 128)


def test_maps_pack_each_operand_in_order():
    q, k = torch.zeros(2, 100, 64, dtype=BF16), torch.zeros(2, 300, 64,
                                                            dtype=BF16)
    maps = fa._tensor_maps((q, 64), (k, 128))
    assert isinstance(maps, ctypes.Array) and len(maps) == 18
    assert tuple(maps[:9]) == fa.tensor_map_geometry(q, 64)
    assert tuple(maps[9:]) == fa.tensor_map_geometry(k, 128)


def _const(src: str, name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)


def _source(name: str) -> str:
    with open(build.sources()[name]) as f:
        return f.read()


def test_box_rows_match_the_kernels_tiles():
    """The wrapper's box rows are the tiles the CUDA sources are built
    with: the forward's 64 query rows per consumer warpgroup and kFwdBK
    key rows; dq's 64 query rows per consumer warpgroup and kBK key rows;
    dk/dv's kBQ query rows and 64 key rows per warpgroup."""
    fwd, dq, dkv = (_source(n) for n in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv"))
    assert fa._FWD_BOX_ROWS == (64 * int(_const(fwd, "kFwdWGs")),
                                int(_const(fwd, "kFwdBK")))
    wgs = int(_const(dq, "kDqWGs"))
    bk = re.search(r"kBK = D == 64 \? (\d+) : (\d+);", dq).groups()
    assert fa._DQ_BOX_ROWS == {64: (64 * wgs, int(bk[0])),
                               128: (64 * wgs, int(bk[1]))}
    wgs = int(_const(dkv, "kDkvWGs"))
    bq = re.search(r"kBQ = D == 64 \? (\d+) : (\d+);", dkv).groups()
    assert fa._DKV_BOX_ROWS == {64: (int(bq[0]), 64 * wgs),
                                128: (int(bq[1]), 64 * wgs)}
    assert os.path.basename(build.sources()["flash_fwd"]) == "flash_fwd.cu"


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
def test_both_routes_bind_one_symbol(kernel):
    """The square route and the band route (``*_rect``) of each kernel
    bind the same C entry point with the same argtypes list, and that
    entry point is the only one the source exports."""
    square, band = fa._KERNELS[kernel], fa._KERNELS[kernel + "_rect"]
    assert square.source == band.source == kernel
    assert square.symbol == band.symbol == f"rtt_{kernel}"
    assert square.argtypes is band.argtypes
    exported = re.findall(r'extern "C" int (\w+)\(', _source(kernel))
    assert exported == [square.symbol]


def test_dq_kernel_is_tma_and_wgmma():
    """The dq kernel's products are wgmma fed by TMA loads through
    mbarriers, with no mma.sync left in it or in the shared header, and
    its one entry point takes the four tensor maps of _DQ_ARGS."""
    src = _source("flash_bwd_dq")
    assert "mma.sync" not in src
    with open(os.path.join(build.SRC_DIR, "flash_common.cuh")) as f:
        common = f.read()
    for gone in ("mma.sync", "load_tile", "frag_a", "frag_b", "Shape",
                 "kTile", "ld32", "pack_raw"):
        assert gone not in common, gone
    for used in ("wgmma_ss<T, kBK>", "wgmma_rs_mn<T>", "tma_load_tile<D>",
                 "mbar_wait", "make_tensor_map<T>(&do_map"):
        assert used in src, used
    assert fa._DQ_ARGS[0] is fa._MAPS and len(fa._DQ_ARGS) == 13


@pytest.mark.parametrize("box", ["dq", "dkv"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_split", [2, 4])
def test_bwd_maps_read_band_views_in_place(n_split, d, box):
    """The four maps of a backward kernel on every band of split n of
    [BH, 1024, D] tensors: q and do start at the band's first row, k and
    v at row 0, each with the whole tensor's head stride, in the order
    q, k, v, do and with the kernel's box rows."""
    bh, t = 3, 1024
    q, k, v, do = (torch.zeros(bh, t, d, dtype=BF16) for _ in range(4))
    rows = (fa._DQ_BOX_ROWS if box == "dq" else fa._DKV_BOX_ROWS)[d]
    s = t // n_split
    for r in range(n_split):
        lo, hi = r * s, (r + 1) * s
        views = (q[:, lo:hi], k[:, :hi], v[:, :hi], do[:, lo:hi])
        maps = fa._bwd_maps(*views, rows)
        assert isinstance(maps, ctypes.Array) and len(maps) == 36
        want = [_expected(views[0], q.data_ptr(), lo, s, t * d, rows[0]),
                _expected(views[1], k.data_ptr(), 0, hi, t * d, rows[1]),
                _expected(views[2], v.data_ptr(), 0, hi, t * d, rows[1]),
                _expected(views[3], do.data_ptr(), lo, s, t * d, rows[0])]
        for i, geo in enumerate(want):
            assert tuple(maps[9 * i:9 * i + 9]) == geo


def test_bwd_maps_refuse_a_misaligned_view():
    """A view whose base is not 16-byte aligned (a band that starts 4
    elements into a row) is refused before any map is built."""
    x = torch.zeros(2, 256, 64, dtype=BF16)
    good = x[:, :128]
    bad = x.view(-1)[4:4 + 2 * 128 * 64].view(2, 128, 64)
    for i in range(4):
        ops = [good] * 4
        ops[i] = bad
        with pytest.raises(ValueError, match="16-byte aligned base"):
            fa._bwd_maps(*ops, fa._DQ_BOX_ROWS[64])


# The cases of the two input checks the folded one replaced (square:
# tests/test_torch_flash_attention.py; band:
# tests/test_torch_flash_split.py), each with its verdict: None accepts,
# a pattern names the refusal.
_OK = torch.zeros(2, 8, 64, dtype=BF16)
_ROWS8 = torch.zeros(2, 8)
_BASE = torch.zeros(2, 256, 64, dtype=BF16)
_ROWS128 = torch.zeros(2, 128)
_MISALIGNED = _BASE.view(-1)[4:4 + 2 * 128 * 64].view(2, 128, 64)
SQUARE_CASES = [
    (((_OK, _OK, _OK, _OK), (_ROWS8, _ROWS8)), None),
    (((_OK.float(),), ()), "bf16 or fp16"),
    (((torch.zeros(2, 8, 96, dtype=BF16),), ()), "head_dim"),
    (((_OK, torch.zeros(2, 9, 64, dtype=BF16)), ()), "share shape"),
    (((_OK, _OK.half()), ()), "share shape"),
    (((torch.zeros(2, 64, 8, dtype=BF16).transpose(1, 2),), ()),
     "contiguous"),
    (((torch.zeros(8, 64, dtype=BF16),), ()), r"\[BH, T, D\]"),
    (((_OK,), (_ROWS8.double(),)), "lse/delta"),
    (((_OK,), (torch.zeros(2, 9),)), "lse/delta"),
    # A band view is not a square operand: the square route takes
    # contiguous operands only.
    (((_BASE[:, 128:],), ()), "contiguous"),
]
BAND_CASES = [
    (((_BASE[:, 128:], _BASE[:, 128:]), (_BASE, _BASE), (_ROWS128,
                                                         _ROWS128)), None),
    (((_BASE.float()[:, :128],), (_BASE.float(),), ()), "bf16 or fp16"),
    (((_BASE[:, :128],), (_BASE[:, :64],), ()), "tk >= tq"),
    (((_BASE[:, :128],), (_BASE, _BASE.half()), ()), "share BH"),
    (((_BASE[:, :128].unsqueeze(0),), (_BASE,), ()), r"\[BH, T, D\]"),
    (((_BASE[:, :, :32][:, :128],), (_BASE[:, :, :32],), ()), "head_dim"),
    (((torch.zeros(2, 64, 128, dtype=BF16).transpose(1, 2),), (_BASE,), ()),
     "contiguous, 16-byte aligned rows"),
    (((_MISALIGNED,), (_BASE,), ()), "contiguous, 16-byte aligned rows"),
    (((_BASE[:, 128:],), (_BASE,), (torch.zeros(2, 256),)), "lse/delta"),
]


def _verdict(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", range(len(SQUARE_CASES)))
def test_folded_check_keeps_the_square_verdicts(case):
    (seq, rows), want = SQUARE_CASES[case]
    got = _verdict(fa.check_inputs, seq, (), rows, band=False)
    assert got == _verdict(fa.check_kernel_inputs, seq, rows)
    if want is None:
        assert got is None
    else:
        assert got is not None and re.search(want, got), got


@pytest.mark.parametrize("case", range(len(BAND_CASES)))
def test_folded_check_keeps_the_band_verdicts(case):
    (q_side, kv_side, rows), want = BAND_CASES[case]
    got = _verdict(fa.check_inputs, q_side, kv_side, rows, band=True)
    assert got == _verdict(fa.check_rect_inputs, q_side, kv_side, rows)
    if want is None:
        assert got is None
    else:
        assert got is not None and re.search(want, got), got


def test_square_route_splits_q_side_and_kv_side_alike():
    """The wrappers pass q (and do) and k, v apart; on the square route
    that is the same verdict as passing them together."""
    k9 = torch.zeros(2, 9, 64, dtype=BF16)
    assert _verdict(fa.check_inputs, (_OK,), (_OK, _OK), band=False) is None
    got = _verdict(fa.check_inputs, (_OK,), (k9, _OK), band=False)
    assert got == _verdict(fa.check_kernel_inputs, (_OK, k9, _OK))
    assert "share shape" in got


def test_one_function_serves_both_routes():
    """FlashRectFn is FlashAttentionFn with band set: same output and
    gradients, and the band's diagonal bottom-right aligned."""
    g = torch.Generator().manual_seed(0)
    q, g_out = (torch.randn(3, 48, 64, generator=g) for _ in range(2))
    k, v = (torch.randn(3, 80, 64, generator=g) for _ in range(2))
    outs = []
    for apply in (lambda *x: fa.FlashRectFn.apply(*x, 0.125),
                  lambda *x: fa.FlashAttentionFn.apply(*x, 0.125, True, True)):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        out = apply(*ins)
        outs.append((out, *torch.autograd.grad(out, ins, g_out)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    o_ref, _ = fa.flash_fwd_reference(q, k, v, 0.125, True)
    assert torch.equal(outs[0][0], o_ref)
