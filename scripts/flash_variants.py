#!/usr/bin/env python3
"""A/B the tuning constants of the TMA flash kernels on one GPU.

    python3 scripts/flash_variants.py            # every variant below
    python3 scripts/flash_variants.py NAME ...   # some of them

Each variant is a copy of ``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``
or ``csrc/flash_bwd_dkv.cu`` with one or two constants substituted
(block shape, ring depth, tile, overlap of products), built with the
repo's nvcc flags under the gitignored build directory and bound to the
wrapper in place of the committed kernel. For each it prints ptxas'
registers and spills, and at GPT-2's (B32 T1024 H12) and TinyLlama's (B8
T2048 H32) attention shapes, D = 64 bf16 causal, whether it agrees with
the plain version and its device time (``chip_smoke.cuda_ms``) over
SDPA's in the same run: the forward over SDPA's forward, dq and dk/dv
over SDPA's whole backward. The forward and dq variants also run every
band of split 2 and 4 and check the split's o (dq) bit for bit against
the unsplit kernel's. ``committed`` rows are the sources as they are.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.ops.cuda import build  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

# name: (kernel, [(text, replacement)], (wrapper box table, its value) or None)
VARIANTS = {
    "fwd_committed": ("flash_fwd", [], None),
    "fwd_one_warpgroup": (
        "flash_fwd", [("constexpr int kFwdWGs = 2;", "constexpr int kFwdWGs = 1;")],
        ("_FWD_BOX_ROWS", (64, 128))),
    "fwd_stages_3": ("flash_fwd", [("kStages = D == 64 ? 5 : 2",
                                    "kStages = D == 64 ? 3 : 2")], None),
    "fwd_stages_4": ("flash_fwd", [("kStages = D == 64 ? 5 : 2",
                                    "kStages = D == 64 ? 4 : 2")], None),
    "dq_committed": ("flash_bwd_dq", [], None),
    "dq_one_warpgroup": (
        "flash_bwd_dq", [("constexpr int kDqWGs = 2;", "constexpr int kDqWGs = 1;"),
                         ("kStages = D == 64 ? 4 : 2", "kStages = D == 64 ? 2 : 2")],
        ("_DQ_BOX_ROWS", {64: (64, 128), 128: (64, 64)})),
    "dq_no_overlap": ("flash_bwd_dq", [("constexpr bool kDqOverlap = true;",
                                        "constexpr bool kDqOverlap = false;")], None),
    "dq_bk64": ("flash_bwd_dq", [("kBK = D == 64 ? 128 : 64", "kBK = D == 64 ? 64 : 64")],
                ("_DQ_BOX_ROWS", {64: (128, 64), 128: (128, 64)})),
    "dq_stages_2": ("flash_bwd_dq", [("kStages = D == 64 ? 4 : 2",
                                      "kStages = D == 64 ? 2 : 2")], None),
    "dq_stages_3": ("flash_bwd_dq", [("kStages = D == 64 ? 4 : 2",
                                      "kStages = D == 64 ? 3 : 2")], None),
    "dkv_committed": ("flash_bwd_dkv", [], None),
    "dkv_two_warpgroups": (
        "flash_bwd_dkv", [("constexpr int kDkvWGs = 1;", "constexpr int kDkvWGs = 2;")],
        ("_DKV_BOX_ROWS", {64: (64, 128), 128: (32, 128)})),
    "dkv_bq32": ("flash_bwd_dkv", [("kBQ = D == 64 ? 64 : 32", "kBQ = D == 64 ? 32 : 32")],
                 ("_DKV_BOX_ROWS", {64: (32, 64), 128: (32, 64)})),
    "dkv_stages_2": ("flash_bwd_dkv", [("kStages = D == 64 ? 3 : 2",
                                        "kStages = D == 64 ? 2 : 2")], None),
}
SHAPES = ((32, 1024, 12), (8, 2048, 32))  # (batch, seq, heads), D = 64
SCALE = 64 ** -0.5


def build_variants(names):
    """Build every variant at once; {name: (library path, nvcc output,
    source)}."""
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        kernel, subs, _ = VARIANTS[name]
        with open(build.sources()[kernel]) as f:
            src = f.read()
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {kernel}.cu once")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, src, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.SRC_DIR, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, src, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log[-3000:]}")
        built[name] = (lib, log, src)
    return built


class bound_to:
    """Bind both routes of the variant's kernel (and its box table) to the
    variant's library inside the block."""

    def __init__(self, name, lib):
        self.kernel, _, self.box = VARIANTS[name]
        fn = getattr(ctypes.CDLL(lib), fa._KERNELS[self.kernel].symbol)
        fn.argtypes = fa._KERNELS[self.kernel].argtypes
        fn.restype = ctypes.c_int
        self.fn = fn

    def __enter__(self):
        self.saved = {r: fa._KERNELS[r]._fn for r in (self.kernel, self.kernel + "_rect")}
        for r in self.saved:
            fa._KERNELS[r]._fn = self.fn
        if self.box:
            self.saved_box = getattr(fa, self.box[0])
            setattr(fa, self.box[0], self.box[1])

    def __exit__(self, *exc):
        for r, fn in self.saved.items():
            fa._KERNELS[r]._fn = fn
        if self.box:
            setattr(fa, self.box[0], self.saved_box)


def library_ms(b, t, h, q, k, v, do):
    q4, k4, v4, do4 = (x.view(b, h, t, 64) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    fwd = cs.cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20)
    bwd = cs.cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                                 retain_graph=True), 20)
    return fwd, bwd


def square_rows(kernel, dev, lib_times):
    for b, t, h in SHAPES:
        cs.H = h
        q, k, v, do = cs.kernel_inputs(b, t, dev)
        if (b, t) not in lib_times:
            lib_times[(b, t)] = library_ms(b, t, h, q, k, v, do)
        lib_fwd, lib_bwd = lib_times[(b, t)]
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, SCALE, True)
        if kernel == "flash_fwd":
            o, _ = fa.flash_fwd(q, k, v, SCALE, True)
            ok = fa.agreement(o, o_ref)["ok"]
            ms = cs.cuda_ms(lambda: fa.flash_fwd(q, k, v, SCALE, True), 20)
            lib = lib_fwd
        elif kernel == "flash_bwd_dq":
            delta = (o_ref.float() * do.float()).sum(-1)
            bwd = (q, k, v, do, lse_ref, delta, SCALE, True)
            ok = fa.agreement(fa.flash_bwd_dq(*bwd),
                              fa.flash_bwd_dq_reference(*bwd))["ok"]
            ms = cs.cuda_ms(lambda: fa.flash_bwd_dq(*bwd), 20)
            lib = lib_bwd
        else:
            delta = (o_ref.float() * do.float()).sum(-1)
            bwd = (q, k, v, do, lse_ref, delta, SCALE, True)
            got, want = fa.flash_bwd_dkv(*bwd), fa.flash_bwd_dkv_reference(*bwd)
            ok = all(fa.agreement(x, y)["ok"] for x, y in zip(got, want))
            ms = cs.cuda_ms(lambda: fa.flash_bwd_dkv(*bwd), 20)
            lib = lib_bwd
        print(f"  B{b} T{t} H{h}: agrees {ok}, {ms:.4f} ms, {ms / lib:.3f}x SDPA "
              f"({lib:.4f} ms)", flush=True)
    cs.H = 12


def dq_band_rows(dev):
    """dq on every band of split 2 and 4, on the unsplit forward's lse and
    delta rows: the time summed over the bands, and whether the bands' dq
    equals the unsplit kernel's bit for bit."""
    q, k, v, do = cs.kernel_inputs(32, 1024, dev)
    o, lse = fa.flash_fwd(q, k, v, SCALE, True)
    delta = (o.float() * do.float()).sum(-1)
    whole = fa.flash_bwd_dq(q, k, v, do, lse, delta, SCALE, True)
    for n in cs.SPLITS:
        ms = 0.0
        outs = []
        for tq, tk, (qb, kb, vb, dob) in cs.bands(q, k, v, do, n):
            rows = slice(tk - tq, tk)
            bwd = (qb, kb, vb, dob, lse[:, rows].contiguous(),
                   delta[:, rows].contiguous(), SCALE)
            ms += cs.cuda_ms(lambda: fa.flash_bwd_dq_rect(*bwd), 20)
            outs.append(fa.flash_bwd_dq_rect(*bwd))
        equal = torch.equal(torch.cat(outs, 1), whole)
        print(f"  split {n}, all bands: {ms:.4f} ms; dq equals the unsplit "
              f"kernel's bit for bit: {equal}", flush=True)


def band_rows(dev, lib_times):
    from torch.nn.attention.bias import causal_lower_right

    q, k, v, do = cs.kernel_inputs(32, 1024, dev)
    whole, _ = fa.flash_fwd(q, k, v, SCALE, True)
    for n in cs.SPLITS:
        ms = lib = 0.0
        outs = []
        for tq, tk, (qb, kb, vb, _) in cs.bands(q, k, v, do, n):
            ms += cs.cuda_ms(lambda: fa.flash_fwd_rect(qb, kb, vb, SCALE), 20)
            outs.append(fa.flash_fwd_rect(qb, kb, vb, SCALE)[0])
            if (tq, tk) not in lib_times:
                q4, k4, v4 = (x.reshape(32, 12, -1, 64).contiguous() for x in (qb, kb, vb))
                mask = causal_lower_right(tq, tk)
                lib_times[(tq, tk)] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask), 20)
            lib += lib_times[(tq, tk)]
        equal = torch.equal(torch.cat(outs, 1), whole)
        print(f"  split {n}, all bands: {ms:.4f} ms, {ms / lib:.3f}x SDPA ({lib:.4f} ms); "
              f"o equals the unsplit kernel's bit for bit: {equal}", flush=True)


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    build.ensure_built()
    built = build_variants(names)
    lib_times = {}
    for name in names:
        lib, log, src = built[name]
        kernel = VARIANTS[name][0]
        print(f"{name}: {cs.ptxas_usage(log)}", flush=True)
        # A block of two consumer warpgroups moves registers with setmaxnreg,
        # which needs ptxas' full 168 at entry: refuse to launch otherwise.
        two = re.search(r"constexpr int k(Fwd|Dq|Dkv)WGs = 2;", src) is not None
        if two and set(re.findall(r"Used (\d+) registers", log)) != {"168"}:
            print("  not launched: setmaxnreg needs 168 registers at entry", flush=True)
            continue
        with bound_to(name, lib):
            square_rows(kernel, dev, lib_times)
            if kernel == "flash_fwd":
                band_rows(dev, lib_times)
            elif kernel == "flash_bwd_dq":
                dq_band_rows(dev)
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
