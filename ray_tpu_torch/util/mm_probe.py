"""Achievable-matmul probe: the bf16 matmul rate this card delivers.

The counterpart of the JAX package's probe (reference:
``ray_tpu/util/mm_probe.py``). It measures what share of the paper rate
(H100 SXM: 989.4 TFLOP/s dense bf16) the card sustains on a chain of
m x m x m ``torch.matmul`` products, the honest denominator for a model
FLOP utilisation: ``mfu_vs_achievable`` divides by it.

The product is cuBLAS's, as the reference's is XLA's: the JAX package
runs this matmul outside any Pallas kernel, so the probe measures the
library's rate on purpose. No kernel of the port is on its path.

Invariants, each of which the reference found by a bogus reading, in
their Hopper form:

- The carry is the MATRIX ``r`` and it feeds the next product: each link
  computes ``r <- bf16((r @ a) / max(max|r @ a|, 1e-6))``
  (:func:`matmul_chain`). A chain whose links re-read a fixed input
  would let a compiler (XLA's loop-invariant code motion in the
  reference; a captured graph or ``torch.compile`` here) compute the
  product once. The chain's result is read as a float, so its work ends
  before the clock stops.
- The rate comes from a TWO-POINT fit: the long chain's time minus the
  short chain's, each time the best of ``reps`` after a warm-up chain.
  The difference cancels what every chain pays once: the first launch,
  the read of the result, the clock itself. The best of ``reps`` keeps a
  stall that inflates the short chain from overstating the rate.
- Every clock read on the card comes after ``torch.cuda.synchronize``.
  PyTorch returns from a launch before the card has run it, so a host
  clock read without that sync times the launch queue: the Hopper form
  of the hoisting trap, a chain that looks far faster than the card.
- A reading outside (peak / 20, peak] is INVALID and the probe returns
  0.0, never an absurd number: a non-positive difference (a stall
  absorbed by the short chain), a rate above the paper peak (the clock
  did not wait for the card), or one under a twentieth of it (the probe
  swamped by load).

The normalisation passes (``abs``, ``amax``, the divide and the cast, in
eager PyTorch over the m x m carry) stay inside each timed link, as in
the reference, so the reading is a little under the products' own rate;
chip_smoke's phase 24 reports what share of the long chain's device
time the matmul kernels take.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# H100 SXM, dense bf16 tensor-core peak (NVIDIA data sheet), TFLOP/s,
# at the full 700 W power limit. The reference uses v5e's 197.
PEAK_BF16_TFLOPS = 989.4


def chain_inputs(m: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(r0, a)`` in bf16 on ``device``: ``a = I + 0.01 N``, ``r0 = N``,
    drawn from ``np.random.default_rng(0)`` in the reference's order (a's
    noise first)."""
    bf16 = torch.bfloat16
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32))
    # 0.01 as a bf16 tensor: JAX rounds the weakly typed scalar to bf16,
    # where torch would keep a Python scalar in float32.
    a = torch.eye(m, dtype=bf16) + torch.tensor(0.01, dtype=bf16) * noise.to(bf16)
    r0 = torch.from_numpy(
        rng.standard_normal((m, m)).astype(np.float32)).to(torch.bfloat16)
    return r0.to(device), a.to(device)


def matmul_chain(r: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` links of ``r <- bf16((r @ a) / max(max|r @ a|, 1e-6))``: the
    carry ``r`` feeds each product (reference: the scan body of
    ``ray_tpu/util/mm_probe.py``)."""
    for _ in range(k):
        r2 = torch.matmul(r, a)
        r = (r2 / torch.clamp(r2.abs().amax(), min=1e-6)).to(torch.bfloat16)
    return r


def _clock(device: torch.device) -> float:
    """The host clock, read once the card has run everything queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def achievable_matmul_tflops(m: int = 8192, k_short: int = 5,
                             k_long: int = 25, device=None) -> float:
    """Delivered bf16 TFLOP/s on an m^3 matmul chain; 0.0 = invalid.

    ``device`` None is the card (``core.accelerator.default_device``,
    which raises without one); ``"cpu"`` is the explicit opt-in."""
    from ray_tpu_torch.core.accelerator import resolve_device
    device = resolve_device(device)
    r0, a = chain_inputs(m, device)

    def run(kk: int) -> float:
        return float(matmul_chain(r0, a, kk).float().reshape(-1)[0])

    def timed(kk: int, reps: int = 2) -> float:
        run(kk)                                    # warm-up chain
        best = float("inf")
        for _ in range(reps):
            t0 = _clock(device)
            run(kk)
            best = min(best, _clock(device) - t0)
        return best

    diff = timed(k_long) - timed(k_short)
    if diff <= 0:
        return 0.0
    rate = 2 * m**3 * (k_long - k_short) / diff / 1e12
    if rate > PEAK_BF16_TFLOPS or rate < PEAK_BF16_TFLOPS / 20:
        return 0.0
    return rate
