"""Card-only tests of phase 24: the achievable-matmul probe on the card.

Phase 24's check (a valid reading inside (peak / 20, peak] in one of
``MM_PROBE_ATTEMPTS`` attempts, at the probe's full 8192^3 size) and the
planted ``mm_probe_host_clock`` probe (each chain timed on the host clock
without a synchronize) read as invalid in every attempt. Marked ``cuda``:
run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mm_probe.py

It skips, from inside each test, where no card is visible.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def test_phase_24_reads_a_valid_rate():
    c = _chip_smoke()
    out = c.mm_probe_phase(c.card_line())
    peak = c.mm_probe.PEAK_BF16_TFLOPS
    assert out["held"], out["attempts"]
    assert peak / 20 < out["rate"] <= peak, out["attempts"]


def test_host_clock_fault_reads_invalid_in_every_attempt():
    c = _chip_smoke()
    out = c.mm_probe_phase(c.card_line(), fault="mm_probe_host_clock")
    assert not out["held"]
    assert out["attempts"] == [0.0] * c.MM_PROBE_ATTEMPTS
