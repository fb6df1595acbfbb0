"""Card-only tests of phase 23 at a small depth: the device-trace summary
of a real card trace held against ``torch.profiler``'s own
``key_averages``, and a ``num_gpus=1`` task in a container (through a
fake runner) on the card the scheduler gave it.

GPT-2 at GPT-2 small's width with 4 blocks. Marked ``cuda``: run on the
card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_cli.py

It skips, from inside each test, where no card is visible.
"""

from __future__ import annotations

import json
import os
import stat
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LAYER = 4
RTOL = 0.01


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")


def test_device_trace_summary_matches_key_averages(tmp_path):
    """Two captured GPT-2 train steps under ``start_device_profile``: the
    summary sums the card's plane, its total and each flash kernel's time
    within 1% of ``key_averages``', its matmul rows cuBLAS/CUTLASS
    kernels, the flash kernels on the non-matmul side."""
    _card()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from torch.autograd import DeviceType

    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.observability.profiler import device_trace_summary
    from ray_tpu_torch.util.tracing import (
        start_device_profile, stop_device_profile,
    )
    cfg = GPT2Config.small(n_layer=N_LAYER)
    model = GPT2(cfg, seed=0)
    torch.cuda.synchronize()
    prof = start_device_profile()
    run = chip_smoke.gpt2_steps(model, chip_smoke.train_batch(
        cfg.vocab_size, 8, 1024), 2, 0, True)
    torch.cuda.synchronize()
    stop_device_profile(prof, str(tmp_path))
    s = device_trace_summary(str(tmp_path), top_k=30, steps=2)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    assert s["plane"].startswith("/device:gpu"), s["plane"]
    assert abs(s["total_ms"] - total) <= RTOL * total, (s["total_ms"], total)
    assert run["counts"]["flash_fwd"] == 2 * N_LAYER
    every = s["top_non_matmul"] + s["top_matmul"]
    for fn in chip_smoke.KERNEL_NAMES.values():
        want = sum(e.self_device_time_total for e in rows
                   if fn in e.key) / 1e3
        got = sum(r["ms"] for r in every if fn in r["name"]) * 2
        assert want > 0 and abs(got - want) <= RTOL * want, (fn, got, want)
        assert not any(fn in r["name"] for r in s["top_matmul"])
    assert s["top_matmul"] and all(
        chip_smoke.is_matmul_kernel(r["name"]) for r in s["top_matmul"])


def test_container_task_runs_on_the_card_it_was_given(tmp_path,
                                                      monkeypatch):
    """A ``num_gpus=1`` task with a container runtime_env: the runner gets
    the CDI device flag and the forwarded ``CUDA_VISIBLE_DEVICES``, and
    the task's ``torch.cuda`` UUID is that of the card the scheduler gave
    it."""
    _card()
    import ray_tpu_torch as rt
    marker = tmp_path / "ran.jsonl"
    runner = tmp_path / "fake_podman"
    sys.path.insert(0, ROOT)
    import chip_smoke
    runner.write_text(chip_smoke.FAKE_RUNNER.format(
        python=sys.executable, marker=str(marker)))
    runner.chmod(runner.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("RAY_TPU_CONTAINER_RUNNER", str(runner))

    def where():
        import torch
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "uuid": str(torch.cuda.get_device_properties(0).uuid),
                "pid": os.getpid()}

    rt.init(num_cpus=2, num_gpus=1)
    try:
        out = rt.get(rt.remote(num_gpus=1, runtime_env={
            "container": {"image": "fake"}})(where).remote(), timeout=300)
    finally:
        rt.shutdown()
    rec = [json.loads(x) for x in marker.read_text().splitlines()]
    argv = next(r["argv"] for r in rec if r["pid"] == out["pid"])
    assert "--device=nvidia.com/gpu=all" in argv, argv
    assert f"--env=CUDA_VISIBLE_DEVICES={out['visible']}" in argv, argv
    ids = (os.environ.get("CUDA_VISIBLE_DEVICES") or ",".join(
        str(i) for i in range(torch.cuda.device_count()))).split(",")
    want = str(torch.cuda.get_device_properties(
        ids.index(out["visible"])).uuid)
    assert out["uuid"] == want, (out, want)
