"""``observability.chrome_trace`` (``device_trace_summary``), the port's
counterpart of the JAX package's xplane summary
(``ray_tpu/observability/xplane.py`` ``summarize_trace``).

A synthetic torch.profiler trace with known ``kernel``, ``cpu_op`` and
``cuda_runtime`` events is summed exactly (totals, top-k, shares,
``ms_per_step``), with the JAX summary's keys and rounding; the matmul
markers are held on kernel names that an H100 run prints; a real CPU
torch.profiler trace of a GPT-2 tiny train step is summarised over its
host plane and held against the profiler's own totals; an empty
directory raises ValueError, as the JAX summary's does.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from ray_tpu_torch.observability import chrome_trace
from ray_tpu_torch.observability.profiler import device_trace_summary

# Kernel names of an H100 run (cuBLAS 12.8, CUTLASS, cuDNN, the port's
# flash kernels, an ATen elementwise kernel), each with its side.
H100_NAMES = {
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT": True,
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64": True,
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>": True,
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc":
        True,
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float>": False,
    "sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16": True,
    "void rtt::flash_fwd_kernel<64, true>(CUtensorMap_st, rtt::FwdArgs)":
        False,
    "void rtt::flash_bwd_dq_kernel<64>(CUtensorMap_st, rtt::DqArgs)": False,
    "void rtt::flash_bwd_dkv_kernel<64>(CUtensorMap_st, rtt::DkvArgs)":
        False,
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<c10::BFloat16>>": False,
    "void at::native::unrolled_elementwise_kernel<"
    "at::native::direct_copy_kernel_cuda, convert>": False,
}

JAX_KEYS = ["files", "matmul_ms", "matmul_share", "ms_per_step",
            "non_matmul_ms", "plane", "top_matmul", "top_non_matmul",
            "total_ms"]


def _write(path, events) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def _synthetic():
    """Two files of a 2-step capture: kernels (one of them a GEMM), a
    memcpy, the host's ATen ops and runtime calls, a gpu_user_annotation
    (not device work) and a flow event (not a complete one)."""
    a = [_ev("kernel", "nvjet_tst_64x8_64x16_1x1_h_bz_TNT", 0, 3000.0, 7),
         _ev("kernel", "void rtt::flash_fwd_kernel<64, true>()", 3000,
             1500.0, 7),
         _ev("kernel", "void at::native::vectorized_elementwise_kernel", 4500,
             250.5, 7),
         _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 4800, 249.5,
             8),
         _ev("gpu_user_annotation", "ProfilerStep#1", 0, 5000.0, 7),
         _ev("cpu_op", "aten::linear", 0, 900.0),
         _ev("cpu_op", "aten::addmm", 100, 700.0),
         _ev("cuda_runtime", "cudaLaunchKernel", 150, 20.0),
         {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 1}]
    b = [_ev("kernel", "nvjet_tst_64x8_64x16_1x1_h_bz_TNT", 0, 1000.0, 7),
         _ev("kernel", "void rtt::flash_fwd_kernel<64, true>()", 1000,
             500.0, 7)]
    return a, b


def test_synthetic_trace_totals_top_k_shares_per_step(tmp_path):
    a, b = _synthetic()
    _write(tmp_path / "trace_1.json", a)
    _write(tmp_path / "nested" / "trace_2.json", b)
    s = device_trace_summary(str(tmp_path), top_k=2, steps=2)
    assert sorted(s) == JAX_KEYS
    assert s["plane"] == "/device:gpu (kernel, gpu_memcpy, gpu_memset)"
    assert s["files"] == 2
    # 4000 + 2000 + 250.5 + 249.5 us of device work; the host's ops and
    # the annotation are not added.
    assert s["total_ms"] == 6.5
    assert s["ms_per_step"] == 3.25
    assert s["matmul_ms"] == 4.0
    assert s["non_matmul_ms"] == 2.5
    assert s["matmul_share"] == round(4.0 / 6.5, 4)
    assert s["top_matmul"] == [{"name": "nvjet_tst_64x8_64x16_1x1_h_bz_TNT",
                                "ms": 2.0, "share": round(4 / 6.5, 4)}]
    assert s["top_non_matmul"] == [
        {"name": "void rtt::flash_fwd_kernel<64, true>()", "ms": 1.0,
         "share": round(2 / 6.5, 4)},
        {"name": "void at::native::vectorized_elementwise_kernel",
         "ms": 0.125, "share": round(0.2505 / 6.5, 4)}]


def test_a_trace_without_device_events_is_summed_over_its_host_ops(
        tmp_path):
    a, _ = _synthetic()
    host = [e for e in a if e.get("cat") in ("cpu_op", "cuda_runtime")]
    _write(tmp_path / "trace_1.json", host)
    s = chrome_trace.summarize_trace(str(tmp_path), top_k=5, steps=1)
    assert s["plane"] == "/host:cpu (cpu_op)"
    # Self times: linear 900 - 700 (addmm inside it), addmm 700; the
    # runtime call is host time of another kind, not an operator.
    assert s["total_ms"] == 0.9 and s["matmul_ms"] == 0.9
    assert {r["name"]: r["ms"] for r in s["top_matmul"]} == \
        {"aten::addmm": 0.7, "aten::linear": 0.2}


@pytest.mark.parametrize("name", sorted(H100_NAMES))
def test_h100_kernel_names_fall_on_their_side(name):
    assert chrome_trace.classify_event(name, "kernel") == H100_NAMES[name]


def test_convert_is_not_a_convolution_and_flash_kernels_are_not_matmul():
    assert not chrome_trace.classify_event("convert_fp32_to_bf16_kernel")
    assert not any(chrome_trace.classify_event(n) for n in (
        "rtt::flash_fwd_kernel", "rtt::flash_bwd_dq_kernel",
        "rtt::flash_bwd_dkv_kernel"))
    assert chrome_trace.classify_event("aten::mm", "cpu_op")
    assert not chrome_trace.classify_event("aten::copy_", "cpu_op")


def test_real_cpu_trace_of_a_gpt2_step_over_its_host_plane(tmp_path):
    """A GPT-2 tiny train step under ``util.tracing.profile_device`` on
    the CPU: the summary sums the host plane, its total equals the
    profiler's own self-CPU total, and the products lead the matmul
    side."""
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.util.tracing import (
        start_device_profile, stop_device_profile,
    )
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
        opt = adamw(1e-3)
        state = init_train_state(model, opt)
        step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (2, 64)))
        batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
        prof = start_device_profile()
        for _ in range(2):
            state, m = step(state, batch)
        stop_device_profile(prof, str(tmp_path))
    finally:
        torch.set_num_threads(n)
    s = device_trace_summary(str(tmp_path), top_k=3, steps=2)
    want = sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3
    assert s["plane"] == "/host:cpu (cpu_op)" and s["files"] == 1
    assert s["total_ms"] == pytest.approx(want, rel=1e-3, abs=2e-3)
    assert s["ms_per_step"] == pytest.approx(s["total_ms"] / 2, abs=1e-3)
    assert s["matmul_ms"] + s["non_matmul_ms"] == pytest.approx(
        s["total_ms"], abs=2e-3)
    assert 0 < s["matmul_share"] < 1
    assert len(s["top_matmul"]) == 3 and len(s["top_non_matmul"]) == 3
    assert all(r["name"].startswith("aten::") for r in s["top_matmul"])
    assert float(m["loss"]) > 0


def test_an_empty_directory_raises_value_error(tmp_path):
    with pytest.raises(ValueError, match="no torch.profiler traces"):
        device_trace_summary(str(tmp_path))
    (tmp_path / "trace_1.json").write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="no events"):
        device_trace_summary(str(tmp_path))


def test_the_keys_are_the_jax_summarys():
    """The JAX summary's keys, read from its source (its reader needs an
    XLA capture)."""
    import inspect

    from ray_tpu.observability import xplane
    src = inspect.getsource(xplane.summarize_trace)
    ret = src[src.rindex("return {"):]
    assert sorted(k for k in JAX_KEYS if f'"{k}"' in ret) == JAX_KEYS
    assert '"name"' in src and '"ms"' in src and '"share"' in src
