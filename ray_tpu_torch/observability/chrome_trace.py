"""Slice breakdown of ``torch.profiler`` Chrome traces (counterpart of
``ray_tpu/observability/xplane.py`` ``summarize_trace``).

``util.tracing.stop_device_profile`` writes ``trace_<pid>.json`` under a
log directory (``prof.export_chrome_trace``). This module reads those
files and returns the summary the JAX package builds from XLA's xplane
protobufs, under the same keys, rounding and meaning: totals over the
capture in ms, ``ms_per_step`` and the top rows' ``ms`` divided by
``steps``, shares of the total.

A torch.profiler trace is one JSON object whose ``traceEvents`` hold
complete events (``"ph": "X"``, ``ts`` and ``dur`` in microseconds) of
these categories (``cat``):

- device time, recorded by CUPTI on the card's clock: ``kernel`` (a
  kernel, by its demangled name), ``gpu_memcpy`` and ``gpu_memset``;
- host time: ``cpu_op`` (an ATen operator), ``cuda_runtime`` and
  ``cuda_driver`` (the host's CUDA API calls, a launch among them),
  ``python_function``, ``user_annotation``;
- neither: ``gpu_user_annotation`` (a host range drawn over the device's
  timeline, which would count its kernels twice), ``ac2g`` flow arrows
  and the ``Trace`` span of the whole capture.

The device plane, when the trace has any device event, is what is
summed: ``plane`` then reads ``"/device:gpu (kernel, gpu_memcpy,
gpu_memset)"``. Only a trace with no device event (a CPU run) is
summarised over its host operators, ``plane`` ``"/host:cpu (cpu_op)"``:
the counterpart of ``xplane._pick_plane``, which falls back to the
busiest plane. ATen operators nest (``aten::linear`` holds
``aten::addmm``), so each is counted by its self time, its duration less
that of the operators directly inside it on its thread: the plane's
total is then the time under its outermost operators, each microsecond
counted once, as XLA's per-op line counts it. Host operators are never
added to device time: a kernel's launch and the kernel are the same work
seen from both sides.

Matmul work is recognised by the card's kernel names, not XLA's op
names: cuBLAS and CUTLASS GEMMs (``gemm``, ``cutlass``, ``xmma``,
``cublas``; cuBLAS 12.8 names most of its Hopper GEMMs ``nvjet_*``,
which contain no "gemm") and cuDNN's convolutions (``implicit_gemm``,
``fprop``, ``dgrad``, ``wgrad``, ``convolution``, ``conv2d``,
``winograd``; not a bare "conv", which matches "convert"). On the host
plane the ATen operators of the same work are matched by name
(``aten::mm``, ``aten::addmm``, ``aten::bmm``, ``aten::linear``,
``aten::convolution``, ...).

The port's flash kernels (``rtt::flash_fwd_kernel``,
``rtt::flash_bwd_dq_kernel``, ``rtt::flash_bwd_dkv_kernel``) fall on the
non-matmul side, and a test pins it. Their names carry no marker, as the
JAX package's Pallas attention custom calls carry none of
``MATMUL_MARKERS``: attention is its own line of the breakdown, read from
``top_non_matmul``, and the matmul share stays that of the projections,
the MLP and the head, which is what an achievable-matmul probe is held
against.
"""

from __future__ import annotations

import glob
import json
import os

__all__ = [
    "trace_files", "summarize_trace", "classify_event", "DEVICE_CATEGORIES",
    "HOST_CATEGORIES", "MATMUL_MARKERS", "HOST_MATMUL_MARKERS",
]

# Device time: what CUPTI records on the card (key_averages' device total
# counts the same events).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The host plane summed when the trace has no device event: ATen ops
# (their runtime calls and Python frames are nested inside them).
HOST_CATEGORIES = ("cpu_op",)

MATMUL_MARKERS = ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                  "implicit_gemm", "fprop", "dgrad", "wgrad", "convolution",
                  "conv2d", "winograd")
HOST_MATMUL_MARKERS = ("aten::mm", "aten::addmm", "aten::bmm",
                       "aten::baddbmm", "aten::matmul", "aten::linear",
                       "aten::einsum", "aten::convolution",
                       "aten::_convolution", "aten::conv1d", "aten::conv2d",
                       "aten::conv3d", "aten::mkldnn_convolution",
                       "aten::cudnn_convolution")


def trace_files(logdir: str) -> list[str]:
    """Every torch.profiler Chrome trace under ``logdir``."""
    return sorted(glob.glob(os.path.join(logdir, "**", "trace_*.json"),
                            recursive=True))


def classify_event(name: str, category: str = "kernel") -> bool:
    """True when the event is matmul work: a device kernel by the card's
    kernel-name markers, a host operator by its ATen name."""
    low = name.lower()
    if category in HOST_CATEGORIES:
        return low in HOST_MATMUL_MARKERS
    return any(m in low for m in MATMUL_MARKERS)


def _events(path: str) -> list[dict]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _self_times(events: list[dict]) -> list[float]:
    """Each event's duration less that of the events directly inside it
    on the same thread (host operators nest; device kernels do not)."""
    out = [float(e["dur"]) for e in events]
    threads: dict[tuple, list[int]] = {}
    for i, e in enumerate(events):
        threads.setdefault((e.get("pid"), e.get("tid")), []).append(i)
    for idx in threads.values():
        idx.sort(key=lambda i: (float(events[i]["ts"]),
                                -float(events[i]["dur"])))
        stack: list[tuple[int, float]] = []   # (index, end)
        for i in idx:
            ts = float(events[i]["ts"])
            while stack and ts >= stack[-1][1]:
                stack.pop()
            if stack:
                out[stack[-1][0]] -= float(events[i]["dur"])
            stack.append((i, ts + float(events[i]["dur"])))
    return out


def summarize_trace(logdir: str, top_k: int = 5, steps: int = 1) -> dict:
    """Aggregate the captures under ``logdir`` into the slice breakdown.

    Returns ``{"plane", "files", "total_ms", "ms_per_step", "matmul_ms",
    "non_matmul_ms", "matmul_share", "top_non_matmul": [{"name", "ms",
    "share"}...], "top_matmul": [...]}``, as ``xplane.summarize_trace``
    does. Raises ValueError when ``logdir`` holds no trace, or no event
    to sum."""
    files = trace_files(logdir)
    if not files:
        raise ValueError(f"no torch.profiler traces under {logdir}")
    per_file = [_events(p) for p in files]
    device = any(e.get("cat") in DEVICE_CATEGORIES
                 for events in per_file for e in events)
    cats = DEVICE_CATEGORIES if device else HOST_CATEGORIES
    plane = (f"/device:gpu ({', '.join(cats)})" if device
             else f"/host:cpu ({', '.join(cats)})")
    agg: dict[str, list] = {}   # name -> [total_us, is_matmul]
    for events in per_file:
        picked = [e for e in events if e.get("cat") in cats]
        times = ([float(e["dur"]) for e in picked] if device
                 else _self_times(picked))
        for ev, us in zip(picked, times):
            cat = ev["cat"]
            name = ev.get("name") or f"<{cat}>"
            cell = agg.setdefault(name, [0.0, classify_event(name, cat)])
            cell[0] += us
    if not agg:
        raise ValueError(f"traces under {logdir} carry no events to sum")
    total_us = sum(v[0] for v in agg.values())
    mm_us = sum(v[0] for v in agg.values() if v[1])

    def rows(matmul: bool):
        items = sorted(
            ((n, v[0]) for n, v in agg.items() if v[1] == matmul),
            key=lambda kv: kv[1], reverse=True)[:top_k]
        return [{"name": n[:120],
                 "ms": round(us / 1e3 / max(1, steps), 3),
                 "share": round(us / max(1e-9, total_us), 4)}
                for n, us in items]

    return {
        "plane": plane,
        "files": len(files),
        "total_ms": round(total_us / 1e3, 3),
        "ms_per_step": round(total_us / 1e3 / max(1, steps), 3),
        "matmul_ms": round(mm_us / 1e3, 3),
        "non_matmul_ms": round((total_us - mm_us) / 1e3, 3),
        "matmul_share": round(mm_us / max(1e-9, total_us), 4),
        "top_non_matmul": rows(False),
        "top_matmul": rows(True),
    }
