"""On-demand in-process stack profiler (the py-spy / ``ray stack``
analog, dependency-free).

Reference (SURVEY §L6): Ray's dashboard profiles a live worker by
attaching py-spy to its pid and rendering a flame graph; ``ray stack``
dumps current stacks. Attaching an external sampler needs ptrace and
a bundled binary, so here every ray_tpu process carries its own
sampler: a thread reads ``sys._current_frames()`` at a configurable
rate for a bounded duration and folds the observed stacks into
collapsed-stack counts (the Brendan-Gregg ``a;b;c 42`` format every
flame-graph renderer eats). The head fans a capture out over existing
control channels — ``srv_req`` pushes down worker client channels,
``ND_CALL profile`` to node daemons — and merges the per-process
results into one cluster flame graph, exportable as collapsed text or
speedscope JSON.

Overhead contract: with no session active the module holds no thread
and costs one attribute read to check (``is_active`` — pinned by
tests/test_perf.py); an active 100 Hz session costs one
``sys._current_frames()`` walk per tick.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

__all__ = [
    "ProfilerBusyError", "is_active", "sample_stacks", "dump_stacks",
    "merge_collapsed", "collapsed_text", "parse_collapsed",
    "to_speedscope", "trigger_device_profile", "device_trace_summary",
    "handle_profile_op",
]


class ProfilerBusyError(RuntimeError):
    """A sampling session is already running in this process."""


# One session per process: overlapping samplers would double the tick
# cost and interleave counts from different requests.
_session_lock = threading.Lock()
_active = False


def is_active() -> bool:
    return _active


def _frame_label(frame) -> str:
    co = frame.f_code
    return (f"{co.co_name} "
            f"({os.path.basename(co.co_filename)}:{co.co_firstlineno})")


def _fold_stack(thread_name: str, frame) -> str:
    """Root-first collapsed stack for one thread's current frame."""
    parts = []
    while frame is not None:
        parts.append(_frame_label(frame))
        frame = frame.f_back
    parts.append(f"thread:{thread_name}")
    parts.reverse()
    return ";".join(parts)


def _thread_names() -> dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def sample_stacks(duration_s: float = 2.0, hz: float = 100.0,
                  **_ignored) -> dict:
    """Sample every thread's stack for ``duration_s`` at ``hz``.

    Returns ``{"collapsed": {stack: count}, "samples", "duration_s",
    "hz", "pid", "threads"}``. Raises :class:`ProfilerBusyError` when
    a session is already active in this process (overlapping sessions
    would corrupt each other's counts)."""
    global _active
    if not _session_lock.acquire(blocking=False):
        raise ProfilerBusyError(
            f"a profile session is already active in pid {os.getpid()}")
    _active = True
    try:
        duration_s = max(0.0, float(duration_s))
        interval = 1.0 / max(1.0, float(hz))
        me = threading.get_ident()
        counts: dict[str, int] = {}
        seen_threads: set[int] = set()
        samples = 0
        start = time.monotonic()
        deadline = start + duration_s
        while True:
            names = _thread_names()
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue        # never profile the sampler itself
                seen_threads.add(ident)
                stack = _fold_stack(names.get(ident, f"t{ident}"),
                                    frame)
                counts[stack] = counts.get(stack, 0) + 1
            samples += 1
            now = time.monotonic()
            if now >= deadline:
                break
            time.sleep(min(interval, deadline - now))
        return {
            "collapsed": counts,
            "samples": samples,
            "duration_s": round(time.monotonic() - start, 4),
            "hz": float(hz),
            "pid": os.getpid(),
            "threads": len(seen_threads),
        }
    finally:
        _active = False
        _session_lock.release()


def dump_stacks() -> str:
    """One formatted snapshot of every thread's current stack (the
    ``ray stack`` analog). No session bookkeeping — a dump is one
    ``sys._current_frames()`` walk."""
    me = threading.get_ident()
    names = _thread_names()
    out = [f"=== pid {os.getpid()} ==="]
    for ident, frame in sorted(sys._current_frames().items()):
        if ident == me:
            continue
        out.append(f"--- thread {names.get(ident, ident)} ---")
        out.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# collapsed-stack merge / export
# ---------------------------------------------------------------------------

def merge_collapsed(dicts, prefix: str = "") -> dict[str, int]:
    """Sum collapsed-stack count dicts; ``prefix`` (e.g. a
    ``node=..;proc=..`` root frame) is prepended to every stack so a
    cluster merge stays attributable per process."""
    out: dict[str, int] = {}
    for d in dicts:
        for stack, n in (d or {}).items():
            key = f"{prefix};{stack}" if prefix else stack
            out[key] = out.get(key, 0) + int(n)
    return out


def collapsed_text(collapsed: dict[str, int]) -> str:
    """Brendan-Gregg folded format: one ``stack count`` line per
    stack, stable order (count desc, then stack) so outputs diff."""
    lines = [f"{stack} {n}" for stack, n in
             sorted(collapsed.items(), key=lambda kv: (-kv[1], kv[0]))]
    return "\n".join(lines) + ("\n" if lines else "")


def parse_collapsed(text: str) -> dict[str, int]:
    out: dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, n = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(n)
        except ValueError:
            continue
    return out


def to_speedscope(profiles, name: str = "ray_tpu profile") -> dict:
    """Speedscope JSON document from ``[(profile_name, collapsed,
    hz), ...]`` (https://www.speedscope.app file-format, type
    "sampled"). Each collapsed count becomes one weighted sample; the
    frame table is shared across profiles so a cluster capture is one
    openable file with a tab per process."""
    frame_index: dict[str, int] = {}
    frames: list[dict] = []

    def fidx(label: str) -> int:
        i = frame_index.get(label)
        if i is None:
            i = len(frames)
            frame_index[label] = i
            frames.append({"name": label})
        return i

    out_profiles = []
    for prof_name, collapsed, hz in profiles:
        weight = 1.0 / max(1.0, float(hz or 1.0))
        samples, weights = [], []
        for stack, n in sorted(collapsed.items()):
            samples.append([fidx(f) for f in stack.split(";") if f])
            weights.append(weight * int(n))
        out_profiles.append({
            "type": "sampled",
            "name": prof_name,
            "unit": "seconds",
            "startValue": 0,
            "endValue": round(sum(weights), 6),
            "samples": samples,
            "weights": weights,
        })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": out_profiles,
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "ray_tpu",
    }


# ---------------------------------------------------------------------------
# TPU-side capture hook
# ---------------------------------------------------------------------------

_device_lock = threading.Lock()


def trigger_device_profile(logdir: str | None = None,
                           duration_s: float = 5.0) -> dict:
    """Start a ``torch.profiler`` trace in THIS process and stop it
    after ``duration_s`` on a background timer — the remote-triggerable
    half of ``util.tracing.profile_device``. Returns immediately; the
    Chrome trace lands in logdir (default: ``ray_tpu_torch_profile`` in
    the temporary directory)."""
    from ray_tpu_torch.core.config import temp_path
    logdir = logdir or temp_path("ray_tpu_torch_profile")
    from ray_tpu_torch.util.tracing import (
        start_device_profile, stop_device_profile,
    )
    if not _device_lock.acquire(blocking=False):
        raise ProfilerBusyError("a device profile capture is already "
                                f"running in pid {os.getpid()}")
    try:
        prof = start_device_profile()
    except BaseException:
        _device_lock.release()
        raise

    def _stop():
        try:
            time.sleep(max(0.05, float(duration_s)))
            try:
                stop_device_profile(prof, logdir)
            except Exception:  # noqa: BLE001 — capture best-effort
                pass
        finally:
            _device_lock.release()

    threading.Thread(target=_stop, daemon=True,
                     name="device_profile_stop").start()
    return {"logdir": logdir, "duration_s": float(duration_s),
            "pid": os.getpid(), "started": True}


def device_trace_summary(logdir: str | None = None,
                         top_k: int = 5, steps: int = 1) -> dict:
    """Slice breakdown of a finished device capture: total / matmul /
    non-matmul ms plus the top-``top_k`` slices each way, read from the
    Chrome traces :func:`trigger_device_profile` (or
    ``util.tracing.stop_device_profile``) wrote (see
    ``observability.chrome_trace``). ``steps`` normalizes ``ms`` figures
    per optimizer step. ``logdir`` defaults to ``ray_tpu_torch_profile``
    in the temporary directory."""
    from ray_tpu_torch.core.config import temp_path
    from ray_tpu_torch.observability.chrome_trace import summarize_trace
    return summarize_trace(logdir or temp_path("ray_tpu_torch_profile"),
                           top_k=top_k, steps=steps)


def handle_profile_op(op: str, args: dict) -> object:
    """Dispatch one remote profile request inside the target process —
    the shared handler behind the worker ``srv_req`` upcall and the
    node daemon's ``ND_CALL profile``."""
    args = dict(args or {})
    if op == "profile":
        return sample_stacks(
            duration_s=args.get("duration_s", 2.0),
            hz=args.get("hz", 100.0))
    if op == "stack":
        return dump_stacks()
    if op == "profile_device":
        return trigger_device_profile(
            logdir=args.get("logdir"),
            duration_s=args.get("duration_s", 5.0))
    if op == "trace_summary":
        return device_trace_summary(
            logdir=args.get("logdir"),
            top_k=args.get("top_k", 5),
            steps=args.get("steps", 1))
    raise ValueError(f"unknown profile op {op!r}")
