"""Shared session log-dir helpers (counterpart of
``ray_tpu/util/logdir.py``): one implementation for a CLI's ``logs``
command (not ported yet: ROADMAP.md §1, item 10) and the dashboard's log
viewer (``/api/logs``); on one node they read the session's ``logs/``
directory."""

from __future__ import annotations

import os

__all__ = ["list_log_files", "tail_log_file"]


def list_log_files(log_dir: str) -> list[str]:
    """Sorted plain files in the session log dir."""
    if not log_dir or not os.path.isdir(log_dir):
        return []
    return sorted(
        f for f in os.listdir(log_dir)
        if os.path.isfile(os.path.join(log_dir, f)))


def tail_log_file(log_dir: str, fname: str,
                  tail_bytes: int = 65536,
                  max_bytes: int = 1 << 20,
                  offset: int | None = None) -> dict:
    """Last ``tail_bytes`` of one log file (clamped to ``max_bytes``
    — the dashboard keeps the 1 MiB default as an HTTP response
    bound; the CLI raises it). ``fname`` is clamped to its basename —
    no traversal out of the session dir.

    ``offset`` enables tail -f-style incremental reads: pass the
    ``offset`` value from the previous reply and only the bytes
    appended since then come back (at most ``max_bytes`` per poll —
    re-poll with the new offset for the rest). An offset past the
    current size means the file was truncated/rotated: the read
    restarts from 0. Returns {file, content, truncated, offset, size}
    or {file, content:"", error}."""
    fname = os.path.basename(fname)
    if not log_dir or not os.path.isdir(log_dir):
        # A falsy dir must NOT degrade to reading the server
        # process's cwd (log capture disabled => no logs, period).
        return {"file": fname, "content": "",
                "error": "log capture is disabled for this session"}
    path = os.path.join(log_dir, fname)
    if not os.path.isfile(path):
        return {"file": fname, "content": "",
                "error": "no such log file"}
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if offset is not None:
            start = max(0, int(offset))
            if start > size:
                start = 0          # truncated/rotated under us
            f.seek(start)
            raw = f.read(max(0, int(max_bytes)))
            return {"file": fname,
                    "content": raw.decode("utf-8", "replace"),
                    "truncated": start + len(raw) < size,
                    "offset": start + len(raw), "size": size}
        tail = min(max(int(tail_bytes), 1), max_bytes)
        f.seek(max(0, size - tail))
        raw = f.read()
    return {"file": fname, "content": raw.decode("utf-8", "replace"),
            "truncated": size > tail,
            # Resume point for --follow-style pollers.
            "offset": size, "size": size}
