"""``ray-tpu`` command line interface of the port (counterpart of
``ray_tpu/scripts/cli.py``; reference: python/ray/scripts/scripts.py,
``ray status|list|job``...).

The runtime is driver-embedded, so cluster commands attach to a live
session's unix socket (``ray_tpu_torch_sessions/<pid>/runtime.sock`` in
the temporary directory, the root ``init(address="auto")`` searches,
never the JAX package's ``ray_tpu_sessions``) using the same client
protocol worker processes use; ``job submit`` attaches to that session,
or starts one, and supervises the entrypoint. The CLI is host code and
imports no torch, apart from ``doctor``, which reports the card.

``start --head --num-gpus N`` runs the head daemon holding N cards of
this host (the first N entries of ``CUDA_VISIBLE_DEVICES``, or 0..N-1);
``start --address`` joins a node daemon, whose cards follow the same
rule on its own host.

Usage:
    python -m ray_tpu_torch.scripts.cli status [--address PATH]
    python -m ray_tpu_torch.scripts.cli memory [--top 20]
    python -m ray_tpu_torch.scripts.cli stack [head|<node-id>|pid:<n>]
    python -m ray_tpu_torch.scripts.cli profile [--duration 5] [-o out.json]
    python -m ray_tpu_torch.scripts.cli list {tasks,actors,nodes,objects,pgs}
    python -m ray_tpu_torch.scripts.cli summary
    python -m ray_tpu_torch.scripts.cli timeline --output trace.json
    python -m ray_tpu_torch.scripts.cli metrics
    python -m ray_tpu_torch.scripts.cli logs worker-0.log --follow
    python -m ray_tpu_torch.scripts.cli doctor
    python -m ray_tpu_torch.scripts.cli job submit -- python train.py
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import sys
import threading


def _session_root() -> str:
    from ray_tpu_torch.core.runtime import session_root
    return session_root()


def _default_head_info() -> str:
    from ray_tpu_torch.core.config import temp_path
    return temp_path("ray_tpu_torch_head.json")


def _discover_address(explicit: str | None) -> str:
    if explicit:
        return explicit
    root = _session_root()
    candidates = sorted(glob.glob(f"{root}/*/runtime.sock"),
                        key=os.path.getmtime, reverse=True)
    for path in candidates:
        # A session directory is named by its head's pid: a killed
        # head's leftover socket is passed over, not dialled.
        pid = os.path.basename(os.path.dirname(path))
        if os.path.exists(path) and os.path.exists(f"/proc/{pid}"):
            return path
    raise SystemExit(
        f"no live ray_tpu_torch session found under {root}; pass "
        "--address /path/to/runtime.sock")


class _Client:
    """Minimal state client over the worker client protocol."""

    def __init__(self, address: str):
        from ray_tpu_torch.core import wire
        # Deadline-bounded dial: a dead session's leftover socket
        # file must fail fast with the peer named, not hang the CLI.
        self._conn = wire.dial(address, family="AF_UNIX",
                               kind=wire.K_CLIENT,
                               peer=f"head at {address}")
        self._conn.send(("hello", "client", ""))
        self._req = itertools.count()
        self._lock = threading.Lock()

    def call(self, op: str, payload):
        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core import serialization as ser
        req_id = next(self._req)
        with self._lock:
            self._conn.send((req_id, op, payload))
            rid, status, result = self._conn.recv()
        if status == P.ST_ERR:
            raise ser.loads(result)
        return result

    def state(self, kind: str, filters=None):
        from ray_tpu_torch.core import protocol as P
        return self.call(P.OP_STATE, (kind, filters))


def _cmd_status(args) -> int:
    """``ray_tpu status`` (reference: ray status): per-node resource
    usage + drain state, task/actor/worker counts, and pending
    autoscaler demand — the cluster_status OP_STATE verb rendered."""
    c = _Client(_discover_address(args.address))
    cs = c.state("cluster_status")
    if args.json:
        print(json.dumps(cs, indent=2, default=str))
        return 0
    from ray_tpu_torch.observability.introspect import format_cluster_status
    sys.stdout.write(format_cluster_status(cs))
    return 0


def _cmd_alerts(args) -> int:
    """``ray_tpu alerts``: last SLO burn-rate evaluation from the
    head signals plane — every rule with its state (OK/WARN/PAGE),
    the fast/slow burn rates, and the deciding signal values. Exit
    code escalates with the worst state: 0 OK, 1 WARN, 2 PAGE."""
    c = _Client(_discover_address(args.address))
    payload = c.state("alerts")
    if args.json:
        print(json.dumps(payload, indent=2, default=str))
    else:
        alerts = payload.get("alerts") or []
        sig = payload.get("signals") or {}
        print(f"slo rules: {len(alerts)}  evals: "
              f"{payload.get('evals', 0)}  signal series: "
              f"{sig.get('series', 0)}  samples: "
              f"{sig.get('samples_taken', 0)}")
        if not alerts:
            print("no SLO rules evaluated yet (signals plane "
                  "warming up or disabled)")
        for a in alerts:
            tags = a.get("tags") or {}
            tag_s = ("{" + ",".join(f"{k}={v}" for k, v
                                    in sorted(tags.items())) + "}"
                     if tags else "")
            if a.get("no_data"):
                detail = "no data"
            else:
                vf = a.get("value_fast")
                vf_s = f"{vf:.4g}" if vf is not None else "n/a"
                detail = (f"burn fast={a['burn_fast']:.2f} "
                          f"slow={a['burn_slow']:.2f} "
                          f"value={vf_s} target={a['target']:.4g}")
            print(f"  [{a['state']:4s}] {a['rule']}{tag_s} "
                  f"({a['kind']}:{a['signal']}) {detail}")
    worst = {s.get("state") for s in (payload.get("alerts") or [])}
    if "PAGE" in worst:
        return 2
    if "WARN" in worst:
        return 1
    return 0


def _cmd_memory(args) -> int:
    """``ray_tpu memory`` (reference: ray memory): per-node object
    store usage and the top-N objects by size with owner/ref-count/
    pin/spill state."""
    c = _Client(_discover_address(args.address))
    ms = c.state("memory_summary", {"top_n": args.top})
    if args.json:
        print(json.dumps(ms, indent=2, default=str))
        return 0
    from ray_tpu_torch.observability.introspect import format_memory_summary
    sys.stdout.write(format_memory_summary(ms))
    return 0


def _cmd_stack(args) -> int:
    """``ray_tpu stack [target]`` (reference: ray stack): dump the
    current Python stacks of matching cluster processes — head,
    node daemons, workers. target: "head", a node-id prefix, or
    "pid:<n>" (default: every process)."""
    from ray_tpu_torch.core import protocol as P
    c = _Client(_discover_address(args.address))
    rows = c.call(P.OP_PROFILE, ("stack", {"target": args.target}))
    for r in rows:
        hdr = (f"==== {r['kind']} {r['node_id'][:16]} "
               f"pid={r['pid']} ====")
        print(hdr)
        if r["ok"]:
            sys.stdout.write(r["stacks"])
        else:
            print(f"  <error: {r.get('error', 'unknown')}>")
    if not rows:
        print("no matching processes")
        return 1
    return 0


def _cmd_profile(args) -> int:
    """``ray_tpu profile``: sample stacks across the cluster for
    --duration at --hz, merge into one flame graph, and write
    speedscope JSON (open at https://www.speedscope.app) or collapsed
    stacks (any flamegraph renderer)."""
    from ray_tpu_torch.core import protocol as P
    from ray_tpu_torch.observability import profiler as prof
    c = _Client(_discover_address(args.address))
    res = c.call(P.OP_PROFILE, ("capture", {
        "duration_s": args.duration, "hz": args.hz,
        "target": args.target}))
    ok = [p for p in res["procs"] if p["ok"]]
    bad = [p for p in res["procs"] if not p["ok"]]
    if args.format == "collapsed":
        out = prof.collapsed_text(res["collapsed"])
    else:
        profiles = [("cluster (merged)", res["collapsed"],
                     res["hz"])]
        profiles += [
            (f"{p['kind']} {p['node_id'][:12]} pid{p['pid']}",
             p.get("collapsed", {}), res["hz"])
            for p in ok]
        out = json.dumps(prof.to_speedscope(
            profiles, name="ray_tpu cluster profile"))
    with open(args.output, "w") as f:
        f.write(out)
    print(f"sampled {len(ok)} process(es) for {res['duration_s']}s "
          f"at {res['hz']:g} Hz -> {args.output} ({args.format})")
    for p in bad:
        print(f"  failed: {p['kind']} {p['node_id'][:12]} "
              f"pid={p['pid']}: {p.get('error', '')}",
              file=sys.stderr)
    return 0 if ok else 1


def _cmd_list(args) -> int:
    kind = {"pgs": "placement_groups"}.get(args.kind, args.kind)
    c = _Client(_discover_address(args.address))
    rows = c.state(kind)
    print(json.dumps(rows, indent=2, default=str))
    return 0


def _cmd_summary(args) -> int:
    c = _Client(_discover_address(args.address))
    print(json.dumps(c.state("summary"), indent=2, default=str))
    return 0


def _render_trace(t: dict) -> str:
    """Text rendering of one assembled trace tree: the span tree with
    per-span total/self times, then the critical path."""
    lines = [
        f"trace {t['trace_id']}  root={t['root']['name']}  "
        f"{t['duration_ms']:.1f} ms  spans={t['num_spans']}  "
        f"complete={t['complete']}"
        + (f"  errors={len(t['errors'])}" if t["errors"] else "")]

    def walk(node: dict, depth: int) -> None:
        attrs = node.get("attributes") or {}
        extra = ""
        if attrs.get("error"):
            extra += f"  error={attrs['error']}"
        if attrs.get("verdict"):
            extra += f"  verdict={attrs['verdict']}"
        if attrs.get("orphan"):
            extra += "  (orphan)"
        lines.append(
            f"  {'  ' * depth}{node['name']}  "
            f"{node['duration_ms']:.1f} ms "
            f"(self {node['self_time_ms']:.1f} ms)  "
            f"[{node.get('process', '')}]" + extra)
        for k in node.get("children", ()):
            walk(k, depth + 1)

    walk(t["tree"], 0)
    lines.append(f"critical path "
                 f"({t['critical_path_self_ms']:.1f} ms self):")
    for p in t["critical_path"]:
        lines.append(f"  {p['name']}  self {p['self_time_ms']:.1f} ms"
                     f"  [{p['process']}]")
    return "\n".join(lines) + "\n"


def _cmd_trace(args) -> int:
    """``ray_tpu trace <id>``: one assembled trace tree from the head
    TraceStore — span tree, per-span self-times, critical path.
    --format chrome|perfetto writes viewer JSON to --output."""
    c = _Client(_discover_address(args.address))
    if args.format:
        events = c.state("trace_export",
                         {"trace_id": args.trace_id,
                          "format": args.format})
        if events is None:
            print(f"unknown trace {args.trace_id}", file=sys.stderr)
            return 1
        out = args.output or f"trace-{args.trace_id}.json"
        with open(out, "w") as f:
            json.dump(events, f)
        print(f"wrote {args.format} trace to {out}")
        return 0
    t = c.state("trace", {"trace_id": args.trace_id})
    if t is None:
        print(f"unknown trace {args.trace_id} (expired, sampled "
              f"out, or never traced)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(t, indent=2, default=str))
        return 0
    sys.stdout.write(_render_trace(t))
    return 0


def _cmd_traces(args) -> int:
    """``ray_tpu traces``: assembled-trace summaries, newest first
    (--slowest ranks by duration instead)."""
    c = _Client(_discover_address(args.address))
    rows = c.state("traces", {"limit": args.limit,
                              "slowest": args.slowest})
    if args.json:
        print(json.dumps(rows, indent=2, default=str))
        return 0
    if not rows:
        print("no traces (is tracing enabled? see "
              "docs/observability.md)")
        return 0
    print(f"{'trace_id':17} {'duration_ms':>12} {'spans':>6} "
          f"{'errs':>5} {'done':>5}  root")
    for r in rows:
        print(f"{r['trace_id']:17} {r['duration_ms']:>12.1f} "
              f"{r['num_spans']:>6} {len(r['errors']):>5} "
              f"{str(r['complete']):>5}  {r['root']}")
    return 0


def _cmd_timeline(args) -> int:
    c = _Client(_discover_address(args.address))
    events = c.state("timeline")
    with open(args.output, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {args.output} "
          f"(chrome://tracing format)")
    return 0


def _cmd_metrics(args) -> int:
    """Cluster-aggregated Prometheus dump: scrape the dashboard when
    --url is given, else pull the same text from the live session's
    head over the client protocol. --local keeps the old behavior
    (this process's own registry) for headless use."""
    if args.local:
        from ray_tpu_torch.util.metrics import (
            local_quantile_lines,
            prometheus_text,
        )
        sys.stdout.write(prometheus_text())
        # p50/p95/p99 per histogram series (bucket→quantile
        # interpolation; the cluster path renders these head-side).
        q = local_quantile_lines()
        if q:
            sys.stdout.write("\n".join(q) + "\n")
        return 0
    if args.url:
        import urllib.request
        url = args.url.rstrip("/")
        if not url.endswith("/metrics"):
            url += "/metrics"
        sys.stdout.write(urllib.request.urlopen(
            url, timeout=30).read().decode())
        return 0
    try:
        address = _discover_address(args.address)
    except SystemExit:
        raise SystemExit(
            "no live ray_tpu_torch session found; pass --address, --url "
            "(dashboard), or --local for this process's registry")
    c = _Client(address)
    sys.stdout.write(c.state("cluster_metrics"))
    return 0


def _cmd_logs(args) -> int:
    """List or tail worker log files of the target session (shares
    the list/tail implementation with the dashboard's /api/logs)."""
    from ray_tpu_torch.util.logdir import list_log_files, tail_log_file

    address = _discover_address(args.address)
    log_dir = os.path.join(os.path.dirname(address), "logs")
    if not os.path.isdir(log_dir):
        print("no logs directory for this session")
        return 1
    if args.file:
        # CLI semantics: --tail-bytes 0 = the WHOLE file; no implicit
        # size cap (the 1 MiB default bound is for the HTTP viewer).
        want = args.tail_bytes if args.tail_bytes else (1 << 62)
        out = tail_log_file(log_dir, args.file, want,
                            max_bytes=1 << 62)
        if out.get("error"):
            print(f"no such log file: {args.file} "
                  f"(run `logs` with no argument to list)")
            return 1
        sys.stdout.write(out["content"])
        if args.follow:
            # Byte-offset incremental tailing (tail -f): each poll
            # reads only what appended since the last one, so a
            # long-running training log is never re-downloaded.
            import time as _time
            offset = out.get("offset", 0)
            try:
                while True:
                    _time.sleep(max(0.1, args.poll_interval))
                    out = tail_log_file(log_dir, args.file,
                                        max_bytes=1 << 62,
                                        offset=offset)
                    if out.get("error"):
                        return 1
                    if out["content"]:
                        sys.stdout.write(out["content"])
                        sys.stdout.flush()
                    offset = out.get("offset", offset)
            except KeyboardInterrupt:
                return 0
        if out.get("truncated"):
            print(f"\n[truncated to last {want} bytes; use "
                  f"--tail-bytes 0 for the whole file]",
                  file=sys.stderr)
        return 0
    for n in list_log_files(log_dir):
        size = os.path.getsize(os.path.join(log_dir, n))
        print(f"{n}\t{size} bytes")
    return 0


def _cmd_usage(args) -> int:
    """Print the local usage summary (never transmitted)."""
    address = _discover_address(args.address)
    path = os.path.join(os.path.dirname(address), "usage.json")
    if os.path.exists(path):
        print(open(path).read())
        return 0
    print("no usage.json written yet for this session")
    return 1


def _write_head_info(path: str, info: dict) -> None:
    """Token inside: owner-only (0600 enforced via fchmod on OUR fd,
    so a pre-existing world-readable file can't keep its mode) and
    ATOMIC (temp + rename — pollers never observe a half-written
    JSON)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL
                 | getattr(os, "O_NOFOLLOW", 0), 0o600)
    try:
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(info, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _cmd_start(args) -> int:
    """``ray-tpu start --head`` / ``--address`` (reference: ray start,
    scripts.py — the manual-deployment pair to ``up``'s providers).

    --head runs the standalone head daemon (core/head.py run_head —
    fixed port, 0.0.0.0 bind, optional restart journal) in THIS
    process (foreground; Ctrl-C / SIGTERM shuts down cleanly) and
    writes a head-info file (client socket, TCP join address, cluster
    token — 0600, atomic) that node joins and clients discover.
    --address joins this machine to that head as a node daemon
    (foreground)."""
    import signal

    if args.head:
        import secrets

        from ray_tpu_torch.core.head import run_head
        token_hex = os.environ.get("RAY_TPU_CLUSTER_TOKEN") \
            or secrets.token_hex(16)
        rt, stop = run_head(
            args.port, bytes.fromhex(token_hex),
            num_cpus=args.num_cpus, num_gpus=args.num_gpus,
            journal_dir=args.journal or None,
            host=args.host)
        if args.dashboard:
            from ray_tpu_torch.dashboard.head import start_dashboard
            rt._dashboard = start_dashboard(port=args.dashboard_port)
        path = args.head_info_file or _default_head_info()
        _write_head_info(path, {
            "client_address": rt.client_address,
            "tcp_address": f"{args.host}:{args.port}",
            "token": token_hex,
            "pid": os.getpid(),
        })
        print(f"head up. clients: init(address="
              f"{rt.client_address!r})  |  join a node:\n"
              f"  ray-tpu start --address {args.host}:{args.port} "
              f"--head-info-file {path}", flush=True)
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        try:
            while not stop.is_set():
                stop.wait(1.0)
        except KeyboardInterrupt:
            pass
        try:
            os.unlink(path)
        except OSError:
            pass
        from ray_tpu_torch.core import api as _api
        _api.shutdown()
        return 0

    if not args.address:
        raise SystemExit("pass --head or --address HOST:PORT")
    token = os.environ.get("RAY_TPU_CLUSTER_TOKEN")
    info_file = args.head_info_file or _default_head_info()
    if not token and os.path.exists(info_file):
        with open(info_file) as f:
            token = json.load(f).get("token")
    if not token:
        raise SystemExit(
            "joining needs the cluster token: RAY_TPU_CLUSTER_TOKEN "
            "env or --head-info-file written by `start --head`")
    env = dict(os.environ)
    env["RAY_TPU_CLUSTER_TOKEN"] = token
    import subprocess
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.node_daemon",
           "--address", args.address,
           "--resources", json.dumps({}),
           "--labels", json.dumps({})]
    # only forward what the operator set: the daemon autodetects
    # cpus (and str(None) would crash its float parser)
    if args.num_cpus is not None:
        cmd += ["--num-cpus", str(args.num_cpus)]
    if args.num_gpus is not None:
        cmd += ["--num-gpus", str(args.num_gpus)]
    return subprocess.call(cmd, env=env)


def _cmd_stop(args) -> int:
    """``ray-tpu stop`` (reference: ray stop): SIGTERM every live
    session head found under the port's session root (graceful —
    daemons/workers shut down with their head). With
    ``--head-info-file``, stop ONLY the head that wrote that file —
    the targeted form for hosts running unrelated sessions."""
    import signal

    only_pid = None
    if args.head_info_file:
        try:
            with open(args.head_info_file) as f:
                only_pid = int(json.load(f)["pid"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise SystemExit(
                f"cannot read head pid from "
                f"{args.head_info_file}: {e}")
    stopped = 0
    for sock in glob.glob(f"{_session_root()}/*/runtime.sock"):
        pid_s = os.path.basename(os.path.dirname(sock))
        try:
            pid = int(pid_s)
        except ValueError:
            continue
        if pid == os.getpid():
            continue
        if only_pid is not None and pid != only_pid:
            continue
        # Stale-dir guard against pid recycling: only signal a LIVE
        # python process (a SIGKILLed head leaves its session dir;
        # the recycled pid could be anything).
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if b"python" not in cmdline:
            print(f"skipping {pid}: not a python process "
                  f"(stale session dir?)", file=sys.stderr)
            continue
        try:
            os.kill(pid, signal.SIGTERM)
            stopped += 1
            print(f"stopped session head {pid}")
        except ProcessLookupError:
            pass
        except PermissionError:
            print(f"no permission to stop {pid}", file=sys.stderr)
    print(f"{stopped} session(s) signaled")
    return 0


def _cmd_doctor(args) -> int:
    """Environment checks: the package, torch and CUDA, the card as
    ``nvidia-smi`` reports it, whether the CUDA kernels are built, and
    the native store. Fails nothing when no card is visible, and says
    so."""
    import shutil
    import subprocess
    import ray_tpu_torch
    print("== ray_tpu_torch doctor ==")
    print(f"ray_tpu_torch {ray_tpu_torch.__version__}")
    try:
        import torch
        print(f"torch {torch.__version__}; CUDA {torch.version.cuda}; "
              f"cards visible: {torch.cuda.device_count()}")
        for i in range(torch.cuda.device_count()):
            print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
    except Exception as e:  # noqa: BLE001
        print(f"torch unavailable: {e}")
    smi = shutil.which("nvidia-smi")
    if smi is None:
        print("card: no nvidia-smi on PATH (no card visible)")
    else:
        r = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            print(f"card: nvidia-smi found no card (exit {r.returncode})")
        for line in lines:
            print(f"card: {line.strip()}")
    from ray_tpu_torch.ops.cuda import build
    stale = [n for n, src in build.sources().items()
             if build._stale(n, src)]
    print(f"CUDA kernels: "
          + ("built" if not stale else f"not built ({', '.join(stale)}; "
             "built by nvcc at first use on a card)")
          + f" under {build.BUILD_DIR}")
    from ray_tpu_torch.native.store import native_store_available
    print(f"native C++ store: "
          f"{'ok' if native_store_available() else 'UNAVAILABLE'}")
    from ray_tpu_torch.core.accelerator import detect_gpu_count
    print(f"gpus detected: {detect_gpu_count()}")
    return 0


def _cmd_job_submit(args) -> int:
    import ray_tpu_torch
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient
    # Attach to a live session when one exists (or --address says so):
    # jobs submitted here stay visible to `job list/status/logs` runs
    # against that session. A fresh private session (the old always-on
    # behavior) is the fallback when nothing is running.
    try:
        addr = _discover_address(getattr(args, "address", None))
        ray_tpu_torch.init(address=addr)
    except SystemExit:
        ray_tpu_torch.init(ignore_reinit_error=True)
    client = JobSubmissionClient()
    entrypoint = " ".join(args.entrypoint)
    runtime_env = {}
    if args.working_dir:
        runtime_env["working_dir"] = args.working_dir
    sid = client.submit_job(entrypoint=entrypoint,
                            runtime_env=runtime_env or None)
    print(f"submitted job {sid}: {entrypoint!r}")
    if args.no_wait:
        return 0
    status = client.wait_until_finished(sid, timeout=args.timeout)
    sys.stdout.write(client.get_job_logs(sid))
    print(f"job {sid} finished: {status}")
    return 0 if status == JobStatus.SUCCEEDED else 1


def _job_client(args):
    """Attach to the session the job table lives in (same discovery
    as every other cluster command)."""
    import ray_tpu_torch
    from ray_tpu_torch.job_submission import JobSubmissionClient
    addr = _discover_address(getattr(args, "address", None))
    ray_tpu_torch.init(address=addr)
    return JobSubmissionClient()


def _cmd_job_list(args) -> int:
    client = _job_client(args)
    rows = client.list_jobs()
    for info in rows:
        print(f"{info.submission_id}  {info.status:<10} "
              f"{info.entrypoint}")
    if not rows:
        print("(no jobs)")
    return 0


def _cmd_job_status(args) -> int:
    client = _job_client(args)
    print(client.get_job_status(args.submission_id))
    return 0


def _cmd_job_stop(args) -> int:
    client = _job_client(args)
    ok = client.stop_job(args.submission_id)
    print("stopped" if ok else "not running")
    return 0


def _cmd_job_logs(args) -> int:
    client = _job_client(args)
    sys.stdout.write(client.get_job_logs(args.submission_id))
    return 0


def _cmd_up(args) -> int:
    import signal
    import time as _time

    from ray_tpu_torch.autoscaler import launcher as _launcher

    launcher = _launcher.up(args.config)
    if args.validate:
        # Smoke: provider built, head listening — then a clean down.
        launcher.down()
        print("cluster config validated; brought up and down "
              "cleanly", flush=True)
        return 0
    stop = False

    def _sig(_s, _f):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    while not stop:
        _time.sleep(0.5)
    launcher.down()
    return 0


def _cmd_serve_deploy(args) -> int:
    import ray_tpu_torch
    ray_tpu_torch.init(address=_discover_address(args.address))
    from ray_tpu_torch import serve
    handles = serve.deploy_config(args.config)
    print(f"deployed {len(handles)} application(s): "
          f"{', '.join(sorted(handles))}")
    return 0


def _cmd_serve_status(args) -> int:
    import json as _json

    import ray_tpu_torch
    ray_tpu_torch.init(address=_discover_address(args.address))
    from ray_tpu_torch import serve
    print(_json.dumps(serve.status(), indent=1, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="ray-tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("status", help="cluster resources, nodes, "
                                      "tasks, autoscaler demand")
    p.add_argument("--address", default=None)
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the text rendering")
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser("alerts", help="SLO burn-rate alert states "
                                      "from the head signals plane")
    p.add_argument("--address", default=None)
    p.add_argument("--json", action="store_true",
                   help="raw JSON (rules, burns, signal values)")
    p.set_defaults(fn=_cmd_alerts)

    p = sub.add_parser("memory", help="object-store state debugger "
                                      "(ray memory analog)")
    p.add_argument("--address", default=None)
    p.add_argument("--top", type=int, default=20,
                   help="top-N objects by size (default 20)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_memory)

    p = sub.add_parser("stack", help="dump live Python stacks of "
                                     "cluster processes (ray stack)")
    p.add_argument("target", nargs="?", default=None,
                   help='"head", a node-id prefix, or "pid:<n>" '
                        "(default: all)")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_stack)

    p = sub.add_parser(
        "profile", help="capture a cluster flame graph (remote "
                        "stack sampling)")
    p.add_argument("target", nargs="?", default=None,
                   help="same selector as `stack` (default: all)")
    p.add_argument("--address", default=None)
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--hz", type=float, default=100.0)
    p.add_argument("--format", choices=["speedscope", "collapsed"],
                   default="speedscope")
    p.add_argument("--output", "-o", default="profile.speedscope.json")
    p.set_defaults(fn=_cmd_profile)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("kind", choices=["tasks", "actors", "nodes",
                                    "objects", "placement_groups",
                                    "pgs"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_list)

    p = sub.add_parser("summary", help="task summary by name/state")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_summary)

    p = sub.add_parser("logs", help="list/tail worker logs")
    p.add_argument("file", nargs="?", default="",
                   help="log file name to print (empty = list)")
    p.add_argument("--address", default=None)
    p.add_argument("--tail-bytes", type=int, default=65536)
    p.add_argument("--follow", "-f", action="store_true",
                   help="keep polling for appended bytes "
                        "(incremental, offset-resumed)")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.set_defaults(fn=_cmd_logs)

    p = sub.add_parser("usage", help="print local usage summary")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_usage)

    p = sub.add_parser(
        "trace", help="print one assembled causal trace (span tree, "
                      "self-times, critical path)")
    p.add_argument("trace_id", help="trace id (e.g. from an error "
                                    "response's X-Request-Id join, "
                                    "or `ray-tpu traces`)")
    p.add_argument("--address", default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--format", choices=["chrome", "perfetto"],
                   default=None,
                   help="write viewer JSON instead of text")
    p.add_argument("--output", "-o", default=None,
                   help="output path for --format (default "
                        "trace-<id>.json)")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser(
        "traces", help="list assembled causal traces")
    p.add_argument("--address", default=None)
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--slowest", action="store_true",
                   help="rank by duration (tail-latency triage)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_traces)

    p = sub.add_parser("timeline", help="dump chrome trace")
    p.add_argument("--output", "-o", default="timeline.json")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_timeline)

    p = sub.add_parser(
        "metrics", help="cluster prometheus metrics dump")
    p.add_argument("--address", default=None,
                   help="session socket (default: newest live one)")
    p.add_argument("--url", default=None,
                   help="scrape a dashboard URL instead")
    p.add_argument("--local", action="store_true",
                   help="dump only this process's registry "
                        "(headless fallback)")
    p.set_defaults(fn=_cmd_metrics)

    p = sub.add_parser(
        "start", help="start a standalone head (--head) or join this "
                      "machine to one (--address)")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None,
                   help="head TCP address HOST:PORT to join")
    p.add_argument("--port", type=int, default=6385,
                   help="head TCP port (fixed, so daemons reconnect "
                        "across head restarts)")
    p.add_argument("--host", default="0.0.0.0",
                   help="head TCP bind host")
    p.add_argument("--num-cpus", type=int, default=None)
    p.add_argument("--num-gpus", type=int, default=None,
                   help="cards of this host the head (or node) holds")
    p.add_argument("--journal", default="",
                   help="journal dir: head state survives restarts")
    p.add_argument("--dashboard", action="store_true")
    p.add_argument("--dashboard-port", type=int, default=8265)
    p.add_argument("--head-info-file", default=None,
                   help="default: ray_tpu_torch_head.json in the "
                        "temporary directory")
    p.set_defaults(fn=_cmd_start)

    p = sub.add_parser("stop", help="stop every live session head "
                                    "(or one, via --head-info-file)")
    p.add_argument("--head-info-file", default=None,
                   help="stop only the head that wrote this file")
    p.set_defaults(fn=_cmd_stop)

    p = sub.add_parser("doctor", help="environment checks")
    p.set_defaults(fn=_cmd_doctor)

    p = sub.add_parser(
        "up", help="launch a cluster from a YAML/JSON config "
                   "(reference: ray up, scripts.py:1293)")
    p.add_argument("config", help="cluster config path")
    p.add_argument("--validate", action="store_true",
                   help="bring the cluster up, then immediately "
                        "down (config smoke test)")
    p.set_defaults(fn=_cmd_up)

    pserve = sub.add_parser(
        "serve", help="declarative Serve ops (reference: serve "
                      "deploy/status, serve/scripts.py)")
    ssub = pserve.add_subparsers(dest="servecmd", required=True)
    p = ssub.add_parser("deploy", help="reconcile apps to a YAML "
                                       "config")
    p.add_argument("config", help="serve config YAML path")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_serve_deploy)
    p = ssub.add_parser("status", help="per-deployment replica "
                                       "health")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_serve_status)

    pjob = sub.add_parser("job", help="job submission")
    jsub = pjob.add_subparsers(dest="jobcmd", required=True)
    p = jsub.add_parser("submit")
    p.add_argument("--address", default=None)
    p.add_argument("--working-dir", default=None)
    p.add_argument("--no-wait", action="store_true")
    p.add_argument("--timeout", type=float, default=3600.0)
    p.add_argument("entrypoint", nargs=argparse.REMAINDER,
                   help="command after --")
    p.set_defaults(fn=_cmd_job_submit)
    for sub_name, sub_fn, needs_id in (
            ("list", _cmd_job_list, False),
            ("status", _cmd_job_status, True),
            ("stop", _cmd_job_stop, True),
            ("logs", _cmd_job_logs, True)):
        p = jsub.add_parser(sub_name)
        p.add_argument("--address", default=None)
        if needs_id:
            p.add_argument("submission_id")
        p.set_defaults(fn=sub_fn)

    args = parser.parse_args(argv)
    if getattr(args, "entrypoint", None):
        # strip a leading "--" separator
        if args.entrypoint and args.entrypoint[0] == "--":
            args.entrypoint = args.entrypoint[1:]
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
