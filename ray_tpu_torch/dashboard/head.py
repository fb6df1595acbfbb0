"""Dashboard head: HTTP server over the state API.

Endpoints (reference: dashboard modules python/ray/dashboard/modules/):
  GET /                       minimal HTML overview
  GET /api/cluster            {resources, available, nodes}
  GET /api/nodes|tasks|actors|objects|placement_groups   state rows
  GET /api/summary            task-state counts
  GET /api/timeline           chrome-trace JSON (ray.timeline analog)
  GET /api/spans              tracing spans (util.tracing)
  GET /api/v1/traces          assembled trace summaries (TraceStore)
  GET /api/v1/traces/<id>     one trace tree (?format=chrome|perfetto)
  GET /metrics                Prometheus exposition (util.metrics)
  GET /api/v1/status          cluster_status (ray status analog)
  GET /api/v1/memory          memory_summary (ray memory analog)
  GET /api/v1/stack           live stack dumps (ray stack analog)
  GET /api/v1/profile         remote flame graph (speedscope JSON;
                              ?duration_s=&hz=&target=&format=)
  GET /api/v1/timeseries      head signal store queries (?kind=rate|
                              quantile|sparklines|..., ?name=,
                              ?window=, ?q=, ?deployment=)
  GET /api/v1/alerts          SLO burn-rate alert states
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _json_default(o):
    return str(o)


def _spa_html() -> bytes:
    import os
    path = os.path.join(os.path.dirname(__file__), "static",
                        "app.html")
    with open(path, "rb") as f:
        return f.read()


class _Handler(BaseHTTPRequestHandler):
    runtime = None      # set by Dashboard
    head_agent = None   # NodeAgent sampling the head host

    def log_message(self, *a):       # silence request logging
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, payload) -> None:
        self._send(200, json.dumps(
            payload, default=_json_default).encode())

    def do_GET(self):  # noqa: N802 — http.server API
        from ray_tpu_torch.util import state as state_api
        rt = self.runtime
        path = self.path.split("?")[0].rstrip("/") or "/"
        try:
            if path == "/":
                # Single-page UI over the JSON endpoints (reference:
                # python/ray/dashboard/client/ SPA, scope-reduced to
                # static no-build JS).
                self._send(200, _spa_html(), "text/html")
            elif path == "/simple":
                self._send(200, self._index(), "text/html")
            elif path == "/api/cluster":
                self._send_json({
                    "resources": rt.cluster_resources(),
                    "available": rt.available_resources(),
                    "nodes": rt.nodes(),
                })
            elif path == "/api/nodes":
                self._send_json(state_api.list_nodes())
            elif path == "/api/tasks":
                self._send_json(state_api.list_tasks())
            elif path == "/api/actors":
                self._send_json(state_api.list_actors())
            elif path == "/api/objects":
                self._send_json(state_api.list_objects())
            elif path == "/api/placement_groups":
                self._send_json(state_api.list_placement_groups())
            elif path == "/api/summary":
                self._send_json(state_api.summarize_tasks())
            elif path == "/api/agents":
                # Per-node agent samples (reference: the reporter
                # module feeding dashboard node cards). The head node
                # samples itself on demand.
                self._send_json(self._agent_stats())
            elif path in ("/api/status", "/api/v1/status"):
                # Pull-side state debugger (reference: ray status /
                # the dashboard cluster view).
                self._send_json(rt.cluster_status())
            elif path in ("/api/memory", "/api/v1/memory"):
                self._send_json(rt.memory_summary(
                    top_n=self._qint("top", 20)))
            elif path in ("/api/stack", "/api/v1/stack"):
                self._send_json(rt.stack_dump(
                    target=self._qstr("target")))
            elif path in ("/api/profile", "/api/v1/profile"):
                # On-demand remote flame graph: samples the whole
                # cluster (or ?target=) for ?duration_s at ?hz and
                # returns speedscope JSON (open the response at
                # speedscope.app) or ?format=collapsed text.
                self._profile()
            elif path in ("/api/timeline", "/api/v1/timeline"):
                # Cluster-wide Chrome-trace JSON: head task slices +
                # remote worker execution slices + collected spans
                # (the ray.timeline() surface; load in
                # chrome://tracing or Perfetto).
                self._send_json(rt.timeline())
            elif path == "/api/spans":
                from ray_tpu_torch.util.tracing import get_tracer
                self._send_json(
                    [s.to_dict() for s in get_tracer().get_spans()])
            elif path in ("/api/traces", "/api/v1/traces"):
                # Assembled trace summaries from the head TraceStore
                # (?slowest=1 ranks by duration, ?limit=N).
                self._send_json(rt.list_traces(
                    limit=self._qint("limit", 50),
                    slowest=self._qstr("slowest") in ("1", "true")))
            elif path.startswith(("/api/traces/",
                                  "/api/v1/traces/")):
                # One assembled trace tree; ?format=chrome|perfetto
                # exports viewer JSON (chrome://tracing / Perfetto).
                tid = path.rsplit("/", 1)[-1]
                fmt = self._qstr("format")
                if fmt in ("chrome", "perfetto"):
                    out = rt.observability.export_trace(tid, fmt)
                else:
                    out = rt.get_trace(tid)
                if out is None:
                    self._send(404, json.dumps(
                        {"error": f"unknown trace {tid}"}).encode())
                else:
                    self._send_json(out)
            elif path in ("/api/timeseries", "/api/v1/timeseries"):
                # Head signal store queries: ?kind=rate|delta|avg|
                # latest|quantile|last|sparklines|names plus
                # ?name=, ?window=, ?q=, ?n=, ?points= and an
                # optional ?deployment= tag shorthand.
                spec = {"kind": self._qstr("kind", "names")}
                for key, get in (("name", self._qstr),
                                 ("tag_key", self._qstr)):
                    v = get(key)
                    if v is not None:
                        spec[key] = v
                for key in ("window", "q"):
                    v = self._qstr(key)
                    if v is not None:
                        spec[key] = float(v)
                for key in ("n", "points"):
                    v = self._qstr(key)
                    if v is not None:
                        spec[key] = int(v)
                dep = self._qstr("deployment")
                if dep is not None:
                    spec["tags"] = {"deployment": dep}
                self._send_json(
                    rt.observability.signals.query(spec))
            elif path in ("/api/alerts", "/api/v1/alerts"):
                # SLO burn-rate alert states + signal store health
                # (the CLI's `alerts` payload).
                self._send_json(rt.observability.alerts())
            elif path == "/api/serve/applications":
                from ray_tpu_torch import serve
                self._send_json(serve.status())
            elif path == "/api/logs":
                self._send_json(self._logs())
            elif path == "/api/jobs":
                from ray_tpu_torch.job_submission import JobSubmissionClient
                self._send_json([j.__dict__ for j in
                                 JobSubmissionClient().list_jobs()])
            elif path.startswith("/api/jobs/"):
                from ray_tpu_torch.job_submission import JobSubmissionClient
                parts = path.split("/")
                sid = parts[3]
                client = JobSubmissionClient()
                try:
                    if len(parts) > 4 and parts[4] == "logs":
                        self._send_json(
                            {"logs": client.get_job_logs(sid)})
                    else:
                        self._send_json(
                            client.get_job_info(sid).__dict__)
                except ValueError as e:
                    # Unknown job id is a CLIENT error, not a server
                    # fault (matches the POST path's contract).
                    self._send(404, json.dumps(
                        {"error": str(e)}).encode())
            elif path == "/metrics":
                # Cluster-aggregated Prometheus exposition: remote
                # worker/daemon snapshots (node_id-tagged, stale
                # series of dead/draining nodes dropped) merged with
                # the head's live registry. Falls back to the
                # process-local registry when the runtime has no
                # observability plane (bare scrape without init).
                plane = getattr(rt, "observability", None)
                if plane is not None:
                    text = plane.prometheus_text()
                else:
                    from ray_tpu_torch.util.metrics import prometheus_text
                    text = prometheus_text()
                self._send(200, text.encode(),
                           "text/plain; version=0.0.4")
            else:
                self._send(404, b'{"error": "not found"}')
        except Exception as e:  # noqa: BLE001
            self._send(500, json.dumps({"error": str(e)}).encode())

    def do_POST(self):  # noqa: N802 — http.server API
        """Job REST API (reference: the dashboard job module's REST
        endpoints backing JobSubmissionClient): POST /api/jobs
        {entrypoint, runtime_env?, metadata?, submission_id?}
        submits; POST /api/jobs/<id>/stop stops."""
        path = self.path.split("?")[0].rstrip("/")
        try:
            from ray_tpu_torch.job_submission import JobSubmissionClient
            client = JobSubmissionClient()
            if path == "/api/jobs":
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict) or \
                        not body.get("entrypoint"):
                    self._send(400, json.dumps(
                        {"error": "body must be a JSON object with "
                                  "an 'entrypoint'"}).encode())
                    return
                sid = client.submit_job(
                    entrypoint=body["entrypoint"],
                    runtime_env=body.get("runtime_env"),
                    metadata=body.get("metadata"),
                    submission_id=body.get("submission_id"))
                self._send_json({"submission_id": sid})
                return
            parts = path.split("/")
            if (len(parts) == 5 and parts[1] == "api"
                    and parts[2] == "jobs" and parts[4] == "stop"):
                try:
                    self._send_json(
                        {"stopped": client.stop_job(parts[3])})
                except ValueError as e:
                    # Unknown id -> 404, same contract as GET.
                    self._send(404, json.dumps(
                        {"error": str(e)}).encode())
                return
            self._send(404, b'{"error": "not found"}')
        except ValueError as e:
            self._send(400, json.dumps({"error": str(e)}).encode())
        except Exception as e:  # noqa: BLE001
            self._send(500, json.dumps({"error": str(e)}).encode())

    def do_PUT(self):  # noqa: N802 — http.server API
        """REST deploy (reference: the Serve REST API's
        PUT /api/serve/applications/ consuming ServeDeploySchema):
        body = the declarative config JSON; reconciles apps exactly
        like `serve deploy config.yaml`."""
        path = self.path.split("?")[0].rstrip("/")
        if path != "/api/serve/applications":
            self._send(404, b'{"error": "not found"}')
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            from ray_tpu_torch import serve
            handles = serve.deploy_config(body)
            self._send_json({"deployed": sorted(handles)})
        except (ValueError, TypeError) as e:
            # Both are client-input errors: schema violations raise
            # ValueError, a non-mapping body (JSON array/string)
            # raises TypeError from deploy_config.
            self._send(400, json.dumps({"error": str(e)}).encode())
        except Exception as e:  # noqa: BLE001
            self._send(500, json.dumps({"error": str(e)}).encode())

    def _query(self) -> dict:
        from urllib.parse import parse_qs, urlparse
        return parse_qs(urlparse(self.path).query)

    def _qstr(self, key: str, default=None):
        return self._query().get(key, [default])[0]

    def _qint(self, key: str, default: int) -> int:
        try:
            return int(self._query().get(key, [default])[0])
        except (TypeError, ValueError):
            return default

    def _qfloat(self, key: str, default: float) -> float:
        try:
            return float(self._query().get(key, [default])[0])
        except (TypeError, ValueError):
            return default

    def _profile(self) -> None:
        from ray_tpu_torch.observability import profiler as prof
        res = self.runtime.profile_cluster(
            duration_s=min(120.0, self._qfloat("duration_s", 5.0)),
            hz=min(1000.0, self._qfloat("hz", 100.0)),
            target=self._qstr("target"))
        if self._qstr("format") == "collapsed":
            self._send(200,
                       prof.collapsed_text(res["collapsed"]).encode(),
                       "text/plain")
            return
        profiles = [("cluster (merged)", res["collapsed"],
                     res["hz"])]
        profiles += [
            (f"{p['kind']} {p['node_id'][:12]} pid{p['pid']}",
             p.get("collapsed", {}), res["hz"])
            for p in res["procs"] if p["ok"]]
        self._send_json(prof.to_speedscope(
            profiles, name="ray_tpu_torch cluster profile"))

    def _logs(self) -> dict:
        """Worker log files (list, or ?file=<name> tail) — the SPA's
        log viewer (reference: the dashboard log module). Shares the
        list/tail implementation with the CLI's ``logs`` command."""
        from urllib.parse import parse_qs, urlparse

        from ray_tpu_torch.util.logdir import list_log_files, tail_log_file

        log_dir = getattr(self.runtime, "log_dir", None)
        q = parse_qs(urlparse(self.path).query)
        fname = q.get("file", [None])[0]
        if not fname:
            return {"files": list_log_files(log_dir)}
        try:
            tail = int(q.get("tail", ["65536"])[0])
        except ValueError:
            tail = 65536          # garbage query param -> default
        offset = None
        if "offset" in q:
            # Incremental follow: the reply's "offset" field is the
            # resume point for the next poll (only appended bytes
            # ship — the CLI's --follow and any poller share this).
            try:
                offset = int(q["offset"][0])
            except ValueError:
                offset = None
        return tail_log_file(log_dir, fname, tail, offset=offset)

    def _agent_stats(self) -> dict:
        """Daemon-reported samples + an on-demand head self-sample
        (one merge for both the JSON API and the HTML table)."""
        stats = dict(getattr(self.runtime, "_agent_stats", {}))
        if self.head_agent is not None:
            row = self.head_agent.sample()
            row["node_id"] = "head"
            stats["head"] = row
        return stats

    def _node_rows(self) -> str:
        stats = self._agent_stats()
        gb = 1024 ** 3
        return "".join(
            f"<tr><td>{nid}</td><td>{s.get('cpu_percent', 0)}</td>"
            f"<td>{s.get('mem_used', 0) / gb:.1f} / "
            f"{s.get('mem_total', 0) / gb:.1f}</td>"
            f"<td>{s.get('num_workers', 0)}</td>"
            f"<td>{s.get('gpus', 0)}</td></tr>"
            for nid, s in sorted(stats.items()))

    def _index(self) -> bytes:
        from ray_tpu_torch.util import state as state_api
        rt = self.runtime
        summary = state_api.summarize_tasks()
        res = rt.cluster_resources()
        avail = rt.available_resources()
        rows = "".join(
            f"<tr><td>{k}</td><td>{avail.get(k, 0):g} / {v:g}</td></tr>"
            for k, v in sorted(res.items()))
        agg: dict = {}
        for states in summary.get("tasks", {}).values():
            for st, n in states.items():
                agg[st] = agg.get(st, 0) + n
        counts = "".join(
            f"<tr><td>{k}</td><td>{v}</td></tr>"
            for k, v in sorted(agg.items()))
        html = f"""<!doctype html><html><head>
<title>ray_tpu_torch dashboard</title>
<style>body{{font-family:monospace;margin:2em}}
table{{border-collapse:collapse}}td,th{{border:1px solid #999;
padding:4px 10px}}</style></head><body>
<h2>ray_tpu_torch</h2>
<h3>Resources (available / total)</h3><table>{rows}</table>
<h3>Task states</h3><table>{counts}</table>
<h3>Nodes</h3><table>
<tr><th>node</th><th>cpu%</th><th>mem used/total (GB)</th>
<th>workers</th><th>gpus</th></tr>{self._node_rows()}</table>
<p>APIs: <a href="/api/cluster">cluster</a>
<a href="/api/nodes">nodes</a> <a href="/api/tasks">tasks</a>
<a href="/api/actors">actors</a> <a href="/api/objects">objects</a>
<a href="/api/placement_groups">placement_groups</a>
<a href="/api/summary">summary</a>
<a href="/api/timeline">timeline</a> <a href="/api/spans">spans</a>
<a href="/api/v1/traces">traces</a>
<a href="/metrics">metrics</a>
<a href="/api/v1/status">status</a>
<a href="/api/v1/memory">memory</a>
<a href="/api/v1/stack">stack</a></p>
</body></html>"""
        return html.encode()


def _head_gpus(runtime) -> int:
    """The head node's cards (its ``GPU`` resource), which the head's
    own agent reports in the node table's ``gpus`` column."""
    head = getattr(runtime, "head_node_id", None)
    node = getattr(runtime, "_nodes", {}).get(head)
    return int(node.resources.get("GPU", 0)) if node is not None else 0


class Dashboard:
    def __init__(self, port: int = 8265, host: str = "127.0.0.1",
                 runtime=None):
        if runtime is None:
            from ray_tpu_torch.core.api import get_runtime
            runtime = get_runtime()
        from ray_tpu_torch.dashboard.agent import NodeAgent
        handler = type("BoundHandler", (_Handler,),
                       {"runtime": runtime,
                        "head_agent": NodeAgent(
                            lambda s: None, node_id="head",
                            num_gpus=_head_gpus(runtime))})
        self._server = ThreadingHTTPServer((host, port), handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="dashboard")
        self._thread.start()
        # Core system metrics into the /metrics registry (reference:
        # the native stat defs surfaced through the metrics agent).
        from ray_tpu_torch.dashboard.system_metrics import (
            start_system_metrics,
        )
        self._system_metrics = start_system_metrics(runtime)
        self._system_metrics.sample_once()
        # Prometheus + Grafana provisioning for THIS cluster
        # (reference: dashboard/modules/metrics generated configs).
        try:
            from ray_tpu_torch.dashboard.metrics_config import (
                generate_metrics_configs,
            )
            log_dir = getattr(runtime, "log_dir", None)
            if log_dir:
                # SIBLING of logs/, not inside it: log consumers
                # (log monitor, CLI logs, user scripts) iterate
                # log_dir expecting plain files.
                self.metrics_config_paths = generate_metrics_configs(
                    os.path.join(os.path.dirname(
                        os.path.abspath(log_dir)), "metrics"),
                    [f"{host}:{self.port}"])
        except Exception:  # noqa: BLE001 — observability config
            pass           # generation must never block the server

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def start_dashboard(port: int = 8265, host: str = "127.0.0.1",
                    runtime=None) -> Dashboard:
    """Start the dashboard head; ``port=0`` picks a free port."""
    return Dashboard(port=port, host=host, runtime=runtime)
