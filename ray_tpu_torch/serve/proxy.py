"""HTTP proxy actor (aiohttp ingress).

Reference analog: ProxyActor/HTTPProxy (proxy.py:1140,766). Routes
``<route_prefix>`` to the matching deployment's router; request bodies
parse as JSON (or raw bytes fall through), responses JSON-encode.

Request robustness at the edge:

- Every request goes through the router's retry plane
  (``Router.call``): replica death / drain / shed mid-request is
  re-dispatched transparently, with ledger dedupe replica-side.
- **Load shedding**: past ``serve_proxy_max_inflight`` concurrent
  requests the proxy answers 503 + ``Retry-After`` immediately,
  without touching the routing plane — overload degrades to fast,
  honest rejections instead of a timeout pile-up.
- **Deadlines**: ``X-Request-Timeout-S`` header (or the proxy's
  configured ``request_timeout_s``) becomes an end-to-end deadline
  propagated proxy → router → replica; an expired request is answered
  504 and never executed.
- **Transport mapping**: overload / retries-exhausted → 503 with
  Retry-After, deadline → 504, everything else (user exception) → 500.
"""

from __future__ import annotations

import json
import threading

import ray_tpu_torch

_RETRY_AFTER_S = "1"


def _flush_trace_spans() -> None:
    """Ship this proxy process's finished spans to the head NOW so a
    just-completed request's trace assembles without waiting out the
    exporter interval. Best-effort: on failure the spans stay ring-
    buffered for the next exporter flush."""
    try:
        from ray_tpu_torch.core import api
        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.util.tracing import get_tracer
        tr = get_tracer()
        if not tr.enabled:
            return
        spans = tr.drain_dicts()
        if spans:
            rt = api.get_runtime()
            try:
                rt._call(P.OP_SPANS, spans)
            except Exception:  # noqa: BLE001 — head briefly away:
                tr.requeue_dicts(spans)   # next exporter flush owns it
    except Exception:  # noqa: BLE001 — tracing must never fail a
        pass           # request



def error_response(e: BaseException, request_id: str = ""):
    """(status, headers, body-dict) for a failed routed request —
    shared by the JSON and ASGI paths and golden-tested. With a
    request id, 503/504 answers carry ``X-Request-Id`` so a failed
    request can be joined to its trace (its spans carry the id;
    ``util.state.list_traces``)."""
    from ray_tpu_torch.serve.exceptions import classify
    kind = classify(e)
    rid_hdr = {"X-Request-Id": request_id} if request_id else {}
    if kind in ("overload", "replica_busy"):
        return (503, {"Retry-After": _RETRY_AFTER_S, **rid_hdr},
                {"error": "overloaded", "detail": str(e)[:500]})
    if kind == "deadline":
        return (504, dict(rid_hdr),
                {"error": "deadline exceeded", "detail": str(e)[:500]})
    return (500, dict(rid_hdr), {"error": str(e)[:500]})


@ray_tpu_torch.remote
class ProxyActor:
    def __init__(self, port: int, host: str = "127.0.0.1",
                 request_timeout_s: float | None = None,
                 max_inflight: int | None = None,
                 retry_enabled: bool | None = None):
        from ray_tpu_torch.core.config import get_config
        cfg = get_config()
        self.port = port
        self.host = host
        # None = follow cfg.serve_retry_enabled; the perf guardrail
        # spawns a second proxy with retry_enabled=False to measure
        # the disabled-path overhead (config flips in the driver don't
        # reach an already-spawned actor process).
        self._retry = retry_enabled
        # Default end-to-end deadline (0/None = none); per-request
        # X-Request-Timeout-S headers override it.
        self._timeout_s = (request_timeout_s
                           if request_timeout_s is not None
                           else (cfg.serve_request_deadline_s or None))
        self._max_inflight = (max_inflight if max_inflight is not None
                              else cfg.serve_proxy_max_inflight)
        self._inflight = 0      # event-loop-thread only
        self.routes: dict[str, str] = {}     # route_prefix -> deployment
        self._routers: dict[str, object] = {}
        self._controller = None
        from ray_tpu_torch.util.metrics import Counter
        self._m_shed = Counter(
            "ray_tpu_serve_proxy_shed_total",
            "requests shed at the proxy in-flight cap (HTTP 503)",
            tag_keys=("proxy",)).set_default_tags({"proxy": "http"})
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve_forever,
                                        daemon=True)
        self._thread.start()
        self._started.wait(10)

    def set_routes(self, routes: dict[str, str]) -> bool:
        self.routes = dict(routes)
        return True

    def ready(self) -> int:
        return self.port

    def _router_for(self, deployment: str):
        if deployment not in self._routers:
            from ray_tpu_torch.serve.controller import CONTROLLER_NAME
            from ray_tpu_torch.serve.router import Router
            if self._controller is None:
                self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            self._routers[deployment] = Router.for_deployment(
                self._controller, deployment)
        return self._routers[deployment]

    def _deadline_for(self, request) -> float:
        """Per-request deadline: header beats proxy default beats
        none. Returned as an absolute unix timestamp (0 = none)."""
        import time as _time
        raw = request.headers.get("X-Request-Timeout-S")
        if raw:
            try:
                return _time.time() + max(0.0, float(raw))
            except ValueError:
                pass
        if self._timeout_s:
            return _time.time() + self._timeout_s
        return 0.0

    def _serve_forever(self):
        import asyncio

        from aiohttp import web

        async def handler(request: "web.Request"):
            path = request.path
            target = None
            matched_prefix = "/"
            # longest-prefix route match
            for prefix in sorted(self.routes, key=len, reverse=True):
                if path == prefix or path.startswith(
                        prefix.rstrip("/") + "/") or prefix == "/":
                    target = self.routes[prefix]
                    matched_prefix = prefix
                    break
            if target is None:
                return web.json_response(
                    {"error": f"no route for {path}"}, status=404)
            # In-flight cap: shed NOW, before reading the body or
            # touching the router — an overloaded proxy must stay a
            # fast 503 machine, not a growing queue of hung sockets.
            if self._inflight >= self._max_inflight:
                self._m_shed.inc()
                return web.json_response(
                    {"error": "overloaded",
                     "detail": f"proxy at in-flight cap "
                               f"({self._max_inflight})"},
                    status=503,
                    headers={"Retry-After": _RETRY_AFTER_S})
            # Route entries are {"name", "asgi"} dicts (legacy plain
            # strings still accepted).
            if isinstance(target, dict):
                name, is_asgi = target["name"], target.get("asgi")
            else:
                name, is_asgi = target, False
            self._inflight += 1
            try:
                return await self._dispatch(
                    request, path, matched_prefix, name, is_asgi)
            finally:
                self._inflight -= 1

        async def run():
            app = web.Application()
            app.router.add_route("*", "/{tail:.*}", handler)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            self._started.set()
            while True:
                await asyncio.sleep(3600)

        asyncio.new_event_loop().run_until_complete(run())

    @staticmethod
    def _traced_route(router, rid, path, name, payload_args,
                      deadline_ts, retry):
        """One routed request in an executor thread. When serve
        tracing is on, the proxy ingress span is the TRACE ROOT and
        carries the stable request id — the router/attempt/replica
        spans all nest under it, and the whole tree is retrievable by
        that id after a failure (X-Request-Id joins the two)."""
        from ray_tpu_torch.core.config import get_config as _gc

        def _route():
            return router.call("__call__", payload_args, {},
                               deadline_ts=deadline_ts, retry=retry,
                               request_id=rid)

        if not _gc().trace_serve_requests:
            return _route()
        from ray_tpu_torch.util.tracing import get_tracer
        tr = get_tracer()
        tr.enable()
        try:
            with tr.span("serve.ingress",
                         {"request_id": rid, "route": path,
                          "deployment": name, "proxy": "http"}):
                return _route()
        finally:
            _flush_trace_spans()

    async def _dispatch(self, request, path, matched_prefix, name,
                        is_asgi):
        import asyncio
        import uuid

        from aiohttp import web
        body = await request.read()
        router = self._router_for(name)
        deadline_ts = self._deadline_for(request)
        loop = asyncio.get_running_loop()
        # Stable request id minted at the edge (PR 7 semantics: the
        # same id rides every retry attempt and the replica ledger);
        # also the trace join key on error responses.
        rid = request.headers.get("X-Request-Id") or uuid.uuid4().hex

        if is_asgi:
            # ASGI mount (reference: HTTPProxy ASGI path,
            # proxy.py:766): ship the raw request; the replica
            # drives the app and returns status/headers/body.
            sub = path[len(matched_prefix.rstrip("/")):] or "/"
            asgi_req = {
                "__asgi__": True,
                "method": request.method,
                "path": sub,
                "root_path": matched_prefix.rstrip("/"),
                "query_string":
                    request.query_string.encode(),
                "headers": [(k, v) for k, v
                            in request.headers.items()],
                "body": body,
            }

            def call_asgi():
                return self._traced_route(
                    router, rid, path, name, (asgi_req,),
                    deadline_ts, self._retry)

            try:
                out = await loop.run_in_executor(None, call_asgi)
            except Exception as e:  # noqa: BLE001
                status, headers, payload = error_response(e, rid)
                return web.json_response(payload, status=status,
                                         headers=headers)
            resp = web.Response(status=out.get("status", 200),
                                body=out.get("body", b""))
            for k, v in out.get("headers", []):
                if k.lower() not in ("content-length",
                                     "transfer-encoding"):
                    # add(), not assignment: duplicate headers
                    # (multiple Set-Cookie) must all survive.
                    resp.headers.add(k, v)
            return resp

        if body:
            try:
                payload = json.loads(body)
            except json.JSONDecodeError:
                payload = body.decode("utf-8", "replace")
        else:
            payload = dict(request.query)

        def call():
            return self._traced_route(
                router, rid, path, name, (payload,),
                deadline_ts, self._retry)

        try:
            result = await loop.run_in_executor(None, call)
        except Exception as e:  # noqa: BLE001
            status, headers, out = error_response(e, rid)
            return web.json_response(out, status=status,
                                     headers=headers)
        if isinstance(result, (bytes, str)):
            return web.Response(
                body=result if isinstance(result, bytes)
                else result.encode())
        return web.json_response(result)
