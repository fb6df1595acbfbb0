"""gRPC ingress proxy (reference analog: gRPCProxy, proxy.py:545).

Shares the steady-state request path with the HTTP proxy: one cached
Router per deployment (long-poll-fed replica sets, pow-2 probing) and
zero controller RPCs per request. The wire contract mirrors the
reference's generic gRPC ingress:

- method path ``/ray_tpu.serve.RayServeAPIService/<method>`` — the
  trailing segment names the deployment method (``__call__`` for the
  callable);
- the target application comes from request metadata
  ``application`` (reference: gRPCProxy's application metadata) or
  falls back to the sole registered route;
- ``multiplexed_model_id`` metadata routes to model-multiplexed
  replicas exactly like the handle API;
- bodies are JSON by default (metadata ``ray-content-type:
  application/json``, also the assumed type when absent) — request:
  the single argument; response: the return value. Pickle payloads
  (``ray-content-type: application/x-pickle``) carry arbitrary objects
  but are ONLY deserialized when the call presents the cluster's
  ingress token as ``ray-auth-token`` metadata: an ingress proxy is
  the component meant to face external clients, and unpickling
  untrusted bytes is arbitrary code execution (the reference's
  gRPCProxy exchanges protobuf, never pickles of client bytes).
  The port additionally binds 127.0.0.1 only and must never be
  exposed or port-forwarded to untrusted networks;
- server-streaming is selected by the path suffix ``Streaming``
  (``/…/countsStreaming`` dispatches the replica method ``counts``
  as a generator) — gRPC's generic handler cannot see the client's
  call type, so the suffix IS the contract.

Request robustness mirrors the HTTP proxy: unary calls ride the
router's retry plane (``Router.call``), client deadlines
(``context.time_remaining()``) propagate proxy → router → replica,
overload / retries-exhausted aborts ``UNAVAILABLE``, expired deadlines
abort ``DEADLINE_EXCEEDED``, and past ``serve_proxy_max_inflight``
concurrent requests the proxy sheds with ``UNAVAILABLE`` before
touching the routing plane.
"""

from __future__ import annotations

import hmac
import json
import threading

import ray_tpu_torch

PICKLE_CTYPE = "application/x-pickle"
JSON_CTYPE = "application/json"


def grpc_code_name(e: BaseException) -> str:
    """``grpc.StatusCode`` attribute name for a failed routed request.

    Kept import-free (string names, not StatusCode members) so the
    mapping is golden-testable without a grpc runtime; the servicer
    resolves the name via ``getattr(grpc.StatusCode, name)``.
    """
    from ray_tpu_torch.serve.exceptions import classify
    kind = classify(e)
    if kind in ("overload", "replica_busy"):
        return "UNAVAILABLE"
    if kind == "deadline":
        return "DEADLINE_EXCEEDED"
    return "INTERNAL"


def _pickle_loads(b: bytes):
    import cloudpickle
    import pickle
    try:
        return pickle.loads(b)
    except Exception:  # noqa: BLE001
        return cloudpickle.loads(b)


def _pickle_dumps(v) -> bytes:
    import cloudpickle
    return cloudpickle.dumps(v)


@ray_tpu_torch.remote
class GRPCProxyActor:
    def __init__(self, port: int, auth_token: str = "",
                 request_timeout_s: float | None = None,
                 max_inflight: int | None = None):
        from ray_tpu_torch.core.config import get_config
        cfg = get_config()
        self.port = port
        self.auth_token = auth_token
        # Default end-to-end deadline when the client sets none
        # (0/None = none); a client gRPC deadline always wins.
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
            "requests shed at the proxy in-flight cap",
            tag_keys=("proxy",)).set_default_tags({"proxy": "grpc"})
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve_forever,
                                        daemon=True)
        self._thread.start()
        self._started.wait(15)

    def set_routes(self, routes: dict[str, str]) -> bool:
        self.routes = dict(routes)
        return True

    def ready(self) -> int:
        if not self._started.wait(15):
            raise RuntimeError(
                f"gRPC proxy failed to start on port {self.port}: "
                f"{getattr(self, '_start_error', 'timeout')}")
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

    @staticmethod
    def _route_name(entry) -> str:
        return entry["name"] if isinstance(entry, dict) else entry

    def _target_for(self, metadata: dict) -> str | None:
        names = {p: self._route_name(e)
                 for p, e in self.routes.items()}
        app = metadata.get("application")
        if app:
            # Accept either a deployment name or a route prefix.
            if app in names:
                return names[app]
            if app in names.values():
                return app
            return None
        if len(names) == 1:
            return next(iter(names.values()))
        return names.get("/")

    def _serve_forever(self):
        import asyncio

        import grpc

        proxy = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method.rsplit(
                    "/", 1)[-1]
                if method.endswith("Streaming"):
                    return grpc.unary_stream_rpc_method_handler(
                        _make_stream(method[:-len("Streaming")]
                                     or "__call__"),
                        request_deserializer=None,
                        response_serializer=None)
                return grpc.unary_unary_rpc_method_handler(
                    _make_unary(method),
                    request_deserializer=None,
                    response_serializer=None)

        def _md(context) -> dict:
            return {k: v for k, v in (context.invocation_metadata()
                                      or ())}

        async def _decode(request: bytes, md: dict, context):
            """Deserialize a request body; returns (value, ctype).

            Pickle is gated on the ingress token — unpickling bytes
            from an unauthenticated peer is arbitrary code execution
            (advisor r3 medium). JSON needs no token.
            """
            ctype = md.get("ray-content-type", JSON_CTYPE)
            if ctype == PICKLE_CTYPE:
                tok = md.get("ray-auth-token", "")
                if not (proxy.auth_token and
                        hmac.compare_digest(tok, proxy.auth_token)):
                    await context.abort(
                        grpc.StatusCode.UNAUTHENTICATED,
                        "pickle payloads require the ingress token "
                        "as ray-auth-token metadata "
                        "(serve.grpc_ingress_token())")
                return ((_pickle_loads(request) if request else None),
                        ctype)
            if ctype != JSON_CTYPE:
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unsupported content-type {ctype!r}; use "
                    f"{JSON_CTYPE} or authenticated {PICKLE_CTYPE}")
            if not request:
                return None, ctype
            try:
                return json.loads(request.decode()), ctype
            except (ValueError, UnicodeDecodeError) as e:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                    f"bad JSON body: {e}"[:300])

        def _encode(v, ctype: str) -> bytes:
            if ctype == PICKLE_CTYPE:
                return _pickle_dumps(v)
            return json.dumps(v).encode()

        def _deadline_ts(context) -> float:
            """Absolute unix deadline for this call (0 = none): the
            client's gRPC deadline (``time_remaining()``) wins, else
            the proxy's configured default applies."""
            import time as _time
            remaining = context.time_remaining()
            if remaining is not None:
                return _time.time() + max(0.0, remaining)
            if proxy._timeout_s:
                return _time.time() + proxy._timeout_s
            return 0.0

        def _make_unary(method_name: str):
            async def unary(request: bytes, context):
                import uuid

                md = _md(context)
                # Stable request id (PR 7 semantics, mirroring the
                # HTTP proxy): honors an inbound x-request-id
                # metadata entry, rides every retry attempt and the
                # replica ledger, and is echoed back as trailing
                # metadata so a failed call can be joined to its
                # trace (its spans carry the id; ``util.state``).
                rid = md.get("x-request-id") or uuid.uuid4().hex
                context.set_trailing_metadata(
                    (("x-request-id", rid),))
                target = proxy._target_for(md)
                if target is None:
                    await context.abort(
                        grpc.StatusCode.NOT_FOUND,
                        "no matching application")
                # In-flight cap: shed before decoding the body or
                # touching the routing plane. Reserve the slot
                # IMMEDIATELY after the check — incrementing only
                # after the _decode await would let a burst of
                # concurrent calls all pass the check and overshoot
                # the cap.
                if proxy._inflight >= proxy._max_inflight:
                    proxy._m_shed.inc()
                    await context.abort(
                        grpc.StatusCode.UNAVAILABLE,
                        f"proxy at in-flight cap "
                        f"({proxy._max_inflight}); retry later")
                proxy._inflight += 1
                try:
                    arg, ctype = await _decode(request, md, context)
                    router = proxy._router_for(target)
                    deadline_ts = _deadline_ts(context)
                    loop = asyncio.get_running_loop()

                    def call():
                        return router.call(
                            method_name, (arg,), {},
                            multiplexed_model_id=md.get(
                                "multiplexed_model_id", ""),
                            deadline_ts=deadline_ts,
                            request_id=rid)

                    try:
                        result = await loop.run_in_executor(None, call)
                    except Exception as e:  # noqa: BLE001
                        await context.abort(
                            getattr(grpc.StatusCode,
                                    grpc_code_name(e)),
                            str(e)[:500])
                    return _encode(result, ctype)
                finally:
                    proxy._inflight -= 1
            return unary

        def _make_stream(method_name: str):
            async def stream(request: bytes, context):
                import uuid

                md = _md(context)
                rid = md.get("x-request-id") or uuid.uuid4().hex
                context.set_trailing_metadata(
                    (("x-request-id", rid),))
                target = proxy._target_for(md)
                if target is None:
                    await context.abort(
                        grpc.StatusCode.NOT_FOUND,
                        "no matching application")
                arg, ctype = await _decode(request, md, context)
                router = proxy._router_for(target)
                loop = asyncio.get_running_loop()
                # Bounded queue = backpressure: a slow client can't
                # make the proxy buffer an arbitrarily long stream.
                q: asyncio.Queue = asyncio.Queue(maxsize=16)
                DONE, ERR = object(), object()
                stopped = threading.Event()

                def pump():
                    gen = None
                    try:
                        gen = router.assign(
                            method_name, (arg,), {},
                            multiplexed_model_id=md.get(
                                "multiplexed_model_id", ""),
                            stream=True)
                        for ref in gen:
                            if stopped.is_set():
                                return   # client went away
                            item = ray_tpu_torch.get(ref, timeout=120)
                            asyncio.run_coroutine_threadsafe(
                                q.put((None, item)), loop).result(120)
                        asyncio.run_coroutine_threadsafe(
                            q.put((DONE, None)), loop).result(120)
                    except Exception as e:  # noqa: BLE001
                        if not stopped.is_set():
                            try:
                                asyncio.run_coroutine_threadsafe(
                                    q.put((ERR, e)), loop).result(30)
                            except Exception:  # noqa: BLE001
                                pass

                threading.Thread(target=pump, daemon=True).start()
                try:
                    while True:
                        tag, item = await q.get()
                        if tag is DONE:
                            return
                        if tag is ERR:
                            await context.abort(
                                getattr(grpc.StatusCode,
                                        grpc_code_name(item)),
                                str(item)[:500])
                        try:
                            body = _encode(item, ctype)
                        except (TypeError, ValueError) as e:
                            # JSON-unserializable yield: surface
                            # INTERNAL + message like the unary path,
                            # not an opaque UNKNOWN.
                            await context.abort(
                                grpc.StatusCode.INTERNAL,
                                f"unserializable stream item: "
                                f"{e}"[:500])
                        yield body
                finally:
                    # Cancellation/disconnect: stop the pump instead
                    # of draining the whole replica stream; unblock a
                    # put() waiting on the bounded queue.
                    stopped.set()
                    while not q.empty():
                        q.get_nowait()
            return stream

        async def run():
            server = grpc.aio.server()
            server.add_generic_rpc_handlers((_Handler(),))
            bound = server.add_insecure_port(f"127.0.0.1:{self.port}")
            if bound == 0:
                # add_insecure_port reports failure by returning 0
                # (it does not raise): surface it through ready().
                self._start_error = f"port {self.port} unavailable"
                return
            await server.start()
            self._started.set()
            await server.wait_for_termination()

        asyncio.new_event_loop().run_until_complete(run())
