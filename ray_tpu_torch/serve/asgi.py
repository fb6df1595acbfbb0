"""ASGI app mounting (reference: serve.ingress + HTTPProxy's ASGI
path, serve/_private/proxy.py:766 and api.py ingress decorator).

``@serve.deployment`` + ``@serve.ingress(app)`` mounts ANY ASGI-3
application (FastAPI/Starlette when available — neither is required)
behind the serve HTTP proxy: the proxy ships the raw request
(method/path/headers/query/body) to the replica, which drives the
ASGI app with a minimal in-replica ASGI driver and returns the
status/headers/body. Routing, pow-2 replica choice, autoscaling and
draining are untouched — ASGI is just a different replica callable.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable

ASGI_MARKER = "__serve_asgi__"


async def run_asgi(app, request: dict) -> dict:
    """Drive one HTTP request through an ASGI-3 app."""
    body = request.get("body") or b""
    scope = {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.get("method", "GET"),
        "scheme": "http",
        "path": request.get("path", "/"),
        "raw_path": request.get("path", "/").encode(),
        "query_string": request.get("query_string", b"") or b"",
        "root_path": request.get("root_path", ""),
        "headers": [(k.lower().encode() if isinstance(k, str) else k,
                     v.encode() if isinstance(v, str) else v)
                    for k, v in request.get("headers", [])],
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 80),
    }
    sent_body = False
    out = {"status": 500, "headers": [], "body": b""}
    chunks: list[bytes] = []

    async def receive():
        nonlocal sent_body
        if sent_body:
            return {"type": "http.disconnect"}
        sent_body = True
        return {"type": "http.request", "body": body,
                "more_body": False}

    async def send(message):
        if message["type"] == "http.response.start":
            out["status"] = message["status"]
            # latin-1, per the HTTP/ASGI spec: header bytes are not
            # necessarily valid UTF-8.
            out["headers"] = [
                (k.decode("latin-1") if isinstance(k, bytes) else k,
                 v.decode("latin-1") if isinstance(v, bytes) else v)
                for k, v in message.get("headers", [])]
        elif message["type"] == "http.response.body":
            chunks.append(bytes(message.get("body", b"")))

    await app(scope, receive, send)
    out["body"] = b"".join(chunks)
    return out


class LifespanRunner:
    """One persistent event loop per replica serving BOTH the
    long-lived lifespan invocation and every request coroutine.

    The spec requires the SAME app coroutine to receive startup and,
    much later, shutdown (per-phase invocations make stateful apps
    run shutdown handlers right after startup). Requests must run on
    the SAME loop: resources a startup handler binds to its loop
    (async clients, db pools) would raise 'attached to a different
    event loop' from any other one."""

    def __init__(self, app):
        import queue
        import threading

        self._app = app
        self._to_app: "queue.Queue" = queue.Queue()
        self._waiters: dict = {}
        self._lifespan_done = threading.Event()
        self._loop_ready = threading.Event()
        self._loop = None
        threading.Thread(target=self._thread_main, daemon=True,
                         name="asgi_app_loop").start()

    def _thread_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        def _start():
            task = loop.create_task(self._lifespan_main())
            task.add_done_callback(self._on_lifespan_done)

        loop.call_soon(_start)
        self._loop_ready.set()
        loop.run_forever()

    def _on_lifespan_done(self, task) -> None:
        # Retrieve the exception: a lifespan-less app REJECTS the
        # scope by raising — normal per spec, not stderr noise.
        try:
            task.exception()
        except asyncio.CancelledError:
            pass
        self._lifespan_done.set()
        for ev, box in list(self._waiters.values()):
            if not ev.is_set():
                box.append(False)
                ev.set()

    async def _lifespan_main(self) -> None:
        loop = asyncio.get_running_loop()

        async def receive():
            return await loop.run_in_executor(None, self._to_app.get)

        async def send(message):
            t = message.get("type", "")
            for phase in ("startup", "shutdown"):
                if t.startswith(f"lifespan.{phase}."):
                    entry = self._waiters.get(phase)
                    if entry is not None:
                        ev, box = entry
                        box.append(t == f"lifespan.{phase}.complete")
                        ev.set()

        await self._app({"type": "lifespan",
                         "asgi": {"version": "3.0",
                                  "spec_version": "2.0"}},
                        receive, send)

    def phase(self, name: str, timeout: float = 10.0) -> bool:
        """Run one lifespan phase; False = failed or unsupported."""
        import threading

        ev = threading.Event()
        box: list = []
        # Register FIRST, then check liveness: the done-callback
        # snapshots waiters, so this ordering closes the window where
        # the lifespan task exits between check and registration.
        self._waiters[name] = (ev, box)
        if self._lifespan_done.is_set():
            return False
        self._to_app.put({"type": f"lifespan.{name}"})
        if not ev.wait(timeout):
            return False
        return bool(box and box[0])

    def run(self, coro, timeout: float | None = 120.0):
        """Run a coroutine on the replica's persistent app loop."""
        if not self._loop_ready.wait(10):
            raise RuntimeError("ASGI app loop failed to start")
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except BaseException:
            # Don't leave an abandoned coroutine running side
            # effects on the shared loop after its request failed.
            fut.cancel()
            raise

    def stop(self) -> None:
        if self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError:
                pass


def ingress(app_or_factory) -> Callable:
    """Class decorator mounting an ASGI app on a deployment
    (reference: serve.ingress). Accepts the app object itself or a
    zero-arg factory (built once per replica)."""

    def decorate(cls):
        class ASGIWrapped(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                app = app_or_factory
                if not hasattr(app, "__call__"):
                    raise TypeError("ingress() needs an ASGI app")
                # Zero-arg factory vs app instance: an ASGI app
                # called with () would TypeError, so probe the
                # signature cheaply.
                import inspect
                try:
                    sig = inspect.signature(app)
                    is_factory = len(sig.parameters) == 0
                except (TypeError, ValueError):
                    is_factory = False
                self._asgi_app = app() if is_factory else app
                # Remember whether startup ran: ASGI forbids a bare
                # shutdown message without a prior startup.
                self._lifespan = LifespanRunner(self._asgi_app)
                self._lifespan_ok = self._lifespan.phase("startup")

            def __call__(self, request: Any):
                if not (isinstance(request, dict)
                        and request.get("__asgi__")):
                    raise TypeError(
                        "ASGI deployments take HTTP requests via the "
                        "serve proxy (or a dict with '__asgi__': "
                        "True)")
                # Same loop as the lifespan coroutine: startup-bound
                # async resources stay usable from handlers.
                return self._lifespan.run(
                    run_asgi(self._asgi_app, request))

            def __del__(self):
                try:
                    if getattr(self, "_lifespan_ok", False):
                        self._lifespan.phase("shutdown")
                    self._lifespan.stop()
                except Exception:  # noqa: BLE001
                    pass

        ASGIWrapped.__name__ = cls.__name__
        ASGIWrapped.__qualname__ = cls.__qualname__
        setattr(ASGIWrapped, ASGI_MARKER, True)
        return ASGIWrapped

    return decorate
