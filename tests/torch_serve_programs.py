"""Small Serve programs, each run once on ``ray_tpu`` and once on
``ray_tpu_torch`` (tests/test_torch_serve_parity.py and
tests/test_torch_serve_faults.py).

Every program takes the package module (``rt``), reaches Serve as
``rt.serve`` (and its submodules) and the runtime through ``rt.get``,
``rt.put``, ``rt.kill`` and ``rt.remote``, so the same code runs on
both. It returns a plain result that holds only what a run decides
(values, booleans, status codes, sorted sets), never a pid, a time or a
port: two results are equal only if a user would have seen the same
behaviour. The programs cover the behaviours of the JAX package's
``tests/test_serve*.py``; :data:`EXPECTED` holds what each must give.

Nothing here imports either package at module level: a worker that
unpickles one of these functions loads numpy and the package it runs
in. :func:`gpt2_server` is the GPT-2 deployment of either package for
tests/test_torch_serve_gpt2.py, on the padding and LM-head functions of
chip_smoke.py's phase 17 deployment (which the card test serves).
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import pickle
import shutil
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np


def _serve(rt):
    return importlib.import_module(rt.__name__ + ".serve")


def _sub(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, body: bytes | None = None, headers=None,
          method: str | None = None, timeout: float = 60):
    """(status, headers, body) of one HTTP request; an error status is
    an answer, not an exception."""
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _wait_until(pred, timeout: float, step: float = 0.1) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def _reaped(rt, live: int, timeout: float = 35.0) -> bool:
    """Whether the replicas a scale-down or redeploy drained are reaped:
    the runtime's free CPUs come back to all but the ``live`` replicas'
    (one CPU each) within ``timeout``. A program that left them draining
    would leave their CPUs held after ``serve.shutdown()``, which kills
    only the replicas it routes to."""
    total = rt.cluster_resources()["CPU"]
    return _wait_until(
        lambda: rt.available_resources().get("CPU", 0) == total - live,
        timeout, 0.05)


def _controller(rt):
    return rt.get_actor(_sub(rt, "serve.controller").CONTROLLER_NAME)


# -- handles, replicas, composition -------------------------------------------


def handle_basic(rt):
    serve = _serve(rt)

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return {"doubled": x["v"] * 2}

    handle = serve.run(Doubler.bind())
    return rt.get(handle.remote({"v": 21}), timeout=60)


def replicas_balance(rt):
    """Two replicas both take traffic: the count of distinct pids."""
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Which:
        def __call__(self, x):
            return os.getpid()

    handle = serve.run(Which.options(name="which").bind())
    return len(set(rt.get([handle.remote({}) for _ in range(20)],
                          timeout=120)))


def composition(rt):
    serve = _serve(rt)

    @serve.deployment
    class Embedder:
        def embed(self, text):
            return {"len": len(text)}

        def __call__(self, x):
            return self.embed(x)

    @serve.deployment
    class Pipeline:
        def __init__(self, embedder):
            self.embedder = embedder

        def __call__(self, x):
            inner = rt.get(self.embedder.embed.remote(x["text"]))
            return {"score": inner["len"] * 10}

    handle = serve.run(Pipeline.bind(Embedder.bind()))
    return rt.get(handle.remote({"text": "hello"}), timeout=60)


def deployment_response(rt):
    """``.result()``, ``get``, a response as a task's argument, as another
    handle call's argument (composition) and as an actor's constructor
    argument."""
    serve = _serve(rt)

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

        def plus(self, x, y):
            return x + y

    h = serve.run(Doubler.bind(), name="resp_app")
    resp = h.remote(21)
    out = [isinstance(resp, serve.DeploymentResponse),
           resp.result(timeout_s=60),
           rt.get(h.plus.remote(1, 2), timeout=60)]

    @rt.remote
    def consume(v):
        return v + 1

    out.append(rt.get(consume.remote(h.remote(10)), timeout=60))
    out.append(h.remote(h.remote(5)).result(timeout_s=60))

    @rt.remote(num_cpus=0)
    class Holder:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v

    a = Holder.remote(h.remote(7))
    out.append(rt.get(a.get.remote(), timeout=60))
    rt.kill(a)
    serve.delete("resp_app")
    return out


def objectref_args(rt):
    """A user's ObjectRef reaches the replica as a ref; a composition
    response resolves to its value."""
    serve = _serve(rt)
    ObjectRef = rt.ObjectRef

    @serve.deployment
    class RefStore:
        def kind(self, maybe_ref):
            if isinstance(maybe_ref, ObjectRef):
                return ("ref", rt.get(maybe_ref))
            return ("value", maybe_ref)

    h = serve.run(RefStore.bind(), name="refstore_app")
    ref = rt.put(123)
    out = [h.kind.remote(ref).result(timeout_s=60),
           h.kind.remote(h.kind.remote(ref)).result(timeout_s=60)]
    serve.delete("refstore_app")
    return out


def batching(rt):
    """Four concurrent calls coalesce: every x answered, some batch > 1."""
    serve = _serve(rt)

    @serve.deployment
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def handle_batch(self, xs):
            return [{"n": len(xs), "x": x} for x in xs]

        def __call__(self, x):
            return self.handle_batch(x)

    handle = serve.run(Batched.bind())
    outs = rt.get([handle.remote(i) for i in range(4)], timeout=60)
    return [sorted(o["x"] for o in outs), max(o["n"] for o in outs) >= 2]


def batch_error_reaches_every_caller(rt):
    """An exception in the batched method is raised to every caller of
    that batch."""
    serve = _serve(rt)

    @serve.deployment
    class Failing:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def handle_batch(self, xs):
            raise ValueError(f"batch of {len(xs) >= 1} failed")

        def __call__(self, x):
            return self.handle_batch(x)

    handle = serve.run(Failing.bind())
    out = []
    for r in [handle.remote(i) for i in range(3)]:
        try:
            r.result(timeout_s=60)
            out.append("answered")
        except Exception as e:  # noqa: BLE001 — the user's error
            out.append("batch of True failed" in str(e))
    return out


def respawn_after_death(rt):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Fragile:
        def __call__(self, x):
            return "alive"

        def die(self):
            os._exit(1)

    handle = serve.run(Fragile.bind())
    first = rt.get(handle.remote({}), timeout=60)
    try:
        rt.get(handle.die.remote(), timeout=15)
    except Exception:  # noqa: BLE001 — the replica died mid-call
        pass

    def answers():
        try:
            return rt.get(handle.remote({}), timeout=15) == "alive"
        except Exception:  # noqa: BLE001 — not respawned yet
            return False
    return [first, _wait_until(answers, 60, 0.1)]


def zero_controller_rpcs(rt):
    """After warm-up, 20 requests add no synchronous controller call:
    routing state arrives by long poll."""
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            return x

    handle = serve.run(Echo.bind())
    warm = rt.get(handle.remote("warm"), timeout=60)
    router = handle._router
    before = router.controller_rpcs
    outs = [rt.get(handle.remote(i), timeout=60) for i in range(20)]
    return [warm, outs == list(range(20)), router.controller_rpcs - before]


def compat_surface(rt):
    """start, get_app_handle, delete, status, get_replica_context."""
    serve = _serve(rt)
    serve.start()

    @serve.deployment(num_replicas=1)
    class CompatApp:
        def __call__(self, x):
            ctx = _serve(rt).get_replica_context()
            return {"who": ctx.deployment,
                    "tag": ctx.replica_tag.startswith("CompatApp#"), "x": x}

    serve.run(CompatApp.bind())
    out = rt.get(serve.get_app_handle("CompatApp").remote(7), timeout=60)
    return [out, serve.delete("CompatApp"),
            "CompatApp" in serve.status()["deployments"],
            serve.delete("never_deployed")]


def user_config_in_place(rt):
    """user_config at start; a redeploy changing only it reconfigures the
    same replica object."""
    serve = _serve(rt)

    @serve.deployment(user_config={"threshold": 5})
    class Thresholder:
        def __init__(self):
            self.threshold = None
            self.ident = id(self)

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self, x):
            return (x > self.threshold, self.ident)

    h = serve.run(Thresholder.bind(), name="ucfg")
    over, ident1 = h.remote(7).result(timeout_s=60)
    h2 = serve.run(Thresholder.options(user_config={"threshold": 10})
                   .bind(), name="ucfg")
    over2, ident2 = h2.remote(7).result(timeout_s=60)
    serve.delete("ucfg")
    return [over, over2, ident1 == ident2]


def user_config_without_reconfigure(rt):
    serve = _serve(rt)

    @serve.deployment(user_config={"x": 1})
    class NoReconf:
        def __call__(self):
            return 1

    try:
        serve.run(NoReconf.bind(), name="noreconf")
    except ValueError as e:
        return ["ValueError", str(e)]
    return "no error"


def redeploy_new_code(rt):
    serve = _serve(rt)

    def make_app(version):
        @serve.deployment(name="Roller")
        class Roller:
            def __call__(self, _):
                return version
        return Roller.bind()

    h = serve.run(make_app("v1"), name="roll_app")
    first = h.remote(0).result(timeout_s=60)
    h2 = serve.run(make_app("v2"), name="roll_app")
    seen = []
    _wait_until(lambda: seen.append(h2.remote(0).result(timeout_s=60))
                or seen[-1] == "v2", 60, 0.1)
    reaped = _reaped(rt, 1)
    serve.delete("roll_app")
    return [first, seen[-1], reaped]


# -- HTTP and ASGI ingress ----------------------------------------------------


def http_ingress_and_404(rt):
    serve = _serve(rt)

    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return {"echo": payload, "ok": True}

    port = free_port()
    serve.run(Echo.bind(), http_port=port, route_prefix="/api")
    status, _, body = _http(
        f"http://127.0.0.1:{port}/api/anything",
        json.dumps({"msg": "hi"}).encode(),
        {"Content-Type": "application/json"})
    missing, _, _ = _http(f"http://127.0.0.1:{port}/nope")
    return [status, json.loads(body), missing]


def asgi_ingress(rt):
    """An ASGI-3 app behind the proxy: routing, query string, body,
    headers and a custom status."""
    serve = _serve(rt)

    async def asgi_app(scope, receive, send):
        msg = await receive()
        body = msg.get("body", b"")
        path = scope["path"]
        if path == "/echo":
            out = json.dumps({"path": path, "method": scope["method"],
                              "query": scope["query_string"].decode(),
                              "body": body.decode()}).encode()
            status = 200
        elif path == "/teapot":
            out, status = b"short and stout", 418
        else:
            out, status = b"nope", 404
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", b"application/json"),
                                (b"x-served-by", b"ray-tpu")]})
        await send({"type": "http.response.body", "body": out})

    @serve.deployment(num_replicas=2)
    @serve.ingress(asgi_app)
    class WebApp:
        pass

    port = free_port()
    serve.run(WebApp.bind(), http_port=port, route_prefix="/app")
    status, headers, body = _http(
        f"http://127.0.0.1:{port}/app/echo?who=tpu", b"ping", method="POST")
    tea = _http(f"http://127.0.0.1:{port}/app/teapot")
    return [status, headers.get("x-served-by"), json.loads(body),
            tea[0], tea[2]]


def asgi_lifespan(rt):
    """Startup and shutdown reach the same app coroutine in order; a
    failed startup reports False; an app without lifespan fails fast."""
    LifespanRunner = _sub(rt, "serve.asgi").LifespanRunner
    events = []

    async def app(scope, receive, send):
        msg = await receive()
        events.append(msg["type"])
        await send({"type": "lifespan.startup.complete"})
        msg = await receive()
        events.append(msg["type"])
        await send({"type": "lifespan.shutdown.complete"})

    r = LifespanRunner(app)
    out = [r.phase("startup"), list(events), r.phase("shutdown"),
           list(events)]

    async def failing(scope, receive, send):
        await receive()
        await send({"type": "lifespan.startup.failed", "message": "db down"})

    async def no_lifespan(scope, receive, send):
        raise AssertionError("http only")

    t0 = time.monotonic()
    out += [LifespanRunner(failing).phase("startup"),
            LifespanRunner(no_lifespan).phase("startup"),
            time.monotonic() - t0 < 2.0]
    return out


def asgi_startup_loop(rt):
    """Lifespan and requests share one loop per replica: a lock made at
    startup is usable in a request."""
    serve = _serve(rt)
    state = {}

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            msg = await receive()
            if msg["type"] == "lifespan.startup":
                state["lock"] = asyncio.Lock()
                state["loop"] = asyncio.get_running_loop()
                await send({"type": "lifespan.startup.complete"})
                await receive()
                await send({"type": "lifespan.shutdown.complete"})
            return
        await receive()
        async with state["lock"]:
            same = asyncio.get_running_loop() is state["loop"]
        await send({"type": "http.response.start", "status": 200,
                    "headers": []})
        await send({"type": "http.response.body",
                    "body": b"same-loop" if same else b"DIFFERENT-loop"})

    @serve.deployment(num_replicas=1)
    @serve.ingress(app)
    class LoopApp:
        pass

    port = free_port()
    serve.run(LoopApp.bind(), http_port=port)
    return _http(f"http://127.0.0.1:{port}/")[2]


# -- autoscaling and multiplexing ---------------------------------------------


def autoscaling_policy(rt):
    a = _sub(rt, "serve.autoscaling")
    st = a.AutoscalingState(config=a.AutoscalingConfig(
        min_replicas=1, max_replicas=4, target_ongoing_requests=2.0,
        upscale_delay_s=0.0, downscale_delay_s=0.0, look_back_period_s=0.1))
    st.record(8.0)
    out = [st.decide(1)]
    time.sleep(0.15)
    st.record(0.0)
    out.append(st.decide(4))
    st2 = a.AutoscalingState(config=a.AutoscalingConfig(
        min_replicas=1, max_replicas=4, target_ongoing_requests=2.0,
        downscale_delay_s=60.0, look_back_period_s=0.1))
    st2.record(8.0)
    out.append(st2.decide(1))
    time.sleep(0.15)
    st2.record(0.0)
    out.append(st2.decide(4))
    return out


def autoscaling_end_to_end(rt):
    """Sustained load scales a deployment up; idle scales it back to min."""
    serve = _serve(rt)

    @serve.deployment(
        num_replicas=1,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 2.0,
                            "upscale_delay_s": 0.0,
                            "downscale_delay_s": 0.3,
                            "look_back_period_s": 1.0})
    class Slow:
        def __call__(self, x):
            time.sleep(0.25)
            return x

    handle = serve.run(Slow.bind())
    controller = _controller(rt)

    def desired():
        return rt.get(controller.list_deployments.remote())["Slow"]["desired"]

    def loaded():
        rt.get([handle.remote(i) for i in range(6)], timeout=30)
        return desired() >= 2
    grew = _wait_until(loaded, 12.0, 0.0)
    return [grew, _wait_until(lambda: desired() == 1, 15.0, 0.1),
            _reaped(rt, 1)]


def multiplex_lru(rt):
    mux = _sub(rt, "serve.multiplex")
    unloaded = []

    class FakeModel:
        def __init__(self, mid):
            self.mid = mid

        def unload(self):
            unloaded.append(self.mid)

    class Holder:
        loads = 0

        @mux.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            Holder.loads += 1
            return FakeModel(model_id)

    h = Holder()
    m1 = h.get_model("a")
    out = [h.get_model("a") is m1, Holder.loads]
    h.get_model("b")
    out.append(sorted(mux.resident_model_ids(h)))
    h.get_model("c")
    out += [sorted(mux.resident_model_ids(h)), list(unloaded), Holder.loads]
    return out


def multiplex_end_to_end(rt):
    """Model ids reach the replica; a repeated id is served from a cached
    copy once the controller has learnt where it is resident."""
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class MuxModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        def load_model(self, model_id: str):
            return {"id": model_id, "loaded_at": time.monotonic()}

        def __call__(self, x):
            model = self.load_model(serve.get_multiplexed_model_id())
            return {"model": model["id"], "loaded_at": model["loaded_at"],
                    "x": x}

    handle = serve.run(MuxModel.bind())
    h1 = handle.options(multiplexed_model_id="m1")
    r1 = rt.get(h1.remote(1), timeout=30)
    r2 = rt.get(h1.remote(2), timeout=30)
    m2 = rt.get(handle.options(multiplexed_model_id="m2").remote(3),
                timeout=30)["model"]
    time.sleep(1.2)
    r3 = rt.get(h1.remote(4), timeout=30)
    return [r1["model"], r2["model"], m2, r3["model"],
            r3["loaded_at"] in (r1["loaded_at"], r2["loaded_at"])]


def multiplex_pinned_eviction(rt):
    """Eviction skips a pinned model, and defers the unload of a pinned
    one to its last unpin."""
    mux = _sub(rt, "serve.multiplex")
    unloaded = []

    class Model:
        def __init__(self, mid):
            self.mid = mid

        def unload(self):
            unloaded.append(self.mid)

    class Holder:
        @mux.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return Model(model_id)

    h = Holder()
    h.get_model("a")
    mux.pin_model(h, "a")
    h.get_model("b")
    h.get_model("c")
    out = [sorted(mux.resident_model_ids(h)), list(unloaded)]
    mux.pin_model(h, "c")
    h.get_model("d")
    out += ["a" in mux.resident_model_ids(h), list(unloaded)]
    mux.unpin_model(h, "a")
    out.append(list(unloaded))
    mux.unpin_model(h, "c")
    out += ["c" in mux.resident_model_ids(h), list(unloaded)]
    return out


def multiplex_load_failure(rt):
    """A loader that raises leaves no entry; the next request loads."""
    mux = _sub(rt, "serve.multiplex")
    ModelLoadError = _serve(rt).ModelLoadError
    attempts = []

    class Holder:
        @mux.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            attempts.append(model_id)
            if len(attempts) == 1:
                raise RuntimeError("weights download failed")
            return {"id": model_id}

    h = Holder()
    try:
        h.get_model("m1")
        first = "loaded"
    except ModelLoadError as e:
        first = ["ModelLoadError", "'m1'" in str(e),
                 "download failed" in str(e)]
    return [first, mux.resident_model_ids(h), h.get_model("m1"),
            list(attempts)]


class StreamMux:
    """A replica class whose streaming call reads its model id (module
    level: a Replica actor is given the class itself)."""

    def __init__(self, pkg):
        self.pkg = pkg

    def __call__(self, n):
        mid = importlib.import_module(
            self.pkg + ".serve.multiplex").get_multiplexed_model_id()
        for i in range(n):
            yield f"{mid}:{i}"

    def pins(self):
        return dict(getattr(self, "__serve_mux_pins__", None) or {})


def streaming_multiplexed_no_pin(rt):
    """A streaming multiplexed request leaves no pin behind."""
    Replica = _sub(rt, "serve.replica").Replica
    r = Replica.options(num_cpus=0, max_concurrency=8).remote(
        StreamMux, (rt.__name__,), {}, "dep#streampin")
    outs = []
    for _ in range(2):
        gen = r.handle_request.options(num_returns="streaming").remote(
            "__call__", (3,), {}, multiplexed_model_id="mA", stream=True)
        outs.append([rt.get(ref, timeout=60) for ref in gen])
    # The wrapper unpins as the generator closes: poll out that race (a
    # leaked pin never clears).
    pins = {}

    def unpinned():
        pins.clear()
        pins.update(rt.get(r.handle_request.remote("pins", (), {}),
                           timeout=60))
        return not pins
    _wait_until(unpinned, 5.0, 0.05)
    rt.kill(r)
    return [outs, pins]


# -- declarative deploy -------------------------------------------------------


def _config_apps(rt):
    """The module-level applications a config's ``import_path`` names
    (``torch_serve_programs:<pkg>_echo_app``, see ``__getattr__``)."""
    serve = _serve(rt)

    @serve.deployment(name="Echo")
    class Echo:
        def __call__(self, x):
            return {"echo": x}

    @serve.deployment(name="Adder")
    class Adder:
        def __init__(self, inc: int = 1):
            self.inc = inc

        def __call__(self, x):
            return {"sum": x["v"] + self.inc}

    return {"echo_app": Echo.bind(), "adder_app": Adder.bind(5)}


def __getattr__(name: str):
    """``<package>_echo_app`` and ``<package>_adder_app``: what a serve
    config's ``import_path`` resolves to, for either package."""
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        if name.startswith(pkg + "_"):
            app = name[len(pkg) + 1:]
            apps = _config_apps(importlib.import_module(pkg))
            if app in apps:
                return apps[app]
    raise AttributeError(name)


def schema_errors(rt):
    parse = _sub(rt, "serve.schema").parse_config
    bad = [
        {"applications": []},
        {"applications": [{"name": "a", "import_path": "no_colon"}]},
        {"applications": [{"name": "a", "import_path": "m:x",
                           "route_prefix": "bad"}]},
        {"applications": [{"name": "a", "import_path": "m:x"},
                          {"name": "a", "import_path": "m:y",
                           "route_prefix": "/b"}]},
        {"applications": [{"name": "a", "import_path": "m:x",
                           "replicas": 3}]},
        {"applications": [{"name": "a", "import_path": "m:x",
                           "deployments": [{"name": "d",
                                            "num_replicas": -1}]}]},
    ]
    out = []
    for cfg in bad:
        try:
            parse(cfg)
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    return out


def _yaml(apps: list[tuple[str, str, str, int | None]]) -> str:
    text = "applications:\n"
    for name, prefix, target, replicas in apps:
        text += (f"  - name: {name}\n    route_prefix: {prefix}\n"
                 f"    import_path: {__name__}:{target}\n")
        if replicas is not None:
            text += (f"    deployments:\n      - name: Adder\n"
                     f"        num_replicas: {replicas}\n")
    return text


def yaml_import_path(rt):
    serve = _serve(rt)
    tmp = tempfile.mkdtemp(prefix="torch_serve_programs_")
    try:
        path = os.path.join(tmp, "serve.yaml")
        with open(path, "w") as f:
            f.write(_yaml([("echo", "/echo", f"{rt.__name__}_echo_app",
                            None)]).replace(
                "    import_path", "    deployments:\n      - name: Echo\n"
                "        num_replicas: 2\n    import_path"))
        schema = _sub(rt, "serve.schema").load_config(path)
    finally:
        shutil.rmtree(tmp)
    app = schema.applications[0]
    return [app.name, app.route_prefix, app.deployments[0].num_replicas,
            isinstance(app.import_target(), serve.Application)]


def deploy_config_roundtrip(rt):
    """Two apps from YAML; a second config drops one (it drains away) and
    rescales the other."""
    serve = _serve(rt)
    tmp = tempfile.mkdtemp(prefix="torch_serve_programs_")
    try:
        v1, v2 = os.path.join(tmp, "v1.yaml"), os.path.join(tmp, "v2.yaml")
        with open(v1, "w") as f:
            f.write(_yaml([("echo", "/echo", f"{rt.__name__}_echo_app", None),
                           ("adder", "/add", f"{rt.__name__}_adder_app", 2)]))
        with open(v2, "w") as f:
            f.write(_yaml([("adder", "/add", f"{rt.__name__}_adder_app", 1)]))
        handles = serve.deploy_config(v1)
        out = [sorted(handles),
               rt.get(handles["adder"].remote({"v": 37}), timeout=60),
               rt.get(handles["echo"].remote(1), timeout=60),
               serve.status()["controller"],
               serve.status()["deployments"]["Adder"]["desired"]]
        handles2 = serve.deploy_config(v2)

        def drained():
            deps = serve.status()["deployments"]
            return ("Echo" not in deps
                    and deps.get("Adder", {}).get("desired") == 1)
        out += [sorted(handles2), _wait_until(drained, 60, 0.1),
                rt.get(handles2["adder"].remote({"v": 1}), timeout=60),
                _reaped(rt, 1)]
    finally:
        shutil.rmtree(tmp)
    return out


def deploy_config_override(rt):
    """A dict config with the injectable import hook."""
    serve = _serve(rt)
    local = serve.deployment(name="Local")(type("LocalCls", (), {
        "__call__": lambda self, x: {"ok": x}}))
    handles = serve.deploy_config(
        {"applications": [{"name": "app", "import_path": "ignored:ignored",
                           "deployments": [{"name": "Local",
                                            "num_replicas": 1}]}]},
        _import_override=lambda schema: local.bind())
    return rt.get(handles["app"].remote(3), timeout=60)


def deploy_config_user_config(rt):
    """A config's user_config reaches the replica; a change of it alone
    reconfigures the same replica object."""
    serve = _serve(rt)

    @serve.deployment(name="Cfg")
    class Cfg:
        def __init__(self):
            self.val = None
            self.ident = id(self)

        def reconfigure(self, config):
            self.val = config["val"]

        def __call__(self, _):
            return (self.val, self.ident)

    app = Cfg.bind()

    def config(val):
        return {"applications": [
            {"name": "cfgapp", "import_path": "ignored:ignored",
             "deployments": [{"name": "Cfg", "num_replicas": 1,
                              "user_config": {"val": val}}]}]}

    v1, ident1 = serve.deploy_config(config(1), _import_override=lambda s: app)[
        "cfgapp"].remote(0).result(timeout_s=60)
    v2, ident2 = serve.deploy_config(config(2), _import_override=lambda s: app)[
        "cfgapp"].remote(0).result(timeout_s=60)
    return [v1, v2, ident1 == ident2]


def rest_deploy_calls(rt):
    """What the dashboard's REST deploy (``PUT /api/serve/applications``)
    does with its JSON body: ``deploy_config(dict)``, then ``status()`` on
    GET, and a ValueError naming the field (its 400) for a bad config:
    the Serve calls the dashboard makes. The route itself, over HTTP, is
    the ``rest_deploy`` program of tests/torch_ops_programs.py."""
    serve = _serve(rt)
    body = json.loads(json.dumps({"applications": [
        {"name": "echo", "route_prefix": "/echo",
         "import_path": f"{__name__}:{rt.__name__}_echo_app"}]}))
    handles = serve.deploy_config(body)
    out = [sorted(handles),
           rt.get(serve.get_deployment_handle("Echo").remote(5), timeout=60),
           "Echo" in serve.status()["deployments"]]
    try:
        serve.deploy_config(json.loads(b'{"applications": []}'))
        out.append("accepted")
    except ValueError as e:
        out.append("applications" in str(e))
    return out


# -- gRPC ingress -------------------------------------------------------------

_PICKLE_MD = ("ray-content-type", "application/x-pickle")
_GRPC_METHOD = "/ray_tpu.serve.RayServeAPIService/"


def _grpc_unary(port, method, payload, metadata=(), token=None,
                wire="pickle"):
    import grpc
    if wire == "pickle":
        body = pickle.dumps(payload)
        md = metadata + (_PICKLE_MD, ("ray-auth-token", token or ""))
    else:
        body = json.dumps(payload).encode()
        md = metadata + (("ray-content-type", "application/json"),)

    async def go():
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            out = await ch.unary_unary(_GRPC_METHOD + method)(
                body, metadata=md, timeout=60)
            return pickle.loads(out) if wire == "pickle" else json.loads(out)
    return asyncio.new_event_loop().run_until_complete(go())


def _grpc_error(fn) -> str:
    """The status code of a failed call (or "answered")."""
    try:
        fn()
        return "answered"
    except Exception as e:  # noqa: BLE001 — a grpc.aio.AioRpcError
        return e.code().name if hasattr(e, "code") else type(e).__name__


def grpc_ingress(rt):
    """Unary (pickle with the token, JSON without), a named method,
    application metadata, unknown application, refused pickle, and server
    streaming."""
    import grpc
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            return {"echo": x, "n": 2 * x if isinstance(x, int) else x}

        def shout(self, x):
            return str(x).upper()

        def counts(self, n):
            for i in range(n):
                yield {"i": i}

    port = free_port()
    serve.run(Echo.bind(), grpc_port=port)
    token = serve.grpc_ingress_token()
    out = [_grpc_unary(port, "__call__", 21, token=token),
           _grpc_unary(port, "__call__", 21, wire="json"),
           _grpc_error(lambda: _grpc_unary(port, "__call__", 21, token="")),
           _grpc_error(lambda: _grpc_unary(port, "__call__", 21,
                                           token="deadbeef" * 4)),
           _grpc_unary(port, "shout", "quiet", token=token),
           _grpc_unary(port, "__call__", 1, (("application", "/"),),
                       token=token)["n"],
           _grpc_error(lambda: _grpc_unary(
               port, "__call__", 1, (("application", "/nope"),),
               token=token))]

    async def stream():
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            rpc = ch.unary_stream(_GRPC_METHOD + "countsStreaming")
            return [pickle.loads(m) async for m in rpc(
                pickle.dumps(4), metadata=(_PICKLE_MD,
                                           ("ray-auth-token", token)),
                timeout=60)]
    out.append(asyncio.new_event_loop().run_until_complete(stream()))
    return out


# -- fault classification and transport goldens --------------------------------


def classifications(rt):
    ex = _sub(rt, "serve.exceptions")
    core = _sub(rt, "core.exceptions")
    errors = [ex.ReplicaStoppingError("x"), ex.ReplicaOverloadedError("x"),
              ex.DeploymentOverloadedError("x"),
              ex.RequestRetriesExhaustedError("x"),
              ex.RequestDeadlineError("x"), ValueError("user bug"),
              core.GetTimeoutError("t"), core.ActorDiedError("gone"),
              ConnectionResetError("wire"), EOFError()]
    out = [[type(e).__name__, ex.classify(e), ex.is_retryable(e)]
           for e in errors]
    out.append(isinstance(core.GetTimeoutError("t"), OSError))
    for tb in ("... ReplicaStoppingError: stopping",
               "... ReplicaOverloadedError: full",
               "... RequestDeadlineError: expired",
               "... ActorDiedError: died mid-exec", "... ValueError: user bug"):
        e = core.TaskError("handle_request", tb)
        out.append([getattr(e, "traceback_str", None) == tb, ex.classify(e)])
    return out


def transport_goldens(rt):
    """The HTTP answer and the gRPC status code of each failure."""
    ex = _sub(rt, "serve.exceptions")
    error_response = _sub(rt, "serve.proxy").error_response
    grpc_code_name = _sub(rt, "serve.grpc_proxy").grpc_code_name
    errors = [ex.DeploymentOverloadedError("every replica shed"),
              ex.RequestRetriesExhaustedError("budget gone"),
              ex.ReplicaOverloadedError("x"), ex.RequestDeadlineError("expired"),
              ValueError("user bug")]
    out = []
    for e in errors:
        status, headers, body = error_response(e)
        out.append([status, sorted(headers.items()), body,
                    grpc_code_name(e)])
    status, headers, _ = error_response(ex.RequestDeadlineError("x"), "rid-1")
    out.append([status, sorted(headers.items())])
    return out


def timeout_knobs(rt):
    """The serve knobs' defaults and their ``RAY_TPU_`` overrides."""
    Config = _sub(rt, "core.config").Config
    names = ("serve_longpoll_timeout_s", "serve_refresh_timeout_s",
             "serve_queue_probe_timeout_s", "serve_request_max_retries",
             "serve_retry_enabled", "serve_max_queue_len_per_replica",
             "serve_proxy_max_inflight",
             "serve_health_check_failure_threshold",
             "serve_replica_startup_timeout_s")
    out = [[n, getattr(Config(), n)] for n in names]
    os.environ["RAY_TPU_SERVE_LONGPOLL_TIMEOUT_S"] = "7.5"
    os.environ["RAY_TPU_SERVE_REQUEST_MAX_RETRIES"] = "9"
    try:
        env = Config.from_env()
        out.append([env.serve_longpoll_timeout_s,
                    env.serve_request_max_retries])
    finally:
        del os.environ["RAY_TPU_SERVE_LONGPOLL_TIMEOUT_S"]
        del os.environ["RAY_TPU_SERVE_REQUEST_MAX_RETRIES"]
    return out


# -- the replica's ledger and admission ----------------------------------------


class Counting:
    """A replica class that counts its executions."""

    def __init__(self):
        self.n = 0

    def __call__(self, x):
        self.n += 1
        return {"x": x, "execution": self.n}

    def boom(self, x):
        self.n += 1
        raise ValueError(f"boom on execution {self.n}")

    def count(self):
        return self.n


def _replica(rt, tag: str):
    Replica = _sub(rt, "serve.replica").Replica
    return Replica.options(num_cpus=0, max_concurrency=8).remote(
        Counting, (), {}, tag)


def _call(rt, r, method, args=(), **kw):
    return rt.get(r.handle_request.remote(method, args, {}, **kw), timeout=60)


def ledger_dedupe(rt):
    """A re-dispatch under the same request id is answered from the
    ledger; a fresh id executes."""
    r = _replica(rt, "dep#ledger")
    out = [_call(rt, r, "__call__", (7,), request_id="req-1"),
           _call(rt, r, "__call__", (7,), request_id="req-1"),
           _call(rt, r, "count", request_id="req-2"),
           _call(rt, r, "__call__", (7,), request_id="req-3")["execution"]]
    rt.kill(r)
    return out


def ledger_replays_errors(rt):
    r = _replica(rt, "dep#ledger_err")
    out = []
    for _ in range(2):
        try:
            _call(rt, r, "boom", (0,), request_id="req-err")
            out.append("answered")
        except rt.TaskError as e:
            out.append("boom on execution 1" in str(e))
    out.append(_call(rt, r, "count", request_id="req-c"))
    rt.kill(r)
    return out


def admission_gates(rt):
    """An expired deadline is shed before user code; a stopping replica
    sheds new requests once its grace has passed."""
    r = _replica(rt, "dep#gates")
    try:
        _call(rt, r, "__call__", (1,), request_id="req-d",
              deadline_ts=time.time() - 1.0)
        out = ["answered"]
    except rt.TaskError as e:
        out = ["RequestDeadlineError" in str(e)]
    out.append(_call(rt, r, "count"))
    rt.get(r.prepare_stop.remote(), timeout=60)
    seen = {"i": 0}

    def sheds():
        seen["i"] += 1
        try:
            _call(rt, r, "__call__", (1,), request_id=f"req-s-{seen['i']}")
            return False
        except rt.TaskError as e:
            return "ReplicaStoppingError" in (e.traceback_str or "")
    out.append(_wait_until(sheds, 30, 0.1))
    rt.kill(r)
    return out


# -- the health plane ----------------------------------------------------------


def readiness_gating(rt):
    """A replica whose health check fails takes no traffic; it joins the
    routing set once the check passes."""
    serve = _serve(rt)
    tmp = tempfile.mkdtemp(prefix="torch_serve_programs_")
    flag = os.path.join(tmp, "ready")

    @serve.deployment(num_replicas=1)
    class Gated:
        def __init__(self, flag_path):
            self.flag = flag_path

        def check_health(self):
            if not os.path.exists(self.flag):
                raise RuntimeError("warming up")

        def __call__(self, x):
            return "ok"

    done = {}
    t = threading.Thread(target=lambda: done.update(
        handle=serve.run(Gated.bind(flag))), daemon=True)
    t.start()
    controller = [None]

    def found():
        try:
            controller[0] = _controller(rt)
            return True
        except Exception:  # noqa: BLE001 — controller still booting
            return False
    _wait_until(found, 30)
    routed, starting = [], []
    for _ in range(10):
        info = rt.get(controller[0].list_deployments.remote(),
                      timeout=10).get("Gated", {})
        routed.append(info.get("num_replicas", 0))
        starting.append(info.get("starting", 0) >= 1)
        time.sleep(0.1)
    open(flag, "w").close()
    t.join(timeout=60)
    shutil.rmtree(tmp)
    return [max(routed), any(starting), t.is_alive(),
            done["handle"].remote(1).result(timeout_s=60)]


def health_ejection(rt):
    """Failing probes eject a replica; the controller respawns one and
    traffic reaches it."""
    serve = _serve(rt)
    tmp = tempfile.mkdtemp(prefix="torch_serve_programs_")
    poison = os.path.join(tmp, "poison_pid")

    @serve.deployment(num_replicas=1)
    class Flappy:
        def __init__(self, poison_path):
            self.poison = poison_path

        def check_health(self):
            if os.path.exists(self.poison):
                with open(self.poison) as f:
                    if int(f.read()) == os.getpid():
                        raise RuntimeError("degraded")

        def __call__(self, x):
            return os.getpid()

    handle = serve.run(Flappy.bind(poison))
    pid0 = handle.remote(0).result(timeout_s=60)
    controller = _controller(rt)
    with open(poison, "w") as f:
        f.write(str(pid0))
    alive = set()

    def replaced():
        alive.clear()
        alive.update(rt.get(controller.replica_pids.remote("Flappy"),
                            timeout=10).values())
        return bool(alive) and pid0 not in alive
    out = [_wait_until(replaced, 45, 0.1)]
    out.append(handle.remote(1).result(timeout_s=60) in alive - {pid0})
    shutil.rmtree(tmp)
    return out


# -- HTTP shedding and deadlines -----------------------------------------------


def _fire(url: str, bodies: list[bytes]) -> list[tuple]:
    """POST each body from its own thread at once: (status, Retry-After)."""
    results = []
    lock = threading.Lock()

    def fire(body):
        status, headers, _ = _http(url, body, method="POST")
        with lock:
            results.append((status, headers.get("Retry-After")))

    threads = [threading.Thread(target=fire, args=(b,)) for b in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    return results + [("hung", None)] * sum(t.is_alive() for t in threads)


def _sheds(results: list[tuple]) -> list:
    """(only 200 and 503, some 200, some 503, every 503 with Retry-After 1)."""
    statuses = {s for s, _ in results}
    return [statuses <= {200, 503}, 200 in statuses, 503 in statuses,
            all(ra == "1" for s, ra in results if s == 503)]


def http_overload_and_deadline(rt):
    """A request past its X-Request-Timeout-S is a 504; past a one-slot
    replica's capacity requests are a fast 503 with Retry-After."""
    serve = _serve(rt)

    @serve.deployment(num_replicas=1, max_ongoing_requests=1)
    class Slow:
        def __call__(self, x):
            time.sleep(float(x.get("sleep", 0)) if isinstance(x, dict) else 0)
            return {"ok": True}

    port = free_port()
    serve.run(Slow.bind(), http_port=port)
    url = f"http://127.0.0.1:{port}/"
    status, _, body = _http(url, json.dumps({"sleep": 1.0}).encode(),
                            {"X-Request-Timeout-S": "0.2"}, "POST")
    out = [status, b"deadline" in body]
    time.sleep(1.1)                 # the slot frees when that sleep ends
    return out + _sheds(_fire(url, [json.dumps({"sleep": 1.0}).encode()] * 5))


def proxy_inflight_cap(rt):
    """A proxy at its in-flight cap answers 503 before routing."""
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Hold:
        def __call__(self, x):
            time.sleep(1.0)
            return "done"

    serve.run(Hold.bind(), http_port=free_port())
    ProxyActor = _sub(rt, "serve.proxy").ProxyActor
    port = free_port()
    capped = ProxyActor.options(num_cpus=0, max_concurrency=32).remote(
        port, max_inflight=1)
    rt.get(capped.ready.remote(), timeout=30)
    rt.get(capped.set_routes.remote({"/": {"name": "Hold", "asgi": False}}))
    out = _sheds(_fire(f"http://127.0.0.1:{port}/", [b"{}"] * 4))
    rt.kill(capped)
    return out


# -- zero loss under faults ----------------------------------------------------


class LoadClient:
    """Client threads calling a handle until stopped; every ``.result()``
    must succeed."""

    def __init__(self, handle, n_threads: int = 3):
        self.handle = handle
        self.stop = threading.Event()
        self.sent = 0
        self.failures: list[str] = []
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._loop, args=(i,),
                                          daemon=True)
                         for i in range(n_threads)]
        for t in self._threads:
            t.start()

    def _loop(self, tid: int):
        i = 0
        while not self.stop.is_set():
            i += 1
            try:
                if self.handle.remote({"v": i}).result(timeout_s=90) is None:
                    raise AssertionError("no answer")
            except Exception as e:  # noqa: BLE001 — tallied
                with self._lock:
                    self.failures.append(f"t{tid} req{i}: "
                                         f"{type(e).__name__}: {e}")
            with self._lock:
                self.sent += 1
            time.sleep(0.02)

    def finish(self, timeout: float = 120.0) -> list:
        """[no failures, no thread hung]."""
        self.stop.set()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        return [self.failures[:3],
                not any(t.is_alive() for t in self._threads)]


def _full_strength(rt, controller, name: str, n: int, dead: set,
                   timeout: float = 30.0) -> list:
    """The ``n`` replicas of ``name`` once the controller lists ``n`` and
    none of them was killed (a killed one respawned), within ``timeout``;
    [] if it does not come to that."""
    live: list = []

    def listed() -> bool:
        _, replicas = rt.get(controller.get_replicas.remote(name),
                             timeout=10)
        live[:] = [r for r in replicas if r.actor_id not in dead]
        return len(live) == n == len(replicas)

    return live if _wait_until(listed, timeout, 0.05) else []


def _said_if_unexpected(program: str, out: list, **detail) -> list:
    """``out``; when it is not ``EXPECTED[program]``, first a line on
    stderr with it and ``detail`` (the counts behind its booleans), so
    that a failure under load names the part that came out wrong."""
    if out != EXPECTED[program]:
        print(f"{program}: outcome {out}, expected {EXPECTED[program]}; "
              + ", ".join(f"{k} {v}" for k, v in detail.items()),
              file=sys.stderr, flush=True)
    return out


def replica_kill_zero_loss(rt):
    """Two replicas killed (``kill``) under load, one after the other: no
    request fails; the controller respawns them. Each step waits for a
    condition, with a deadline, not for a fixed time (fixed pauses came
    out too short on a loaded host): load flowing before the first kill,
    both replicas listed and alive (the first respawned) before the
    second, then more than 30 requests sent and the second respawned."""
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            time.sleep(0.01)
            return {"ok": x}

    handle = serve.run(Echo.bind())
    controller = _controller(rt)
    client = LoadClient(handle)
    _wait_until(lambda: client.sent >= 10, 30, 0.02)
    killed, dead = 0, set()
    for _ in range(2):
        replicas = _full_strength(rt, controller, "Echo", 2, dead)
        if replicas:
            dead.add(replicas[0].actor_id)
            rt.kill(replicas[0])
            killed += 1
    _wait_until(lambda: client.sent > 30, 60, 0.02)
    _full_strength(rt, controller, "Echo", 2, dead)
    sent = client.sent
    return _said_if_unexpected("replica_kill_zero_loss",
                               client.finish() + [killed, sent > 30],
                               killed=killed, sent=sent)


def rolling_redeploy_zero_loss(rt):
    serve = _serve(rt)

    def make_app(version):
        @serve.deployment(name="Roll", num_replicas=2)
        class Roll:
            def __call__(self, x):
                time.sleep(0.01)
                return version
        return Roll.bind()

    handle = serve.run(make_app("v1"), name="roll")
    client = LoadClient(handle)
    _wait_until(lambda: client.sent >= 10, 30, 0.02)
    serve.run(make_app("v2"), name="roll")
    took = _wait_until(
        lambda: handle.remote({}).result(timeout_s=60) == "v2", 60, 0.2)
    _wait_until(lambda: client.sent > 30, 60, 0.02)
    sent = client.sent
    return _said_if_unexpected(
        "rolling_redeploy_zero_loss",
        client.finish() + [took, sent > 30, _reaped(rt, 2)], sent=sent)


def autoscale_down_zero_loss(rt):
    serve = _serve(rt)

    @serve.deployment(
        num_replicas=2,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 2.0,
                            "upscale_delay_s": 0.0,
                            "downscale_delay_s": 0.3,
                            "look_back_period_s": 1.0})
    class Worky:
        def __call__(self, x):
            time.sleep(0.05)
            return "ok"

    handle = serve.run(Worky.bind())
    controller = _controller(rt)
    client = LoadClient(handle, n_threads=2)

    def shrunk():
        info = rt.get(controller.list_deployments.remote(), timeout=10)
        return (info["Worky"]["desired"], info["Worky"]["num_replicas"]) \
            == (1, 1)
    done = _wait_until(shrunk, 25, 0.1)
    return _said_if_unexpected("autoscale_down_zero_loss",
                               client.finish() + [done, _reaped(rt, 1)],
                               sent=client.sent)


def overload_sheds_never_hangs(rt):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1, max_ongoing_requests=2)
    class Busy:
        def __call__(self, x):
            time.sleep(0.5)
            return "ok"

    port = free_port()
    serve.run(Busy.bind(), http_port=port)
    results = _fire(f"http://127.0.0.1:{port}/", [b"{}"] * 12)
    return [len(results)] + _sheds(results)[:1] + _sheds(results)[2:]


# -- GPT-2 behind a deployment --------------------------------------------------


def gpt2_server(rt):
    """The GPT-2 deployment class of package ``rt`` (user code), on
    chip_smoke.py's ``pad_batch`` and, on the port, its ``last_logits``,
    the functions of phase 17's ``GPT2Server``: each ``@serve.batch``
    batch is one forward of the right-padded batch, and each request gets
    back its last valid position's float32 logits, the top-1 id, the
    batch's signature (request ids in order, padded T) and, on the port,
    the flash-kernel launches of that forward. The JAX package's runs its
    flax GPT-2 tiny in float32 on the CPU; the port's runs ``models.GPT2``
    on ``device`` (the card by default). The methods import chip_smoke
    (and with it torch) where they run: in a GPT-2 replica's worker, not
    in the controller that unpickles the class."""
    serve = _serve(rt)
    port = rt.__name__ == "ray_tpu_torch"

    class GPT2Server:
        def __init__(self, weights, size: str = "tiny",
                     dtype: str = "float32", device=None,
                     left_pad: bool = False):
            self.left_pad = left_pad
            weights = rt.get(weights)
            if not port:
                import jax.numpy as jnp

                from ray_tpu.models import GPT2, GPT2Config
                self.model = GPT2(getattr(GPT2Config, size)(
                    dtype=getattr(jnp, dtype)))
                self.params = weights
                return
            import torch

            from ray_tpu_torch.models import GPT2, GPT2Config
            from ray_tpu_torch.ops.cuda import flash_attention as fa
            self.fa = fa
            self.model = GPT2(getattr(GPT2Config, size)(
                dtype=getattr(torch, dtype)), device=device)
            if self.model.wte.weight.device.type == "cpu":
                torch.set_num_threads(1)      # as every CPU parity test
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    p.copy_(torch.from_numpy(np.array(weights[n])))

        def _forward(self, tokens, last):
            if not port:
                logits = self.model.apply({"params": self.params}, tokens)
                return np.asarray(logits)[np.arange(len(last)), last], {}
            import torch
            from chip_smoke import last_logits
            dev = self.model.wte.weight.device
            before = self.fa.launch_counts()
            with torch.inference_mode():
                out = last_logits(self.model, torch.from_numpy(tokens).to(dev),
                                  torch.from_numpy(last).to(dev))
                out = out.cpu().numpy()
            after = self.fa.launch_counts()
            return out, {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01)
        def forward(self, reqs):
            from chip_smoke import pad_batch
            tokens, last = pad_batch([r["tokens"] for r in reqs],
                                     self.left_pad)
            logits, launches = self._forward(tokens, last)
            sig = {"ids": [r["id"] for r in reqs], "T": tokens.shape[1],
                   "pid": os.getpid()}
            return [{"id": r["id"], "logits": logits[i],
                     "top1": int(np.argmax(logits[i])), "batch": sig,
                     "launches": launches} for i, r in enumerate(reqs)]

        def __call__(self, request):
            return self.forward(request)

    return GPT2Server


class CardView:
    """A replica class that reports what its worker sees of the cards."""

    def __call__(self, _):
        import ray_tpu_torch
        return {"cuda": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "gpu_ids": ray_tpu_torch.get_gpu_ids(), "pid": os.getpid()}


# -- the table -----------------------------------------------------------------


API = {f.__name__: f for f in (
    handle_basic, replicas_balance, composition, deployment_response,
    objectref_args, batching, batch_error_reaches_every_caller,
    respawn_after_death, zero_controller_rpcs, compat_surface,
    user_config_in_place, user_config_without_reconfigure,
    redeploy_new_code, http_ingress_and_404, asgi_ingress, asgi_lifespan,
    asgi_startup_loop, autoscaling_policy, autoscaling_end_to_end,
    multiplex_lru, multiplex_end_to_end, schema_errors, yaml_import_path,
    deploy_config_roundtrip, deploy_config_override,
    deploy_config_user_config, rest_deploy_calls, grpc_ingress)}

FAULTS = {f.__name__: f for f in (
    classifications, transport_goldens, timeout_knobs,
    multiplex_pinned_eviction, multiplex_load_failure,
    streaming_multiplexed_no_pin, ledger_dedupe, ledger_replays_errors,
    admission_gates, readiness_gating, health_ejection,
    http_overload_and_deadline, proxy_inflight_cap, replica_kill_zero_loss,
    rolling_redeploy_zero_loss, autoscale_down_zero_loss,
    overload_sheds_never_hangs)}


def run(program, rt) -> tuple:
    """("ok", result) or ("raised", class name, message); Serve is shut
    down after each program."""
    try:
        return ("ok", program(rt))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))
    finally:
        _serve(rt).shutdown()


def run_table(name: str, table: dict) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``, in one runtime of ``num_cpus=4``."""
    rt = importlib.import_module(name)
    rt.init(num_cpus=4)
    try:
        return {prog: run(fn, rt) for prog, fn in table.items()}
    finally:
        rt.shutdown()


_ZERO_LOSS = [[], True]
# What each program must give (the same on both packages, and right).
EXPECTED = {
    "handle_basic": {"doubled": 42},
    "replicas_balance": 2,
    "composition": {"score": 50},
    "deployment_response": [True, 42, 3, 21, 20, 14],
    "objectref_args": [("ref", 123), ("value", ("ref", 123))],
    "batching": [[0, 1, 2, 3], True],
    "batch_error_reaches_every_caller": [True, True, True],
    "respawn_after_death": ["alive", True],
    "zero_controller_rpcs": ["warm", True, 0],
    "compat_surface": [{"who": "CompatApp", "tag": True, "x": 7}, True,
                       False, False],
    "user_config_in_place": [True, False, True],
    "user_config_without_reconfigure": [
        "ValueError", "deployment 'noreconf' has a user_config but "
        "'NoReconf' defines no reconfigure(config) method"],
    "redeploy_new_code": ["v1", "v2", True],
    "http_ingress_and_404": [200, {"echo": {"msg": "hi"}, "ok": True}, 404],
    "asgi_ingress": [200, "ray-tpu", {"path": "/echo", "method": "POST",
                                      "query": "who=tpu", "body": "ping"},
                     418, b"short and stout"],
    "asgi_lifespan": [True, ["lifespan.startup"], True,
                      ["lifespan.startup", "lifespan.shutdown"], False,
                      False, True],
    "asgi_startup_loop": b"same-loop",
    "autoscaling_policy": [4, 1, 4, 4],
    "autoscaling_end_to_end": [True, True, True],
    "multiplex_lru": [True, 1, ["a", "b"], ["b", "c"], ["a"], 3],
    "multiplex_end_to_end": ["m1", "m1", "m2", "m1", True],
    "schema_errors": [
        "config root: 'applications' must be a non-empty list",
        "applications[0].import_path: expected 'module:attribute', got "
        "'no_colon'",
        "applications[0].route_prefix: must start with '/', got 'bad'",
        "applications: duplicate names in ['a', 'a']",
        "applications[0]: unknown field(s) ['replicas']",
        "applications[0].deployments[0].num_replicas: expected int >= 0, "
        "got -1"],
    "yaml_import_path": ["echo", "/echo", 2, True],
    "deploy_config_roundtrip": [["adder", "echo"], {"sum": 42},
                                {"echo": 1}, "RUNNING", 2, ["adder"], True,
                                {"sum": 6}, True],
    "deploy_config_override": {"ok": 3},
    "deploy_config_user_config": [1, 2, True],
    "rest_deploy_calls": [["echo"], {"echo": 5}, True, True],
    "grpc_ingress": [{"echo": 21, "n": 42}, {"echo": 21, "n": 42},
                     "UNAUTHENTICATED", "UNAUTHENTICATED", "QUIET", 2,
                     "NOT_FOUND", [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]],
    "classifications": [
        ["ReplicaStoppingError", "replica_busy", True],
        ["ReplicaOverloadedError", "replica_busy", True],
        ["DeploymentOverloadedError", "overload", False],
        ["RequestRetriesExhaustedError", "overload", False],
        ["RequestDeadlineError", "deadline", False],
        ["ValueError", "error", False],
        ["GetTimeoutError", "error", False],
        ["ActorDiedError", "replica_died", True],
        ["ConnectionResetError", "replica_died", True],
        ["EOFError", "replica_died", True],
        True,
        [True, "replica_busy"], [True, "replica_busy"], [True, "deadline"],
        [True, "replica_died"], [True, "error"]],
    "transport_goldens": [
        [503, [("Retry-After", "1")],
         {"error": "overloaded", "detail": "every replica shed"},
         "UNAVAILABLE"],
        [503, [("Retry-After", "1")],
         {"error": "overloaded", "detail": "budget gone"}, "UNAVAILABLE"],
        [503, [("Retry-After", "1")], {"error": "overloaded", "detail": "x"},
         "UNAVAILABLE"],
        [504, [], {"error": "deadline exceeded", "detail": "expired"},
         "DEADLINE_EXCEEDED"],
        [500, [], {"error": "user bug"}, "INTERNAL"],
        [504, [("X-Request-Id", "rid-1")]]],
    "timeout_knobs": [
        ["serve_longpoll_timeout_s", 60.0], ["serve_refresh_timeout_s", 30.0],
        ["serve_queue_probe_timeout_s", 5.0],
        ["serve_request_max_retries", 3], ["serve_retry_enabled", True],
        ["serve_max_queue_len_per_replica", 64],
        ["serve_proxy_max_inflight", 256],
        ["serve_health_check_failure_threshold", 3],
        ["serve_replica_startup_timeout_s", 60.0], [7.5, 9]],
    "multiplex_pinned_eviction": [["a", "c"], ["b"], False, ["b"],
                                  ["b", "a"], True, ["b", "a"]],
    "multiplex_load_failure": [
        ["ModelLoadError", True, True], [], {"id": "m1"}, ["m1", "m1"]],
    "streaming_multiplexed_no_pin": [[["mA:0", "mA:1", "mA:2"]] * 2, {}],
    "ledger_dedupe": [{"x": 7, "execution": 1}, {"x": 7, "execution": 1},
                      1, 2],
    "ledger_replays_errors": [True, True, 1],
    "admission_gates": [True, 0, True],
    "readiness_gating": [0, True, False, "ok"],
    "health_ejection": [True, True],
    "http_overload_and_deadline": [504, True, True, True, True, True],
    "proxy_inflight_cap": [True, True, True, True],
    "replica_kill_zero_loss": _ZERO_LOSS + [2, True],
    "rolling_redeploy_zero_loss": _ZERO_LOSS + [True, True, True],
    "autoscale_down_zero_loss": _ZERO_LOSS + [True, True],
    "overload_sheds_never_hangs": [12, True, True, True],
}
