"""DAG and compiled-DAG user programs, each run once on ``ray_tpu`` and
once on ``ray_tpu_torch`` (tests/test_torch_dag.py).

Every program takes the package module (``rt``) and uses its public API
(``bind``, ``dag.InputNode``, ``experimental_compile``,
``experimental.channel``), plus a compiled DAG's ``_mode`` and channel
lists where a program checks which path was taken, so the same code runs
on both. The ``TABLE`` programs run in one runtime a package; the
``ALONE`` program starts a ``cluster_utils.Cluster`` of its own. Nothing
here imports either package at module level: a worker that unpickles
one of these functions loads numpy (torch where a program sends a
tensor) and the package it runs in, and nothing of the other. Waits are
on conditions with deadlines.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import tempfile
import time

import numpy as np

from torch_parity import table_run


def _mod(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _input_node(rt):
    return _mod(rt, "dag").InputNode()


def _until(cond, timeout: float, what: str, period: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(period)
    raise TimeoutError(f"{what} within {timeout}s")


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    # A zombie child still answers kill(0) until it is reaped.
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in "ZX"
    except OSError:
        return True


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _raised(fn) -> tuple:
    """(class name, message) of what ``fn()`` raises, or ("", value)."""
    try:
        return ("", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


# -- uncompiled DAGs -------------------------------------------------------


def function_dag(rt):
    """``add(double(x), x)``, executed twice."""
    @rt.remote(num_cpus=0.25)
    def double(x):
        return 2 * x

    @rt.remote(num_cpus=0.25)
    def add(a, b):
        return a + b

    with _input_node(rt) as inp:
        dag = add.bind(double.bind(inp), inp)
    return [rt.get(dag.execute(5)), rt.get(dag.execute(7)),
            type(dag).__name__]


def diamond_shares_upstream(rt):
    """A diamond runs its shared upstream once an execute: ``src`` logs
    each run to a file."""
    log = tempfile.mkdtemp(prefix="dag_diamond_")

    @rt.remote(num_cpus=0.25)
    def src(x, log):
        with open(os.path.join(log, f"src-{os.getpid()}-{time.time_ns()}"),
                  "w"):
            pass
        return x + 1

    @rt.remote(num_cpus=0.25)
    def left(v):
        return v * 2

    @rt.remote(num_cpus=0.25)
    def right(v):
        return v * 3

    @rt.remote(num_cpus=0.25)
    def join(a, b):
        return a + b

    with _input_node(rt) as inp:
        s = src.bind(inp, log)
        dag = join.bind(left.bind(s), right.bind(s))
    out = [rt.get(dag.execute(1)), rt.get(dag.execute(4))]
    runs = len(os.listdir(log))
    for name in os.listdir(log):
        os.unlink(os.path.join(log, name))
    os.rmdir(log)
    return out + [runs]


def multi_output(rt):
    """``MultiOutputNode`` gives one ref an output, in order."""
    @rt.remote(num_cpus=0.25)
    def inc(x):
        return x + 1

    @rt.remote(num_cpus=0.25)
    def dec(x):
        return x - 1

    with _input_node(rt) as inp:
        dag = _mod(rt, "dag").MultiOutputNode([inc.bind(inp), dec.bind(inp)])
    return rt.get(dag.execute(10))


def input_attribute(rt):
    """``inp[0]``, ``inp[1]`` from positional inputs and ``inp.x``,
    ``inp.y`` from keywords."""
    @rt.remote(num_cpus=0.25)
    def mul(a, b):
        return a * b

    with _input_node(rt) as inp:
        dag = mul.bind(inp[0], inp[1])
    with _input_node(rt) as inp:
        dag2 = mul.bind(inp.x, inp.y)
    return [rt.get(dag.execute(3, 4)), rt.get(dag2.execute(x=5, y=6)),
            type(inp.x).__name__]


def actor_nodes_uncompiled(rt):
    """A live actor's method keeps its state across executes; a bound
    class makes a fresh actor each execute."""
    @rt.remote(num_cpus=0.25)
    class Acc:
        def __init__(self, start):
            self.v = start

        def bump(self, x):
            self.v += x
            return self.v

    live = Acc.remote(0)
    with _input_node(rt) as inp:
        on_live = live.bump.bind(inp)
    with _input_node(rt) as inp:
        fresh = Acc.bind(100).bump.bind(inp)
    out = [rt.get(on_live.execute(2)), rt.get(on_live.execute(3)),
           rt.get(fresh.execute(1)), rt.get(fresh.execute(2)),
           [type(n).__name__ for n in (on_live, fresh, Acc.bind(1))]]
    rt.kill(live)
    return out


# -- compiled DAGs ---------------------------------------------------------


def compiled_reuses_actor(rt):
    """One pre-created actor for the compiled DAG: its state
    accumulates, in channel mode."""
    @rt.remote(num_cpus=0.25)
    class Acc:
        def __init__(self, start):
            self.v = start

        def bump(self, x):
            self.v += x
            return self.v

    with _input_node(rt) as inp:
        dag = Acc.bind(0).bump.bind(inp)
    cdag = dag.experimental_compile()
    try:
        return [cdag._mode, [rt.get(cdag.execute(i)) for i in (1, 2, 3)]]
    finally:
        cdag.teardown()


def pipeline_in_flight(rt):
    """Two stages, eight executes in flight before the first get (the
    depth-1 channels pipeline them), then the outputs in order."""
    @rt.remote(num_cpus=0.25)
    class Stage:
        def __init__(self, k):
            self.k = k

        def fwd(self, x):
            return x + self.k

    with _input_node(rt) as inp:
        dag = Stage.bind(10).fwd.bind(Stage.bind(1).fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        refs = [cdag.execute(i) for i in range(8)]
        return [cdag._mode, rt.get(refs)]
    finally:
        cdag.teardown()


def task_mode_fallbacks(rt):
    """Function nodes compile to task mode; so does a live handle's
    method (channel mode would take its only slot), and the actor stays
    usable."""
    @rt.remote(num_cpus=0.25)
    def f(x):
        return x + 1

    @rt.remote(num_cpus=0.25)
    class L:
        def f(self, x):
            return x * 3

    with _input_node(rt) as inp:
        dag = f.bind(f.bind(inp))
    cdag = dag.experimental_compile()
    try:
        fn = [cdag._mode, rt.get(cdag.execute(1)), rt.get(cdag.execute(5))]
    finally:
        cdag.teardown()
    h = L.remote()
    with _input_node(rt) as inp:
        dag = h.f.bind(inp)
    cdag = dag.experimental_compile()
    try:
        live = [cdag._mode, rt.get(cdag.execute(2)), rt.get(h.f.remote(1))]
    finally:
        cdag.teardown()
    rt.kill(h)
    return [fn, live]


def cross_actor_diamond(rt):
    """Four actors, one input fanning out through two of them and
    joining in the fourth."""
    @rt.remote(num_cpus=0.25)
    class Node:
        def __init__(self, k):
            self.k = k

        def apply(self, *xs):
            return sum(xs) + self.k

    with _input_node(rt) as inp:
        src = Node.bind(1).apply.bind(inp)
        left = Node.bind(0).apply.bind(src)
        right = Node.bind(100).apply.bind(src)
        dag = Node.bind(0).apply.bind(left, right)
    cdag = dag.experimental_compile()
    try:
        return [cdag._mode, rt.get(cdag.execute(0)), rt.get(cdag.execute(5)),
                len(cdag._all_channels)]
    finally:
        cdag.teardown()


def compiled_multi_output(rt):
    """A compiled ``MultiOutputNode`` of two actors and the input."""
    @rt.remote(num_cpus=0.25)
    class W:
        def __init__(self, k):
            self.k = k

        def mul(self, x):
            return x * self.k

    with _input_node(rt) as inp:
        dag = _mod(rt, "dag").MultiOutputNode(
            [W.bind(2).mul.bind(inp), W.bind(3).mul.bind(inp), inp])
    cdag = dag.experimental_compile()
    try:
        return [cdag._mode, rt.get(cdag.execute(5)), rt.get(cdag.execute(7))]
    finally:
        cdag.teardown()


def actor_feeds_and_consumes(rt):
    """a -> b -> a: actor a writes its first node before it blocks on
    b's output."""
    @rt.remote(num_cpus=0.25)
    class T:
        def f(self, x):
            return x + 1

    with _input_node(rt) as inp:
        a = T.bind()
        b = T.bind()
        dag = a.f.bind(b.f.bind(a.f.bind(inp)))
    cdag = dag.experimental_compile()
    try:
        return [cdag._mode, rt.get(cdag.execute(0)), rt.get(cdag.execute(10))]
    finally:
        cdag.teardown()


def error_propagates_and_recovers(rt):
    """A stage that raises ships the error to ``get``; the next execute
    goes through, the pipeline still aligned."""
    @rt.remote(num_cpus=0.25)
    class S:
        def step(self, x):
            if x < 0:
                raise ValueError("negative input")
            return x + 1

    with _input_node(rt) as inp:
        dag = S.bind().step.bind(S.bind().step.bind(inp))
    cdag = dag.experimental_compile()
    try:
        first = rt.get(cdag.execute(1))
        name, msg = _raised(lambda: rt.get(cdag.execute(-5)))
        return [cdag._mode, first, name, "negative input" in msg,
                rt.get(cdag.execute(10))]
    finally:
        cdag.teardown()


def oversized_result_ships_error(rt):
    """A result larger than the channel comes back as an error; the
    loop survives and small results still flow."""
    @rt.remote(num_cpus=0.25)
    class Big:
        def make(self, n):
            return np.zeros(n, dtype=np.float64)

    with _input_node(rt) as inp:
        dag = Big.bind().make.bind(inp)
    cdag = dag.experimental_compile(buffer_size_bytes=1 << 16)
    try:
        name, msg = _raised(lambda: rt.get(cdag.execute(1_000_000)))
        return [cdag._mode, name, "exceeds channel buffer" in msg,
                rt.get(cdag.execute(16)).shape]
    finally:
        cdag.teardown()


def get_timeout_retryable(rt):
    """A ``get`` that times out leaves the ref retrievable."""
    @rt.remote(num_cpus=0.25)
    class Slow:
        def f(self, x):
            time.sleep(1.0)
            return x

    with _input_node(rt) as inp:
        dag = Slow.bind().f.bind(inp)
    cdag = dag.experimental_compile()
    try:
        ref = cdag.execute(9)
        name, _ = _raised(lambda: ref.get(timeout=0.05))
        return [name, ref.get(timeout=30)]
    finally:
        cdag.teardown()


def get_twice_rejected(rt):
    """A ``CompiledDAGRef`` gives its result once."""
    @rt.remote(num_cpus=0.25)
    class R:
        def f(self, x):
            return x

    with _input_node(rt) as inp:
        dag = R.bind().f.bind(inp)
    cdag = dag.experimental_compile()
    try:
        ref = cdag.execute(7)
        first = ref.get(timeout=10)
        name, msg = _raised(ref.get)
        return [first, name, "already retrieved" in msg]
    finally:
        cdag.teardown()


def teardown_unblocks_loops(rt):
    """``teardown`` closes the input channel, so the actor's loop ends,
    and kills the actor: its worker process exits; ``execute`` then
    raises."""
    @rt.remote(num_cpus=0.25)
    class Q:
        def f(self, x):
            return [x, os.getpid()]

    with _input_node(rt) as inp:
        dag = Q.bind().f.bind(inp)
    cdag = dag.experimental_compile()
    handle = cdag._owned_actors[0]
    value, pid = rt.get(cdag.execute(1))
    loops = list(cdag._loop_refs)
    cdag.teardown()
    done = rt.get(loops, timeout=30)
    _until(lambda: handle.state() == "DEAD", 30, "the actor dead")
    _until(lambda: _gone(pid), 30, "the actor's worker gone")
    name, msg = _raised(lambda: cdag.execute(2))
    return [value, done, handle.state(), name, "torn down" in msg]


def payload_bits(rt):
    """A float64 numpy array and a bf16 torch CPU tensor through two
    stages of a compiled DAG: each stage hashes the bits it got; the
    outputs and both hashes are the bits sent."""
    import torch

    @rt.remote(num_cpus=0.25)
    class Pass:
        def fwd(self, x):
            if isinstance(x, dict):
                x = x["value"]
            if hasattr(x, "numpy"):         # a torch tensor
                bits = x.contiguous().view(torch.int16).numpy().tobytes()
                kind = [str(x.dtype), x.device.type, list(x.shape)]
            else:
                bits = np.ascontiguousarray(x).tobytes()
                kind = [str(x.dtype), "numpy", list(x.shape)]
            return {"value": x, "sha": _sha(bits), "kind": kind}

    with _input_node(rt) as inp:
        dag = Pass.bind().fwd.bind(Pass.bind().fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        arr = np.random.default_rng(0).normal(size=(64, 64))
        gen = torch.Generator().manual_seed(0)
        ten = torch.randn(32, 48, generator=gen).to(torch.bfloat16)
        out_a = rt.get(cdag.execute(arr))
        out_t = rt.get(cdag.execute(ten))
        return [cdag._mode,
                out_a["sha"] == _sha(arr.tobytes()), out_a["kind"],
                np.array_equal(out_a["value"], arr),
                out_t["sha"] == _sha(ten.view(torch.int16).numpy().tobytes()),
                out_t["kind"], torch.equal(out_t["value"].view(torch.int16),
                                           ten.view(torch.int16))]
    finally:
        cdag.teardown()


def channel_reads(rt):
    """The raw channel in this process: a depth-1 slot (a second write
    times out until the reader acks); ``begin_read(copy=False)`` hands a
    numpy array out read-only as a view of the slot (the next write
    shows through it), a torch tensor as a copy (the next write leaves it
    alone); ``copy=True`` copies both; a closed channel raises."""
    import torch
    chm = _mod(rt, "experimental.channel")
    ch = chm.Channel(1 << 20)
    try:
        ch.register_reader()
        ch.write(1)
        blocked, _ = _raised(lambda: ch.write(2, timeout=0.2))
        first = ch.read(timeout=5)
        arr = np.arange(256, dtype=np.int64)
        ch.write(arr)
        view, is_err = ch.begin_read(timeout=5, copy=False)
        np_view = [bool(np.array_equal(view, arr)), bool(view.flags.writeable)]
        ch.end_read()
        ch.write(arr + 1000)
        np_view.append(bool(np.array_equal(view, arr + 1000)))  # aliased
        ch.read(timeout=5)
        ten = torch.arange(256, dtype=torch.int64)
        for copy in (False, True):
            ch.write(ten)
            got, _ = ch.begin_read(timeout=5, copy=copy)
            ch.end_read()
            ch.write(ten + 1000)
            ch.read(timeout=5)
            np_view.append([type(got).__name__, bool(torch.equal(got, ten))])
        ch.close()
        closed, _ = _raised(lambda: ch.read(timeout=5))
        return [blocked, first, is_err, np_view, closed]
    finally:
        ch.detach()


def channel_cross_process(rt):
    """An actor attaches the driver's channel by name and reads five
    writes."""
    chm = _mod(rt, "experimental.channel")

    @rt.remote(num_cpus=0.25)
    class Consumer:
        def consume(self, name, n):
            c = chm.Channel(0, name)
            c.register_reader()
            return sum(float(c.read(timeout=10)) for _ in range(n))

    ch = chm.Channel(1 << 20)
    a = Consumer.remote()
    try:
        fut = a.consume.remote(ch.name, 5)
        _until(lambda: ch.reader_count() >= 1, 30, "the reader registered")
        for i in range(5):
            ch.write(float(i), timeout=10)
        return rt.get(fut, timeout=30)
    finally:
        ch.close()
        ch.detach()
        rt.kill(a)


# -- two node daemons ------------------------------------------------------


def comm_channel_between_nodes(rt):
    """Two stages on two node daemons: every edge of the compiled DAG
    rides ``CommChannel`` over the host communicator; two stages on the
    head node keep shared-memory channels."""
    c = _mod(rt, "cluster_utils").Cluster(
        initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        na = c.add_node(num_cpus=2)
        nb = c.add_node(num_cpus=2)
        aff = _mod(rt, "util.scheduling_strategies") \
            .NodeAffinitySchedulingStrategy
        comm = _mod(rt, "dag.comm_channel").CommChannel

        @rt.remote(num_cpus=1)
        class Stage:
            def __init__(self, scale):
                self.scale = scale

            def fwd(self, x):
                return np.asarray(x, dtype=np.float32) * self.scale

        with _input_node(rt) as inp:
            s1 = Stage.options(scheduling_strategy=aff(na.node_id)).bind(2.0)
            s2 = Stage.options(scheduling_strategy=aff(nb.node_id)).bind(10.)
            dag = s2.fwd.bind(s1.fwd.bind(inp))
        cdag = dag.experimental_compile()
        try:
            apart = [cdag._mode, cdag._comm_group is not None,
                     sorted(type(ch).__name__ for ch in cdag._all_channels),
                     all(isinstance(ch, comm)
                         for ch in cdag._out_channels.values())]
            outs = [cdag.execute(np.full((4, 8), float(i), np.float32))
                    .get(timeout=60) for i in range(5)]
            apart.append([float(o.sum()) for o in outs])
        finally:
            cdag.teardown()
        head = aff(_mod(rt, "core.api").get_runtime().head_node_id)
        with _input_node(rt) as inp:
            s1 = Stage.options(num_cpus=0.4, scheduling_strategy=head).bind(3.)
            s2 = Stage.options(num_cpus=0.4, scheduling_strategy=head).bind(4.)
            dag = s2.fwd.bind(s1.fwd.bind(inp))
        cdag = dag.experimental_compile()
        try:
            together = [cdag._mode, cdag._comm_group is None,
                        sorted(type(ch).__name__ for ch in cdag._all_channels),
                        cdag.execute(np.ones(4, np.float32))
                        .get(timeout=60).tolist()]
        finally:
            cdag.teardown()
        return [apart, together]
    finally:
        c.shutdown()


TABLE = {f.__name__: f for f in (
    function_dag, diamond_shares_upstream, multi_output, input_attribute,
    actor_nodes_uncompiled, compiled_reuses_actor, pipeline_in_flight,
    task_mode_fallbacks, cross_actor_diamond, compiled_multi_output,
    actor_feeds_and_consumes, error_propagates_and_recovers,
    oversized_result_ships_error, get_timeout_retryable, get_twice_rejected,
    teardown_unblocks_loops, payload_bits, channel_reads,
    channel_cross_process)}
ALONE = {f.__name__: f for f in (comm_channel_between_nodes,)}


def run(program, rt) -> tuple:
    """("ok", result) or ("raised", class name, message)."""
    try:
        return ("ok", program(rt))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


def run_table(name: str, table: dict) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``, in one runtime of ``num_cpus=4``."""
    rt = importlib.import_module(name)
    with table_run(name):
        rt.init(num_cpus=4)
        try:
            return {prog: run(fn, rt) for prog, fn in table.items()}
        finally:
            rt.shutdown()


def run_alone(name: str, table: dict) -> dict:
    """{program: outcome} of programs that start and stop their own
    cluster, on package ``name``."""
    rt = importlib.import_module(name)
    out = {}
    with table_run(name):
        for prog, fn in table.items():
            out[prog] = run(fn, rt)
            if rt.is_initialized():
                rt.shutdown()
    return out


# What each program must give (the same on both packages, and right).
EXPECTED = {
    "function_dag": [15, 21, "FunctionNode"],
    "diamond_shares_upstream": [10, 25, 2],
    "multi_output": [11, 9],
    "input_attribute": [12, 30, "InputAttributeNode"],
    "actor_nodes_uncompiled": [2, 5, 101, 102, ["ClassMethodNode",
                                                "ClassMethodNode",
                                                "ClassNode"]],
    "compiled_reuses_actor": ["channels", [1, 3, 6]],
    "pipeline_in_flight": ["channels", [i + 11 for i in range(8)]],
    "task_mode_fallbacks": [["tasks", 3, 7], ["tasks", 6, 3]],
    "cross_actor_diamond": ["channels", 102, 112, 5],
    "compiled_multi_output": ["channels", [10, 15, 5], [14, 21, 7]],
    "actor_feeds_and_consumes": ["channels", 3, 13],
    "error_propagates_and_recovers": ["channels", 3, "ActorError", True, 12],
    "oversized_result_ships_error": ["channels", "ActorError", True, (16,)],
    "get_timeout_retryable": ["ChannelTimeoutError", 9],
    "get_twice_rejected": [7, "ValueError", True],
    "teardown_unblocks_loops": [1, ["dag-loop-done"], "DEAD", "RuntimeError",
                                True],
    "payload_bits": ["channels", True, ["float64", "numpy", [64, 64]], True,
                     True, ["torch.bfloat16", "cpu", [32, 48]], True],
    "channel_reads": ["ChannelTimeoutError", 1, False,
                      [True, False, True, ["Tensor", True],
                       ["Tensor", True]], "ChannelClosedError"],
    "channel_cross_process": 10.0,
    "comm_channel_between_nodes": [
        ["channels", True, ["CommChannel"] * 3, True,
         [float(i) * 20.0 * 32 for i in range(5)]],
        ["channels", True, ["Channel"] * 3, [12.0] * 4]],
}
