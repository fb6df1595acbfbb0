"""Compiled DAG execution — the aDAG analog.

Counterpart of ``ray_tpu/dag/compiled_dag.py``. Reference:
python/ray/dag/compiled_dag_node.py:516 (CompiledDAG),
dag_node_operation.py (static per-actor READ/COMPUTE/WRITE schedules)
and python/ray/experimental/channel/shared_memory_channel.py (mutable
shm channels). ``compile`` walks the bound graph ONCE and picks one of
two execution modes:

**Channel mode** (all compute nodes are actor methods + native lib
available — the true aDAG): every cross-actor edge gets a mutable
shared-memory channel (ray_tpu_torch.native.channel), each actor starts a
persistent ``read inputs → compute → write outputs`` loop via
``__ray_call__``, and ``execute()`` is just *one channel write* of the
input plus a deferred read of the output channels — no per-call
scheduling, no driver round-trips between stages. Depth-1 channels
give natural pipeline parallelism: each stage may run one iteration
ahead of its consumer, exactly like the reference's overlapped static
schedules.

**Task mode** (fallback; graphs with free-function nodes): actors are
pre-created, the topo order frozen, and every bound-arg subtree is
compiled into a closure, so each ``execute()`` is a flat loop of async
task submissions.

Device-resident tensors inside one stage stay on its card; an edge
carries host values, as the JAX package's do. A CUDA tensor crosses as
host bits and arrives as a CPU tensor (core/serialization.py); moving
activations from card to card belongs to the pipeline of
``ray_tpu_torch.parallel.pipeline``. The reference's NCCL channels
(torch_tensor_nccl_channel.py) have no counterpart in either package.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    _DAGInputData,
)


# --------------------------------------------------------------------------
# Channel-mode machinery
# --------------------------------------------------------------------------

def _project_input(input_val, key):
    if isinstance(input_val, _DAGInputData):
        return input_val.pick(key)
    if isinstance(key, int):
        return input_val[key]
    if isinstance(input_val, dict):
        return input_val[key]
    return getattr(input_val, key)


def _eval_token(tok, node_vals, input_val):
    """Interpret one arg token; returns (value, err | None).

    ``node_vals[key]`` holds (value, is_err) pairs for upstream compute
    nodes (local or channel-read)."""
    t = tok[0]
    if t == "const":
        return tok[1], None
    if t == "input":
        return input_val, None
    if t == "inattr":
        return _project_input(input_val, tok[1]), None
    if t == "node":
        value, is_err = node_vals[tok[1]]
        return (value, value) if is_err else (value, None)
    if t == "seq":           # list/tuple
        out = []
        for sub in tok[2]:
            v, e = _eval_token(sub, node_vals, input_val)
            if e is not None:
                return None, e
            out.append(v)
        return tok[1](out), None
    if t == "map":           # dict
        out = {}
        for k, sub in tok[1].items():
            v, e = _eval_token(sub, node_vals, input_val)
            if e is not None:
                return None, e
            out[k] = v
        return out, None
    raise TypeError(f"bad arg token {tok!r}")


@dataclass
class _NodeSpec:
    key: int
    method: str
    arg_tokens: list
    kwarg_tokens: dict
    chan_deps: list = field(default_factory=list)  # keys read before run
    out_channel: Any = None        # Channel | None


@dataclass
class _ActorLoopSpec:
    nodes: list = field(default_factory=list)      # ordered _NodeSpec
    # key | "__input__" -> Channel
    in_channels: dict = field(default_factory=dict)
    needs_input_value: bool = False
    # (group_name, world_size, my_rank) when any DAG edge rides the
    # communicator between nodes: the loop joins the comm group before
    # touching channels.
    comm_join: tuple | None = None


def _dag_actor_loop(actor_self, spec: _ActorLoopSpec):
    """Persistent per-actor loop (reference: the compiled DAG's
    per-actor static schedule executor, dag_node_operation.py:304).
    Runs on the actor via ``__ray_call__`` until its channels close.

    Reads are interleaved per node in topological order (the
    reference's READ/COMPUTE/WRITE triples), NOT hoisted to the top of
    the iteration: an actor that both feeds and consumes another actor
    (a→b→a) must write its early nodes before blocking on channels
    produced from them."""
    import traceback as _tb

    from ray_tpu_torch.core.exceptions import ActorError
    from ray_tpu_torch.native.channel import ChannelClosedError

    if spec.comm_join is not None:
        from ray_tpu_torch.dag.comm_channel import join_comm_group
        join_comm_group(*spec.comm_join)
    for ch in spec.in_channels.values():
        ch.register_reader()
    for ns in spec.nodes:
        if ns.out_channel is not None:
            ns.out_channel.claim_writer()

    def ship(ns, entry) -> bool:
        """Write one node result; ship write failures (e.g. oversized
        payload) as errors so the driver never hangs. Returns False
        when the channel is closed (teardown)."""
        try:
            ns.out_channel.write(entry[0], _is_error=entry[1])
            return True
        except ChannelClosedError:
            return False
        except BaseException:  # noqa: BLE001
            try:
                ns.out_channel.write(
                    ActorError(ns.method, _tb.format_exc(), None),
                    _is_error=True)
                return True
            except ChannelClosedError:
                return False

    while True:
        chan_vals: dict = {}
        closed = False
        try:
            if "__input__" in spec.in_channels:
                value, is_err = spec.in_channels["__input__"]\
                    .begin_read(copy=True)
                chan_vals["__input__"] = (value, is_err)
        except ChannelClosedError:
            break
        input_entry = chan_vals.get("__input__", (None, False))
        input_val = input_entry[0]
        input_err = input_entry[0] if input_entry[1] else None
        node_vals: dict = {}
        for ns in spec.nodes:
            try:
                for dep in ns.chan_deps:
                    if dep not in node_vals:
                        value, is_err = spec.in_channels[dep]\
                            .begin_read(copy=True)
                        node_vals[dep] = (value, is_err)
            except ChannelClosedError:
                closed = True
                break
            err = input_err if spec.needs_input_value else None
            args, kwargs = (), {}
            if err is None:
                built = []
                for tok in ns.arg_tokens:
                    v, e = _eval_token(tok, node_vals, input_val)
                    if e is not None:
                        err = e
                        break
                    built.append(v)
                else:
                    args = tuple(built)
                    for k, tok in ns.kwarg_tokens.items():
                        v, e = _eval_token(tok, node_vals, input_val)
                        if e is not None:
                            err = e
                            break
                        kwargs[k] = v
            if err is None:
                try:
                    result = getattr(actor_self, ns.method)(
                        *args, **kwargs)
                    entry = (result, False)
                except BaseException:  # noqa: BLE001
                    entry = (ActorError(ns.method, _tb.format_exc(),
                                        None), True)
            else:
                entry = (err, True)
            node_vals[ns.key] = entry
            if ns.out_channel is not None and not ship(ns, entry):
                closed = True
                break
        if closed:
            break
    # Cascade the shutdown: poison/close our OUT channels so blocked
    # downstream readers unblock too. Communicator channels key
    # receives by the WRITER's rank — only this loop can emit a close
    # its consumers will actually see (the driver's teardown poison
    # reaches only the channels the driver writes, i.e. the input).
    for ns in spec.nodes:
        if ns.out_channel is not None:
            try:
                ns.out_channel.close()
            except BaseException:  # noqa: BLE001
                pass
    if spec.comm_join is not None:
        # Leave the per-DAG comm group: without this, every compile/
        # teardown cycle leaks a joined PeerMesh (sockets + group
        # state) inside the stage actor for the actor's lifetime.
        from ray_tpu_torch.dag.comm_channel import leave_comm_group
        leave_comm_group(spec.comm_join[0])
    return "dag-loop-done"


class _ChannelModeIneligible(Exception):
    """Internal: this graph shape needs the task-mode fallback."""


_FEEDER_STOP = object()


def _default_buffer_size() -> int:
    from ray_tpu_torch.native.channel import DEFAULT_BUFFER_SIZE
    return DEFAULT_BUFFER_SIZE


class CompiledDAGRef:
    """Future for one ``execute()`` of a channel-mode compiled DAG
    (reference: CompiledDAGRef in compiled_dag_node.py). ``get()``
    blocks for that execution's outputs; ``ray_tpu_torch.get`` unwraps it."""

    def __init__(self, dag: "CompiledDAG", index: int):
        self._dag = dag
        self._index = index
        self._taken = False

    def __del__(self):
        # A dropped, never-fetched ref must not leave its result
        # buffered forever (the reference bounds this with
        # max_buffered_results).
        if not self._taken:
            try:
                self._dag._discard_result(self._index)
            except Exception:  # noqa: BLE001
                pass

    def get(self, timeout: float | None = None):
        if self._taken:
            raise ValueError(
                "compiled DAG result was already retrieved")
        from ray_tpu_torch.native.channel import ChannelTimeoutError
        try:
            result = self._dag._fetch_result(self._index, timeout)
        except ChannelTimeoutError:
            # Not delivered yet — the ref stays retrievable.
            raise
        except BaseException:
            self._taken = True
            raise
        self._taken = True
        return result

    def __repr__(self):
        return f"CompiledDAGRef(exec={self._index})"


def _compile_arg(obj: Any, index_of: dict[int, int]) -> Callable:
    """Compile one bound-arg subtree into ``f(vals, inp) -> value``."""
    if isinstance(obj, DAGNode):
        i = index_of[id(obj)]
        return lambda vals, inp: vals[i]
    if isinstance(obj, (list, tuple)):
        subs = [_compile_arg(v, index_of) for v in obj]
        ctor = type(obj)
        return lambda vals, inp: ctor(s(vals, inp) for s in subs)
    if isinstance(obj, dict):
        subs = {k: _compile_arg(v, index_of) for k, v in obj.items()}
        return lambda vals, inp: {k: s(vals, inp)
                                  for k, s in subs.items()}
    return lambda vals, inp: obj


class CompiledDAG:
    """Frozen executable form of a DAG; call ``execute()`` repeatedly,
    ``teardown()`` when done."""

    def __init__(self, root: DAGNode, **opts):
        # Reference-compatible kwargs (enable_asyncio,
        # _max_inflight_executions, buffer_size_bytes, ...) are
        # accepted; buffer_size_bytes sizes the shm channels.
        self._opts = opts
        self._root = root
        self._order = root.topological_order()
        index_of = {id(n): i for i, n in enumerate(self._order)}
        self._owned_actors: list = []

        n_inputs = sum(isinstance(n, InputNode) for n in self._order)
        if n_inputs > 1:
            raise ValueError(
                f"compiled DAG must have at most one InputNode, "
                f"found {n_inputs}")

        # Create each ClassNode's actor exactly once, now. Their bound
        # args must be static (no InputNode upstream).
        handles: dict[int, Any] = {}
        for n in self._order:
            if isinstance(n, ClassNode):
                for up in n.topological_order():
                    if isinstance(up, (InputNode, InputAttributeNode)):
                        raise ValueError(
                            "actor constructor args cannot depend on "
                            "the DAG input in a compiled DAG")
                handle = n.execute()
                handles[id(n)] = handle
                self._owned_actors.append(handle)
        self._handles = handles
        self._torn_down = False

        self._mode = "tasks"
        if opts.get("_use_channels", True):
            try:
                if self._try_compile_channel_mode(index_of, handles):
                    self._mode = "channels"
            except _ChannelModeIneligible:
                pass
        if self._mode == "tasks":
            # Freeze one step-closure per node.
            plan: list[Callable] = []
            for n in self._order:
                plan.append(self._compile_node(n, index_of, handles))
            self._plan = plan
            self._n = len(plan)

    # -- channel-mode compilation ---------------------------------------

    def _try_compile_channel_mode(self, index_of: dict[int, int],
                                  handles: dict[int, Any]) -> bool:
        """Build channels + per-actor loop specs; launch the loops.

        Eligible when every compute node is an actor method (the aDAG
        shape) and the native channel layer is available. Raises
        _ChannelModeIneligible to fall back."""
        from ray_tpu_torch.native.channel import Channel, channels_available

        compute_nodes = []
        for n in self._order:
            if isinstance(n, FunctionNode):
                raise _ChannelModeIneligible
            if isinstance(n, MultiOutputNode) and n is not self._root:
                raise _ChannelModeIneligible
            if isinstance(n, ClassMethodNode):
                if n._is_handle:
                    # A user-passed live actor would have its dispatch
                    # loop hijacked by the persistent DAG loop,
                    # hanging ordinary .remote() calls — use the
                    # task-mode fallback (the reference rejects actors
                    # reused outside the DAG for the same reason).
                    raise _ChannelModeIneligible
                compute_nodes.append(n)
        if not compute_nodes or not channels_available():
            raise _ChannelModeIneligible
        if not isinstance(self._root, (ClassMethodNode,
                                       MultiOutputNode)):
            raise _ChannelModeIneligible

        # Actor of each compute node (actor_id-keyed grouping).
        def actor_of(n: ClassMethodNode):
            return n._parent if n._is_handle else handles[id(n._parent)]

        node_actor: dict[int, Any] = {}       # node key -> handle
        actor_nodes: dict[bytes, list] = {}   # actor -> [node,...]
        actor_handle: dict[bytes, Any] = {}
        for n in compute_nodes:
            h = actor_of(n)
            akey = h.actor_id.binary()
            node_actor[index_of[id(n)]] = h
            actor_nodes.setdefault(akey, []).append(n)
            actor_handle[akey] = h

        # Tokenize one bound-arg subtree; records channel/input needs.
        def tokenize(obj, akey: bytes, needs: dict):
            if isinstance(obj, InputNode):
                needs["input_value"] = True
                return ("input",)
            if isinstance(obj, InputAttributeNode):
                needs["input_value"] = True
                return ("inattr", obj._key)
            if isinstance(obj, ClassMethodNode):
                pkey = index_of[id(obj)]
                if node_actor[pkey].actor_id.binary() != akey:
                    needs["chans"].add(pkey)
                return ("node", pkey)
            if isinstance(obj, ClassNode):
                return ("const", handles[id(obj)])
            if isinstance(obj, DAGNode):
                raise _ChannelModeIneligible
            if isinstance(obj, (list, tuple)):
                return ("seq", type(obj),
                        [tokenize(v, akey, needs) for v in obj])
            if isinstance(obj, dict):
                return ("map", {k: tokenize(v, akey, needs)
                                for k, v in obj.items()})
            return ("const", obj)

        # Which node outputs does the driver read?
        driver_reads: list[int] = []
        if isinstance(self._root, ClassMethodNode):
            out_tokens = [("node", index_of[id(self._root)])]
            driver_reads.append(index_of[id(self._root)])
            multi = False
        else:
            out_tokens = []
            dneeds = {"chans": set(), "input_value": False}
            for child in self._root._bound_args:
                if isinstance(child, ClassMethodNode):
                    ckey = index_of[id(child)]
                    out_tokens.append(("node", ckey))
                    driver_reads.append(ckey)
                else:
                    out_tokens.append(tokenize(child, b"", dneeds))
                    if dneeds["chans"]:
                        raise _ChannelModeIneligible
            multi = True

        # Per-actor specs + channel needs.
        buffer_size = int(self._opts.get(
            "buffer_size_bytes",
            self._opts.get("_buffer_size_bytes", 0)) or
            _default_buffer_size())
        specs: dict[bytes, _ActorLoopSpec] = {
            akey: _ActorLoopSpec() for akey in actor_nodes}
        chan_readers: dict[int, set] = {}     # node key -> reader akeys
        actor_inbound: dict[bytes, set] = {
            akey: set() for akey in actor_nodes}
        for akey, nodes in actor_nodes.items():
            spec = specs[akey]
            for n in nodes:
                needs = {"chans": set(), "input_value": False}
                arg_toks = [tokenize(a, akey, needs)
                            for a in n.user_args]
                kw_toks = {k: tokenize(v, akey, needs)
                           for k, v in n._bound_kwargs.items()}
                for pkey in needs["chans"]:
                    chan_readers.setdefault(pkey, set()).add(akey)
                actor_inbound[akey] |= needs["chans"]
                if needs["input_value"]:
                    spec.needs_input_value = True
                spec.nodes.append(_NodeSpec(
                    key=index_of[id(n)], method=n._method_name,
                    arg_tokens=arg_toks, kwarg_tokens=kw_toks,
                    chan_deps=sorted(needs["chans"])))

        for ckey in driver_reads:
            chan_readers.setdefault(ckey, set()).add(b"__driver__")

        # Native reader-slot cap: wider fan-out falls back to task
        # mode (channel.cpp kMaxReaders).
        if any(len(r) > 16 for r in chan_readers.values()):
            raise _ChannelModeIneligible

        # Edges between nodes (reference: TorchTensorNcclChannel picked
        # per-edge behind the GPUCommunicator ABC): producer and
        # consumers on the SAME node share a native shm channel;
        # an edge crossing nodes — stages in daemons that cannot map
        # one arena — rides CommChannel over the host communicator
        # (DcnTcpCommunicator). Ranks: driver 0, actors 1..N.
        from ray_tpu_torch.core.api import get_runtime as _get_rt
        _rt = _get_rt()

        def _node_of(akey: bytes) -> str:
            if akey == b"__driver__":
                return getattr(_rt, "head_node_id", "")
            try:
                from ray_tpu_torch.core.ids import ActorID
                rec = _rt._actors.get(ActorID(akey))
                return rec.node_id if rec is not None else ""
            except Exception:  # noqa: BLE001
                return ""

        rank_of = {b"__driver__": 0}
        for _i, _akey in enumerate(sorted(actor_nodes)):
            rank_of[_akey] = _i + 1
        comm_world = 1 + len(actor_nodes)
        self._comm_group = None

        head_node = getattr(_rt, "head_node_id", "")

        def _edge_channel(tag: str, writer_akey: bytes,
                          reader_akeys) -> Any:
            # Native shm only when EVERY endpoint lives on the head
            # node: the Channel's arena is created in the DRIVER's
            # /dev/shm, which only head-node processes can map. Any
            # other placement — cross-node OR same-remote-node —
            # rides the communicator (reference: NCCL channels
            # between non-colocated stages).
            endpoints = [writer_akey, *reader_akeys]
            if all(_node_of(a) in ("", head_node)
                   for a in endpoints):
                return Channel(buffer_size)
            if self._comm_group is None:
                self._comm_group = f"cdag_{os.urandom(6).hex()}"
            from ray_tpu_torch.dag.comm_channel import CommChannel
            return CommChannel(
                self._comm_group, tag, rank_of[writer_akey],
                tuple(rank_of[r] for r in reader_akeys))

        # Create channels: one per produced node output with remote
        # consumers; one input channel.
        node_channels: dict[int, Any] = {}
        expected_readers: dict[str, int] = {}
        for pkey, readers in chan_readers.items():
            wakey = node_actor[pkey].actor_id.binary()
            ch = _edge_channel(f"e{pkey}", wakey, readers)
            node_channels[pkey] = ch
            expected_readers[ch.name] = len(readers)
        # Source actors (no inbound channels) use the input channel as
        # their per-iteration trigger even if no node reads the value.
        input_readers = set()
        for akey, spec in specs.items():
            inbound = actor_inbound[akey]
            if spec.needs_input_value or not inbound:
                input_readers.add(akey)
            for pkey in inbound:
                spec.in_channels[pkey] = node_channels[pkey]
            for ns in spec.nodes:
                ns.out_channel = node_channels.get(ns.key)
        if not input_readers and specs:
            # Every actor has inbound channels and none binds the
            # input (e.g. a node-level a->b->a loop built from
            # constants): without an input channel the loops would
            # free-run one pipeline depth ahead of execute(). Gate
            # every actor on the input channel so stateful methods run
            # exactly once per execute().
            input_readers = set(specs)
        if len(input_readers) > 16:
            raise _ChannelModeIneligible
        self._input_channel = None
        if input_readers:
            self._input_channel = _edge_channel(
                "e__input__", b"__driver__", input_readers)
            expected_readers[self._input_channel.name] = len(
                input_readers)
            for akey in input_readers:
                specs[akey].in_channels["__input__"] = \
                    self._input_channel

        # Driver registers as reader of the output channels NOW (before
        # loops start) so it never misses a version.
        self._out_channels = {k: node_channels[k] for k in driver_reads}
        for ch in self._out_channels.values():
            ch.register_reader()

        # Launch one persistent loop per actor via __ray_call__. From
        # here on a failure must tear down what was launched: the
        # loops block on channel reads forever and the caller holds no
        # object to call teardown() on (the constructor raised).
        self._loop_refs = []
        if self._comm_group is not None:
            # Everyone joins (the group rendezvous is a barrier over
            # the FULL world, driver included).
            for akey, spec in specs.items():
                spec.comm_join = (self._comm_group, comm_world,
                                  rank_of[akey])
        try:
            for akey, spec in specs.items():
                h = actor_handle[akey]
                self._loop_refs.append(
                    h.__ray_call__.remote(_dag_actor_loop, spec))
            if self._comm_group is not None:
                from ray_tpu_torch.dag.comm_channel import join_comm_group
                join_comm_group(self._comm_group, comm_world, 0)

            # Handshake: wait until every channel has all its readers
            # registered (loops are up) before allowing the first
            # write.
            deadline = time.time() + 60
            for pkey, ch in {**node_channels,
                             "__input__": self._input_channel}.items():
                if ch is None:
                    continue
                want = expected_readers[ch.name]
                while ch.reader_count() < want:
                    if time.time() > deadline:
                        raise RuntimeError(
                            "compiled DAG loops failed to start "
                            "(channel reader handshake timed out)")
                    time.sleep(0.002)
        except BaseException:
            import ray_tpu_torch as _ray
            for ch in node_channels.values():
                try:
                    ch.close()
                except Exception:  # noqa: BLE001
                    pass
            if self._input_channel is not None:
                try:
                    self._input_channel.close()
                except Exception:  # noqa: BLE001
                    pass
            for h in self._owned_actors:
                try:
                    _ray.kill(h)
                except Exception:  # noqa: BLE001
                    pass
            self._owned_actors.clear()
            self._torn_down = True
            raise

        self._out_tokens = out_tokens
        self._multi_output = multi
        self._all_channels = list(node_channels.values())
        if self._input_channel is not None:
            self._all_channels.append(self._input_channel)
        self._exec_index = 0
        self._next_fetch = 0
        self._results: dict[int, Any] = {}
        self._local_inputs: dict[int, Any] = {}
        self._partial_vals: dict[int, Any] = {}
        self._skipped: set[int] = set()   # dropped refs: don't buffer
        import threading as _t2
        # _book_lock: results/_skipped/_next_fetch vs. __del__-driven
        # discards (GC runs on arbitrary threads). _drain_lock:
        # serializes whole drain passes — output-channel reads are
        # strictly ordered, so two threads must not interleave them.
        self._book_lock = _t2.Lock()
        self._drain_lock = _t2.Lock()
        self._max_inflight = int(self._opts.get(
            "_max_inflight_executions", 1000))

        # Input writes go through a driver-side feeder thread so a
        # burst of execute() calls can't deadlock against unread
        # outputs: the depth-1 channels backpressure the *feeder*, the
        # driver keeps control (the reference bounds this with
        # _max_inflight_executions + buffered channels).
        import queue as _q
        import threading as _t
        self._write_q: Any = _q.SimpleQueue()
        self._writer_err: BaseException | None = None

        def _feed():
            from ray_tpu_torch.native.channel import ChannelClosedError
            while True:
                item = self._write_q.get()
                if item is _FEEDER_STOP:
                    break
                try:
                    self._input_channel.write(item)
                except ChannelClosedError:
                    break
                except BaseException as e:  # noqa: BLE001
                    self._writer_err = e
                    break

        self._feeder = None
        if self._input_channel is not None:
            self._feeder = _t.Thread(target=_feed, daemon=True,
                                     name="cdag_feeder")
            self._feeder.start()
        return True

    def _compile_node(self, n: DAGNode, index_of: dict[int, int],
                      handles: dict[int, Any]) -> Callable:
        if isinstance(n, InputNode):
            return lambda vals, inp: inp
        if isinstance(n, InputAttributeNode):
            parent_i = index_of[id(n._bound_args[0])]
            key = n._key
            if isinstance(key, int):
                def pick_i(vals, inp):
                    base = vals[parent_i]
                    if isinstance(base, _DAGInputData):
                        return base.pick(key)
                    return base[key]
                return pick_i

            def pick_k(vals, inp):
                base = vals[parent_i]
                if isinstance(base, _DAGInputData):
                    return base.pick(key)
                return base[key] if isinstance(base, dict) else getattr(
                    base, key)
            return pick_k
        if isinstance(n, ClassNode):
            handle = handles[id(n)]
            return lambda vals, inp: handle
        if isinstance(n, FunctionNode):
            arg_fns = [_compile_arg(a, index_of) for a in n._bound_args]
            kw_fns = {k: _compile_arg(v, index_of)
                      for k, v in n._bound_kwargs.items()}
            rf = n._remote_fn
            return lambda vals, inp: rf.remote(
                *(f(vals, inp) for f in arg_fns),
                **{k: f(vals, inp) for k, f in kw_fns.items()})
        if isinstance(n, ClassMethodNode):
            if n._is_handle:
                method = getattr(n._parent, n._method_name)
            else:
                method = getattr(handles[id(n._parent)], n._method_name)
            arg_fns = [_compile_arg(a, index_of) for a in n.user_args]
            kw_fns = {k: _compile_arg(v, index_of)
                      for k, v in n._bound_kwargs.items()}
            return lambda vals, inp: method.remote(
                *(f(vals, inp) for f in arg_fns),
                **{k: f(vals, inp) for k, f in kw_fns.items()})
        if isinstance(n, MultiOutputNode):
            idxs = [index_of[id(c)] for c in n._bound_args]
            return lambda vals, inp: [vals[i] for i in idxs]
        raise TypeError(f"cannot compile DAG node {type(n).__name__}")

    def execute(self, *input_args, **input_kwargs):
        """Channel mode: one input-channel write, returns a
        CompiledDAGRef. Task mode: one flat pass of submissions,
        returns ObjectRef(s)."""
        if self._torn_down:
            raise RuntimeError("compiled DAG has been torn down")
        if len(input_args) == 1 and not input_kwargs:
            inp: Any = input_args[0]
        elif not input_args and not input_kwargs:
            inp = None
        else:
            inp = _DAGInputData(input_args, input_kwargs)
        if self._mode == "channels":
            if self._writer_err is not None:
                raise self._writer_err
            if (self._exec_index - self._next_fetch
                    >= self._max_inflight):
                raise RuntimeError(
                    f"too many in-flight compiled DAG executions "
                    f"(>{self._max_inflight}); retrieve results or "
                    f"raise _max_inflight_executions")
            idx = self._exec_index
            self._exec_index += 1
            self._local_inputs[idx] = inp
            if self._input_channel is not None:
                self._write_q.put(inp)
            return CompiledDAGRef(self, idx)
        vals: list[Any] = [None] * self._n
        plan = self._plan
        for i in range(self._n):
            vals[i] = plan[i](vals, inp)
        return vals[-1]

    def _fetch_result(self, idx: int, timeout: float | None = None):
        """Drain output-channel versions up to execution ``idx`` (reads
        are strictly ordered: version v ↔ execution v-1). ``timeout``
        bounds the WHOLE call: it converts to one deadline up front and
        each channel read gets the remaining budget (a per-read timeout
        would multiply by pending executions x output channels)."""
        deadline = (None if timeout is None
                    else time.time() + timeout)
        # Fast path: already drained by another thread — don't queue
        # behind a drain that may be blocking on a later execution.
        with self._book_lock:
            entry = self._results.pop(idx, None)
        if entry is not None:
            tag, value = entry
            if tag == "err":
                raise value
            return value
        with self._drain_lock:
            while self._next_fetch <= idx:
                if self._torn_down:
                    raise RuntimeError(
                        "compiled DAG has been torn down")
                i = self._next_fetch
                # Partial reads survive a timeout in _partial_vals so
                # a retry never re-reads an already-acked channel
                # (which would cross outputs between executions).
                vals = self._partial_vals
                for pkey, ch in self._out_channels.items():
                    if pkey in vals:
                        continue
                    remaining = (None if deadline is None else
                                 max(0.0, deadline - time.time()))
                    value, is_err = ch.begin_read(remaining, copy=True)
                    vals[pkey] = (value, is_err)
                self._partial_vals = {}
                inp = self._local_inputs.pop(i, None)
                with self._book_lock:
                    if i in self._skipped:
                        # Dropped ref: drain the channel versions
                        # (ordering) but don't buffer the output.
                        self._skipped.discard(i)
                        self._next_fetch += 1
                        continue
                    buffer_it = True
                if buffer_it:
                    outs = []
                    first_err = None
                    for tok in self._out_tokens:
                        v, e = _eval_token(tok, vals, inp)
                        if e is not None and first_err is None:
                            first_err = e
                        outs.append(v)
                    with self._book_lock:
                        if i in self._skipped:
                            # Dropped while we were evaluating.
                            self._skipped.discard(i)
                        elif first_err is not None:
                            self._results[i] = ("err", first_err)
                        else:
                            self._results[i] = (
                                "ok",
                                outs if self._multi_output else outs[0])
                        self._next_fetch += 1
        with self._book_lock:
            tag, value = self._results.pop(idx)
        if tag == "err":
            raise value
        return value

    def _discard_result(self, idx: int) -> None:
        """A CompiledDAGRef was dropped without get(): free (or never
        buffer) its output. Runs from __del__ on arbitrary threads —
        takes only the bookkeeping lock (never the drain lock, which
        can be held across blocking channel reads)."""
        with self._book_lock:
            if idx in self._results:
                self._results.pop(idx, None)
            elif idx >= self._next_fetch:
                self._skipped.add(idx)
            self._local_inputs.pop(idx, None)

    def teardown(self) -> None:
        """Close channels (stopping the actor loops), then kill actors
        created by compilation (not user-passed ones)."""
        if self._torn_down:
            return
        self._torn_down = True
        import ray_tpu_torch
        if self._mode == "channels":
            if self._feeder is not None:
                self._write_q.put(_FEEDER_STOP)
            for ch in self._all_channels:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001
                    pass
            if self._feeder is not None:
                self._feeder.join(timeout=5)
            try:
                ray_tpu_torch.wait(self._loop_refs,
                             num_returns=len(self._loop_refs),
                             timeout=10)
            except Exception:  # noqa: BLE001
                pass
        for h in self._owned_actors:
            try:
                ray_tpu_torch.kill(h)
            except Exception:  # noqa: BLE001
                pass
        self._owned_actors.clear()
        if self._mode == "channels":
            for ch in self._all_channels:
                try:
                    ch.detach()
                except Exception:  # noqa: BLE001
                    pass
            self._all_channels = []
            self._out_channels = {}
            self._input_channel = None
            if getattr(self, "_comm_group", None) is not None:
                from ray_tpu_torch.dag.comm_channel import leave_comm_group
                leave_comm_group(self._comm_group)
                self._comm_group = None

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # noqa: BLE001
            pass
