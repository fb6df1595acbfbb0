"""Lazy task/actor DAGs built with ``.bind()``.

Counterpart of ``ray_tpu/dag/dag_node.py``. Reference surface:
python/ray/dag/{dag_node,function_node,class_node,input_node,
output_node}.py — a DAG is authored by binding remote functions / actor
methods to placeholder inputs, then driven with ``dag.execute(value)``
(one bundle of task submissions per call) or compiled once with
``dag.experimental_compile()`` (static schedule, pre-created actors; see
compiled_dag.py).

The DAG layer moves host values and ObjectRefs only, exactly like the
reference's CPU channels: a CUDA tensor crosses an edge as host bits
(core/serialization.py) and the stage that reads it moves it to its own
card.
"""

from __future__ import annotations

from typing import Any, Callable

_APPLY_ATTR = "__ray_tpu_dag_apply__"


def _tree_map(obj: Any, fn: Callable[["DAGNode"], Any]) -> Any:
    """Map ``fn`` over every DAGNode in a nested args structure."""
    if isinstance(obj, DAGNode):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(v, fn) for k, v in obj.items()}
    return obj


def _tree_nodes(obj: Any, out: list["DAGNode"]) -> None:
    if isinstance(obj, DAGNode):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tree_nodes(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tree_nodes(v, out)


class DAGNode:
    """Base class: a bound, not-yet-executed call in the graph."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- graph structure -------------------------------------------------

    def _upstream_nodes(self) -> list["DAGNode"]:
        out: list[DAGNode] = []
        _tree_nodes(self._bound_args, out)
        _tree_nodes(self._bound_kwargs, out)
        return out

    def topological_order(self) -> list["DAGNode"]:
        """Deterministic postorder (upstream before downstream)."""
        seen: set[int] = set()
        order: list[DAGNode] = []

        def visit(n: DAGNode) -> None:
            if id(n) in seen:
                return
            seen.add(id(n))
            for up in n._upstream_nodes():
                visit(up)
            order.append(n)

        visit(self)
        return order

    # -- eager (uncompiled) execution ------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Submit the whole graph once; returns ObjectRef(s).

        Reference: DAGNode.execute (python/ray/dag/dag_node.py) — each
        call re-walks the graph; use experimental_compile() for the
        repeated-execution fast path.
        """
        if len(input_args) == 1 and not input_kwargs:
            input_val: Any = input_args[0]
        elif not input_args and not input_kwargs:
            input_val = None
        else:
            input_val = _DAGInputData(input_args, input_kwargs)
        cache: dict[int, Any] = {}
        return self._execute_impl(input_val, cache)

    def _resolve_bound(self, input_val, cache) -> tuple[tuple, dict]:
        args = _tree_map(self._bound_args,
                         lambda n: n._execute_impl(input_val, cache))
        kwargs = _tree_map(self._bound_kwargs,
                           lambda n: n._execute_impl(input_val, cache))
        return args, kwargs

    def _execute_impl(self, input_val, cache):
        if id(self) in cache:
            return cache[id(self)]
        out = self._execute_node(input_val, cache)
        cache[id(self)] = out
        return out

    def _execute_node(self, input_val, cache):  # pragma: no cover
        raise NotImplementedError

    def experimental_compile(self, **opts) -> "Any":
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG
        return CompiledDAG(self, **opts)


class _DAGInputData:
    """Multi-arg input bundle; unpacked by InputAttributeNode."""

    def __init__(self, args: tuple, kwargs: dict):
        self.args = args
        self.kwargs = kwargs

    def pick(self, key):
        if isinstance(key, int):
            return self.args[key]
        return self.kwargs[key]


class InputNode(DAGNode):
    """Placeholder for the per-execute input value.

    Usable bare or as a context manager (the reference requires the
    ``with InputNode() as inp:`` form; we accept both).
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def __getattr__(self, name: str) -> "InputAttributeNode":
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def _execute_node(self, input_val, cache):
        return input_val


class InputAttributeNode(DAGNode):
    """``inp[0]`` / ``inp.key`` — projects one field of the input."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _execute_node(self, input_val, cache):
        base = self._bound_args[0]._execute_impl(input_val, cache)
        if isinstance(base, _DAGInputData):
            return base.pick(self._key)
        if isinstance(self._key, int):
            return base[self._key]
        return getattr(base, self._key, None) if not isinstance(
            base, dict) else base[self._key]


class FunctionNode(DAGNode):
    """A bound ``@remote`` function call (reference: function_node.py)."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_node(self, input_val, cache):
        args, kwargs = self._resolve_bound(input_val, cache)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor construction (reference: class_node.py).

    Uncompiled execution creates a fresh actor per ``execute()``;
    compiled DAGs create it once and reuse it.
    """

    def __init__(self, actor_cls, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def __getattr__(self, name: str) -> "_DAGClassMethod":
        if name.startswith("_"):
            raise AttributeError(name)
        return _DAGClassMethod(self, name)

    def _execute_node(self, input_val, cache):
        args, kwargs = self._resolve_bound(input_val, cache)
        return self._actor_cls.remote(*args, **kwargs)


class _DAGClassMethod:
    """``class_node.method`` — bindable, not callable."""

    def __init__(self, parent: ClassNode, name: str):
        self._parent = parent
        self._name = name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._parent, self._name, args, kwargs)


class ClassMethodNode(DAGNode):
    """A bound actor-method call; parent is a ClassNode or a live
    ActorHandle (binding methods on existing actors is allowed, same
    as the reference)."""

    def __init__(self, parent, method_name: str, args: tuple,
                 kwargs: dict):
        from ray_tpu_torch.core.actor import ActorHandle
        self._is_handle = isinstance(parent, ActorHandle)
        extra = () if self._is_handle else (parent,)
        super().__init__(extra + args, kwargs)
        self._parent = parent
        self._method_name = method_name
        self._n_extra = len(extra)

    @property
    def user_args(self) -> tuple:
        return self._bound_args[self._n_extra:]

    def _execute_node(self, input_val, cache):
        if self._is_handle:
            handle = self._parent
        else:
            handle = self._parent._execute_impl(input_val, cache)
        args = _tree_map(self.user_args,
                         lambda n: n._execute_impl(input_val, cache))
        kwargs = _tree_map(self._bound_kwargs,
                           lambda n: n._execute_impl(input_val, cache))
        return getattr(handle, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Terminal node returning a list of outputs (reference:
    output_node.py)."""

    def __init__(self, outputs: list):
        super().__init__(tuple(outputs), {})

    def _execute_node(self, input_val, cache):
        return [n._execute_impl(input_val, cache)
                for n in self._bound_args]
