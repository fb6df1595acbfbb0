"""Lazy Dataset with streaming execution.

Reference analog (SURVEY.md §2.3 / §3.6): logical plan → rule-based
optimizer → physical operators → pull-based streaming executor with
backpressure. The design keeps the same shape, specialized:

- logical ops are recorded lazily on the Dataset;
- the optimizer fuses chains of row/batch transforms into ONE task per
  block (the reference's map-fusion rule — its biggest win);
- the streaming executor is a generator that keeps at most
  ``max_in_flight`` block tasks outstanding (backpressure), yielding
  block ObjectRefs as they complete, in order;
- all-to-all ops (repartition, random_shuffle) are barriers, as in the
  reference.

Blocks execute as core-runtime tasks, so a Dataset streams across the
cluster's CPU workers while consumers (trainer actors / device
prefetch) pull concurrently.

Counterpart of ``ray_tpu/data/dataset.py`` on the port's runtime and its
numpy block (``data/block.py``): sort, group-by and zip run on numpy
with the results pyarrow gives there; ``iter_device_batches`` places
batches on the card through ``train.prefetch_to_device``. Nothing here
imports torch, pyarrow or pandas at module level.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block, _require, block_num_rows, block_rows, block_to_batch,
    concat_blocks, slice_block, to_block,
)

class _ExecStats:
    """Per-stage pull timing for one streaming execution (the
    reference's DatasetStats analog, scoped to what the pull-based
    executor can observe: blocks yielded + time the consumer spent
    blocked in each stage's generator).

    The stage wrappers are strictly NESTED (the consumer pulls only
    the outermost; each stage's next() blocks inside its upstream's
    next()), so a stage's raw accrual includes everything upstream —
    ``summary()`` reports SELF time (own accrual minus the stage
    directly beneath), which is what identifies the bottleneck."""

    def __init__(self):
        self.stages: list[dict] = []
        self._t0 = None                 # first actual consumer pull
        self._t_last = None             # last yield observed

    def timed(self, name: str, refs):
        import time as _time
        entry = {"stage": name, "blocks": 0, "wait_s": 0.0}
        self.stages.append(entry)
        if refs is None:
            return refs

        def gen():
            it = iter(refs)
            while True:
                t0 = _time.perf_counter()
                if self._t0 is None:
                    self._t0 = t0       # lazy: on the first pull
                try:
                    r = next(it)
                except StopIteration:
                    entry["wait_s"] += _time.perf_counter() - t0
                    return
                self._t_last = _time.perf_counter()
                entry["wait_s"] += self._t_last - t0
                entry["blocks"] += 1
                yield r

        return gen()

    def summary(self) -> str:
        total = ((self._t_last - self._t0)
                 if self._t0 is not None and self._t_last is not None
                 else 0.0)
        lines = ["Dataset execution stats:"]
        prev_wait = 0.0
        for e in self.stages:
            self_wait = max(0.0, e["wait_s"] - prev_wait)
            prev_wait = e["wait_s"]
            lines.append(
                f"  {e['stage']:<12} {e['blocks']:>5} blocks   "
                f"self pull-wait {self_wait * 1e3:8.1f} ms")
        lines.append(f"  total wall (first pull -> last block): "
                     f"{total * 1e3:.1f} ms")
        return "\n".join(lines)


# -- logical ops -----------------------------------------------------------

@dataclass
class _Source:
    read_fns: list[Callable[[], Any]]      # each returns a block


@dataclass
class ActorPoolStrategy:
    """compute= strategy for ``map_batches`` (reference:
    ray.data.ActorPoolStrategy + ActorPoolMapOperator,
    execution/operators/actor_pool_map_operator.py): the UDF runs in
    a pool of long-lived actors — a CLASS fn is instantiated once per
    actor (load-the-model-once pattern) — autoscaling between
    min_size and max_size on backlog, with at most
    ``max_tasks_in_flight_per_actor`` blocks outstanding per actor
    (the per-operator backpressure bound)."""

    size: int | None = None
    min_size: int = 1
    max_size: int | None = None
    max_tasks_in_flight_per_actor: int = 2
    num_cpus: float = 1.0

    def __post_init__(self):
        if self.size is not None and self.size < 1:
            raise ValueError("ActorPoolStrategy.size must be >= 1")
        if self.min_size < 1:
            raise ValueError(
                "ActorPoolStrategy.min_size must be >= 1")
        if self.max_size is not None and self.max_size < self.min_size:
            raise ValueError("max_size < min_size")

    def resolve(self) -> tuple[int, int]:
        if self.size is not None:
            return self.size, self.size
        return self.min_size, max(self.max_size or 4, self.min_size)


@dataclass
class _MapBatches:
    fn: Callable
    fn_kwargs: dict = field(default_factory=dict)
    compute: ActorPoolStrategy | None = None
    batch_format: str = "numpy"   # numpy | pandas | pyarrow


@dataclass
class _MapRows:
    fn: Callable


@dataclass
class _FlatMap:
    fn: Callable


@dataclass
class _Filter:
    fn: Callable


@dataclass
class _Repartition:
    num_blocks: int


@dataclass
class _RandomShuffle:
    seed: int | None


@dataclass
class _Limit:
    n: int


@dataclass
class _Sort:
    key: str
    descending: bool = False


@dataclass
class _GroupBy:
    key: str
    # ("count", None) | ("sum"/"mean"/"min"/"max"/"std", col)
    # | ("map_groups", fn)
    agg: tuple
    num_partitions: int | None = None


@dataclass
class _Zip:
    other: "Dataset"


@dataclass
class _Union:
    others: list


_FUSABLE = (_MapBatches, _MapRows, _FlatMap, _Filter)


def _convert_for(batch_format: str):
    """Block -> batch converter for one batch_format (shared by
    map_batches, Dataset.iter_batches, DataIterator.iter_batches and
    the actor-pool workers — one definition of the format contract)."""
    if batch_format == "numpy":
        return block_to_batch
    if batch_format == "pandas":
        return lambda b: b.to_pandas()
    if batch_format == "pyarrow":
        return lambda b: b.to_arrow()
    raise ValueError(
        f"batch_format must be numpy|pandas|pyarrow, got "
        f"{batch_format!r}")


def _batched_blocks(blocks, batch_size, drop_last, convert):
    """THE batching loop (carry partial blocks across block
    boundaries) — exists once; both iterator surfaces wrap it."""
    carry = None
    for block in blocks:
        if block.num_rows == 0:
            continue
        if batch_size is None:
            yield convert(block)
            continue
        block = block if carry is None else concat_blocks(
            [carry, block])
        carry = None
        start = 0
        while start + batch_size <= block.num_rows:
            yield convert(slice_block(block, start,
                                      start + batch_size))
            start += batch_size
        if start < block.num_rows:
            carry = slice_block(block, start, block.num_rows)
    if carry is not None and not drop_last:
        yield convert(carry)


def _concat_row_slices(picks: list, schema_block):
    """One block from (block, start, end) row slices; an empty pick
    list yields a zero-row block with the dataset's schema."""
    if not picks:
        if schema_block is None:
            return to_block({})
        return slice_block(schema_block, 0, 0)
    parts = [slice_block(b, s, e) for b, s, e in picks]
    return parts[0] if len(parts) == 1 else concat_blocks(parts)


def _apply_fused(block, ops: list):
    """Run a fused chain of transforms on one block (executes inside a
    worker task)."""
    for op in ops:
        if isinstance(op, _MapBatches):
            fmt = getattr(op, "batch_format", "numpy")
            if fmt == "pandas":
                batch = block.to_pandas()
            elif fmt == "pyarrow":
                batch = block.to_arrow()
            else:
                batch = block_to_batch(block)
            out = op.fn(batch, **op.fn_kwargs)
            block = to_block(out)
        elif isinstance(op, _MapRows):
            rows = [op.fn(r) for r in block_rows(block)]
            block = to_block(rows)
        elif isinstance(op, _FlatMap):
            rows = [o for r in block_rows(block) for o in op.fn(r)]
            block = to_block(rows)
        elif isinstance(op, _Filter):
            rows = [r for r in block_rows(block) if op.fn(r)]
            # An all-filtered block keeps its schema (a zero-row
            # slice), so downstream consumers still see the columns.
            block = (slice_block(block, 0, 0) if not rows
                     else to_block(rows))
    return block


@ray_tpu_torch.remote
def _read_and_transform(read_fn, ops):
    return _apply_fused(read_fn(), ops)


@ray_tpu_torch.remote
def _transform_block(block, ops):
    return _apply_fused(block, ops)


@ray_tpu_torch.remote
def _split_block(block, starts_ends):
    return tuple(slice_block(block, s, e) for s, e in starts_ends) \
        if len(starts_ends) > 1 else slice_block(block, *starts_ends[0])


class Dataset:
    """Lazy, immutable, distributed dataset (reference: ray.data.Dataset)."""

    def __init__(self, plan: list):
        self._plan = plan

    # -- transforms (lazy) --

    def _append(self, op) -> "Dataset":
        return Dataset(self._plan + [op])

    def map_batches(self, fn: Callable, *, compute=None,
                    batch_format: str = "numpy",
                    **fn_kwargs) -> "Dataset":
        # Legacy string forms (classic ray.data): "tasks" == default,
        # "actors" == a default-sized pool. Anything else must be an
        # ActorPoolStrategy — fail HERE, not deep in the executor.
        if compute == "tasks":
            compute = None
        elif compute == "actors":
            compute = ActorPoolStrategy()
        elif compute is not None and not isinstance(
                compute, ActorPoolStrategy):
            raise TypeError(
                f"compute= must be None, 'tasks', 'actors', or an "
                f"ActorPoolStrategy; got {compute!r}")
        if batch_format not in ("numpy", "pandas", "pyarrow"):
            raise ValueError(
                f"batch_format must be numpy|pandas|pyarrow, got "
                f"{batch_format!r}")
        return self._append(_MapBatches(fn, fn_kwargs, compute,
                                        batch_format))

    def map(self, fn: Callable) -> "Dataset":
        return self._append(_MapRows(fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._append(_FlatMap(fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._append(_Filter(fn))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._append(_Repartition(num_blocks))

    def random_shuffle(self, seed: int | None = None) -> "Dataset":
        return self._append(_RandomShuffle(seed))

    def limit(self, n: int) -> "Dataset":
        return self._append(_Limit(n))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sample-based range-partition sort (reference:
        Dataset.sort — sample cutoffs, partition, per-partition sort)."""
        return self._append(_Sort(key, descending))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of equal-length datasets (barrier)."""
        return self._append(_Zip(other))

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (streaming — no barrier)."""
        return self._append(_Union(list(others)))

    # -- column ops (sugar over map_batches, fused like the rest) --

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch):
            batch[name] = np.asarray(fn(batch))
            return batch
        return self.map_batches(add)

    def drop_columns(self, cols: list[str]) -> "Dataset":
        drop = set(cols)
        return self.map_batches(
            lambda b: {k: v for k, v in b.items() if k not in drop})

    def select_columns(self, cols: list[str]) -> "Dataset":
        keep = list(cols)
        return self.map_batches(
            lambda b: {k: b[k] for k in keep})

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        return self.map_batches(
            lambda b: {mapping.get(k, k): v for k, v in b.items()})

    # -- scalar aggregates --

    def sum(self, col: str):
        return self._scalar_agg(col, np.sum, 0)

    def min(self, col: str):
        return self._scalar_agg(col, np.min, None)

    def max(self, col: str):
        return self._scalar_agg(col, np.max, None)

    def mean(self, col: str):
        total, count = 0.0, 0
        for block in self.iter_blocks():
            if block.num_rows:
                v = block_to_batch(block)[col]
                total += float(np.sum(v))
                count += len(v)
        return total / count if count else float("nan")

    def std(self, col: str):
        vals = [block_to_batch(b)[col] for b in self.iter_blocks()
                if b.num_rows]
        if not vals:
            return float("nan")
        return float(np.std(np.concatenate(vals), ddof=1))

    def unique(self, col: str) -> list:
        out = set()
        for block in self.iter_blocks():
            if block.num_rows:
                out.update(np.asarray(
                    block_to_batch(block)[col]).tolist())
        return sorted(out)

    def aggregate(self, *aggs) -> dict:
        """Whole-dataset aggregation over AggregateFn descriptors
        (reference: Dataset.aggregate + python/ray/data/aggregate.py).
        Returns one dict keyed by each agg's name."""
        from ray_tpu_torch.data.aggregate import AggregateFn
        for a in aggs:
            if not isinstance(a, AggregateFn):
                raise TypeError(f"expected AggregateFn, got {type(a)!r}")
        accs = [a.init() for a in aggs]
        for block in self.iter_blocks():
            n = block_num_rows(block)
            if n == 0:  # an all-filtered block may even lack columns
                continue
            batch = block_to_batch(block)
            for i, a in enumerate(aggs):
                col = (np.asarray(batch[a.on]) if a.on is not None
                       else np.zeros(n))
                accs[i] = a.accumulate_block(accs[i], col)
        return {a.name: a.finalize(acc) for a, acc in zip(aggs, accs)}

    def _scalar_agg(self, col: str, op, empty):
        parts = [op(block_to_batch(b)[col])
                 for b in self.iter_blocks() if b.num_rows]
        if not parts:
            return empty
        val = op(np.asarray(parts))
        return val.item() if hasattr(val, "item") else val

    # -- execution ---------------------------------------------------------

    def _stream_blocks(self, max_in_flight: int | None = None
                       ) -> Iterator[ray_tpu_torch.ObjectRef]:
        """The streaming executor: yields block refs in order with at
        most max_in_flight tasks outstanding (default: the
        DataContext knob). Each stage's pull is timed into
        ``_last_stats`` (consumed by ``stats()``)."""
        if max_in_flight is None:
            from ray_tpu_torch.data.context import DataContext
            max_in_flight = DataContext.get_current().max_in_flight
        from ray_tpu_torch.data.optimizer import optimize
        stages = _split_stages(optimize(self._plan))
        self._last_stats = _ExecStats()
        refs = None

        # Bind stage payloads BY VALUE: these generators evaluate
        # lazily, possibly after the loop variables (`payload`,
        # `fused`) have been rebound by a later stage — a genexpr
        # closing over the loop variable would then run the WRONG
        # op list (latent for barrier-only plans, which materialize
        # eagerly; exposed by lazy stages like the actor pool).
        def _src_tasks(read_fns, ops):
            return ((_read_and_transform, (rf, ops))
                    for rf in read_fns)

        def _fused_tasks(upstream, ops):
            return ((_transform_block, (r, ops)) for r in upstream)

        for kind, payload in stages:
            if kind == "source":
                read_fns, fused = payload
                refs = _bounded_submit(_src_tasks(read_fns, fused),
                                       max_in_flight,
                                       op_name="source")
            elif kind == "fused":
                refs = _bounded_submit(_fused_tasks(refs, payload),
                                       max_in_flight,
                                       op_name="map")
            elif kind == "actor_map":
                refs = _actor_map(refs, payload)
            elif kind == "repartition":
                refs = iter(_do_repartition(list(refs), payload))
            elif kind == "shuffle":
                refs = iter(_do_shuffle(list(refs), payload))
            elif kind == "limit":
                refs = _do_limit(refs, payload)
            elif kind == "sort":
                refs = iter(_do_sort(list(refs), payload))
            elif kind == "groupby":
                refs = iter(_do_groupby(list(refs), payload))
            elif kind == "zip":
                refs = iter(_do_zip(list(refs), payload))
            elif kind == "union":
                refs = itertools.chain(
                    refs, *(o._stream_blocks(max_in_flight)
                            for o in payload.others))
            refs = self._last_stats.timed(kind, refs)
        return refs

    def stats(self) -> str:
        """Execution stats of the LAST run of this dataset's plan
        (reference: Dataset.stats() — per-operator summaries).
        Per-stage block counts and pull-blocked wall time: stages
        stream concurrently, so each stage's time is the time the
        consumer spent WAITING on that stage (already-prefetched
        blocks count ~0), which is exactly what identifies the
        bottleneck stage."""
        st = getattr(self, "_last_stats", None)
        if st is None or not st.stages:
            return ("Dataset has not been executed yet — iterate or "
                    "materialize it first, then call stats().")
        return st.summary()

    def iter_blocks(self, max_in_flight: int | None = None):
        for ref in self._stream_blocks(max_in_flight):
            yield ray_tpu_torch.get(ref)

    def iter_batches(self, batch_size: int | None = None,
                     drop_last: bool = False,
                     max_in_flight: int | None = None,
                     batch_format: str = "numpy"
                     ) -> Iterator:
        """Batches as numpy dicts (default), pandas DataFrames, or
        pyarrow Tables per ``batch_format``. NOT a generator itself:
        a bad batch_format raises HERE, at the call site."""
        convert = _convert_for(batch_format)
        return _batched_blocks(self.iter_blocks(max_in_flight),
                               batch_size, drop_last, convert)

    def iter_rows(self) -> Iterator[dict]:
        for block in self.iter_blocks():
            yield from block_rows(block)

    def take(self, n: int = 20) -> list[dict]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def schema(self):
        for block in self.iter_blocks():
            return block.schema
        return None

    def columns(self) -> list[str] | None:
        """Column names (reference: Dataset.columns)."""
        sch = self.schema()
        return list(sch.names) if sch is not None else None

    def materialize(self) -> "Dataset":
        blocks = list(self.iter_blocks())
        return Dataset([_Source([(lambda b=b: b) for b in blocks])])

    def size_bytes(self) -> int:
        """In-memory (numpy) size (reference: Dataset.size_bytes);
        an object column counts its pointers only."""
        return sum(b.nbytes for b in self.iter_blocks())

    def show(self, limit: int = 20) -> None:
        """Print up to ``limit`` rows (reference: Dataset.show)."""
        for row in self.take(limit):
            print(row)

    def copy(self) -> "Dataset":
        """A new Dataset over the same (immutable) plan so further
        appends diverge (reference: Dataset.copy)."""
        return Dataset(list(self._plan))

    def iterator(self) -> "DataIterator":
        """Whole-dataset DataIterator (reference: Dataset.iterator —
        a streaming_split(1) shard)."""
        return DataIterator(self, shard=0, num_shards=1)

    def num_blocks(self) -> int:
        n = 0
        for _ in self._stream_blocks():
            n += 1
        return n

    # -- split for trainers --

    def streaming_split(self, n: int) -> list["DataIterator"]:
        """n iterators, block i -> shard i%n (reference:
        Dataset.streaming_split feeding per-trainer iterators)."""
        return [DataIterator(self, shard=i, num_shards=n)
                for i in range(n)]

    def split(self, n: int) -> list["Dataset"]:
        mat = self.materialize()
        src: _Source = mat._plan[0]
        return [Dataset([_Source(src.read_fns[i::n])]) for i in range(n)]

    @staticmethod
    def _split_blocks_at(blocks: list, sizes: list[int],
                         indices: list[int]) -> list["Dataset"]:
        """Shared row-index splitter over already-pulled blocks (the
        pipeline executes ONCE even when the caller also needed the
        total row count)."""
        total = sum(sizes)
        bounds = [0, *indices, total]
        schema_block = blocks[0] if blocks else None
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            hi = min(hi, total)
            picks = []
            off = 0
            for b, sz in zip(blocks, sizes):
                s, e = max(lo - off, 0), min(hi - off, sz)
                if s < e:
                    picks.append((b, s, e))
                off += sz
            out.append(Dataset([_Source([
                lambda p=picks, sb=schema_block:
                    _concat_row_slices(p, sb)])]))
        return out

    def split_at_indices(self, indices: list[int]) -> list["Dataset"]:
        """Split at global ROW indices -> len(indices)+1 datasets
        (reference: Dataset.split_at_indices)."""
        if any(i < 0 for i in indices):
            raise ValueError("indices must be non-negative")
        if list(indices) != sorted(indices):
            raise ValueError("indices must be sorted")
        blocks = list(self.iter_blocks())
        sizes = [block_num_rows(b) for b in blocks]
        return self._split_blocks_at(blocks, sizes, list(indices))

    def split_proportionately(self, proportions: list[float]
                              ) -> list["Dataset"]:
        """(reference: Dataset.split_proportionately — the remainder
        becomes a final extra split, so len(out) == len(props)+1)."""
        if not proportions or any(p <= 0 for p in proportions) \
                or sum(proportions) >= 1:
            raise ValueError(
                "proportions must be positive and sum to < 1")
        blocks = list(self.iter_blocks())
        sizes = [block_num_rows(b) for b in blocks]
        n = sum(sizes)
        cuts, acc = [], 0.0
        for p in proportions:
            acc += p
            cuts.append(int(n * acc))
        return self._split_blocks_at(blocks, sizes, cuts)

    def train_test_split(self, test_size: float | int, *,
                         shuffle: bool = False,
                         seed: int | None = None
                         ) -> tuple["Dataset", "Dataset"]:
        """(reference: Dataset.train_test_split — the test split is
        the TAIL, after an optional shuffle)."""
        ds = self.random_shuffle(seed) if shuffle else self
        blocks = list(ds.iter_blocks())
        sizes = [block_num_rows(b) for b in blocks]
        n = sum(sizes)
        if isinstance(test_size, float):
            if not 0 < test_size < 1:
                raise ValueError("float test_size must be in (0, 1)")
            test_n = int(n * test_size)
        else:
            if not 0 <= test_size <= n:
                raise ValueError(f"int test_size must be in [0, {n}]")
            test_n = test_size
        train, test = self._split_blocks_at(blocks, sizes,
                                            [n - test_n])
        return train, test

    def randomize_block_order(self, *, seed: int | None = None
                              ) -> "Dataset":
        """Shuffle BLOCK order only (cheap; reference:
        Dataset.randomize_block_order). Lazy when the plan is a pure
        source; otherwise materializes first (a downstream all-to-all
        stage makes block order meaningful)."""
        import random as _random
        rng = _random.Random(seed)
        if len(self._plan) == 1 and isinstance(self._plan[0], _Source):
            fns = list(self._plan[0].read_fns)
            rng.shuffle(fns)
            return Dataset([_Source(fns)])
        mat = self.materialize()
        fns = list(mat._plan[0].read_fns)
        rng.shuffle(fns)
        return Dataset([_Source(fns)])

    def random_sample(self, fraction: float, *,
                      seed: int | None = None) -> "Dataset":
        """Bernoulli row sample (reference: Dataset.random_sample).
        With a fixed seed the draw is deterministic; each block's rng
        is salted with a content digest so distinct blocks draw
        INDEPENDENT masks (a bare per-block ``default_rng(seed)``
        would give equal-sized blocks identical masks — correlated
        sampling)."""
        if not 0 <= fraction <= 1:
            raise ValueError("fraction must be in [0, 1]")

        def sample(batch):
            import zlib

            import numpy as _np
            n = len(next(iter(batch.values()))) if batch else 0
            if seed is None:
                rng = _np.random.default_rng()
            else:
                digest = 0
                for k in sorted(batch):
                    arr = _np.asarray(batch[k])
                    data = (repr(arr[:32].tolist()).encode()
                            if arr.dtype == object else
                            _np.ascontiguousarray(arr).tobytes()[:4096])
                    digest = zlib.crc32(data, digest)
                rng = _np.random.default_rng([seed, n, digest])
            mask = rng.random(n) < fraction
            return {k: _np.asarray(v)[mask] for k, v in batch.items()}

        return self.map_batches(sample)

    # -- io --

    def write_parquet(self, path: str) -> None:
        import os
        pq = _require("pyarrow.parquet", "write_parquet")
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            pq.write_table(block.to_arrow(), f"{path}/part-{i:05d}.parquet")

    def write_csv(self, path: str) -> None:
        import os
        pacsv = _require("pyarrow.csv", "write_csv")
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            pacsv.write_csv(block.to_arrow(), f"{path}/part-{i:05d}.csv")

    def write_json(self, path: str) -> None:
        import json as jsonlib
        import os
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            with open(f"{path}/part-{i:05d}.json", "w") as f:
                for row in block_rows(block):
                    f.write(jsonlib.dumps(
                        {k: (v.tolist() if hasattr(v, "tolist")
                             else v) for k, v in row.items()}) + "\n")

    def write_tfrecords(self, path: str) -> None:
        """One .tfrecord file per block, rows as tf.train.Example
        (reference: Dataset.write_tfrecords; framing + Example codec
        in ray_tpu_torch.data.tfrecord — no TF dependency)."""
        import os

        from ray_tpu_torch.data.tfrecord import build_example, write_records
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            write_records(
                f"{path}/part-{i:05d}.tfrecord",
                (build_example(
                    {k: (v.tolist() if hasattr(v, "tolist") else v)
                     for k, v in row.items()})
                 for row in block_rows(block)))

    def write_numpy(self, path: str, *, column: str) -> None:
        """One ``part-NNNNN.npy`` of ``column`` per block (reference:
        Dataset.write_numpy)."""
        import os
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            batch = block_to_batch(block)
            if column not in batch:
                raise ValueError(
                    f"column {column!r} not in {list(batch)}")
            np.save(f"{path}/part-{i:05d}.npy", batch[column])

    def write_sql(self, sql: str, connection_factory) -> None:
        """``executemany`` one parameterized INSERT per block
        (reference: Dataset.write_sql — same DB-API contract as
        read_sql; row values bind positionally in column order)."""
        conn = connection_factory()
        try:
            cur = conn.cursor()
            for block in self.iter_blocks():
                rows = [tuple(
                    v.item() if hasattr(v, "item") else v
                    for v in row.values())
                    for row in block_rows(block)]
                if rows:
                    cur.executemany(sql, rows)
            conn.commit()
        finally:
            conn.close()

    def write_webdataset(self, path: str) -> None:
        """One ``part-NNNNN.tar`` shard per block, one member per
        column per row keyed webdataset-style (reference:
        Dataset.write_webdataset). bytes columns write raw; str utf-8;
        ints/floats as decimal text (so ``cls``-style columns
        round-trip through read_webdataset's int parsing)."""
        import io as iolib
        import os
        import tarfile
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            with tarfile.open(f"{path}/part-{i:05d}.tar", "w") as tf:
                for j, row in enumerate(block_rows(block)):
                    key = row.get("__key__", f"{i:05d}{j:06d}")
                    for col, v in row.items():
                        if col == "__key__":
                            continue
                        if isinstance(v, bytes):
                            payload = v
                        elif isinstance(v, str):
                            payload = v.encode()
                        elif hasattr(v, "item"):
                            payload = str(v.item()).encode()
                        else:
                            payload = str(v).encode()
                        info = tarfile.TarInfo(f"{key}.{col}")
                        info.size = len(payload)
                        tf.addfile(info, iolib.BytesIO(payload))

    def write_images(self, path: str, column: str = "image", *,
                     file_format: str = "png") -> None:
        """Rows of ``column`` (HWC uint8 arrays) -> image files
        (reference: Dataset.write_images; PIL encode)."""
        import os
        from PIL import Image
        os.makedirs(path, exist_ok=True)
        k = 0
        for block in self.iter_blocks():
            for row in block_rows(block):
                arr = np.asarray(row[column])
                Image.fromarray(arr).save(
                    f"{path}/img-{k:06d}.{file_format}")
                k += 1

    def write_bigquery(self, project_id: str, dataset: str, *,
                       transport=None) -> None:
        """Stream rows via tabledata.insertAll (reference:
        Dataset.write_bigquery). Same injectable transport as
        read_bigquery."""
        from ray_tpu_torch.data.io import _BigQueryRest
        t = transport if transport is not None else _BigQueryRest()
        try:
            ds_id, table_id = dataset.split(".", 1)
        except ValueError:
            raise ValueError(
                f"dataset must be 'dataset_id.table_id', got {dataset!r}"
            ) from None
        url = (f"{_BigQueryRest.BASE}/projects/{project_id}/datasets/"
               f"{ds_id}/tables/{table_id}/insertAll")
        for block in self.iter_blocks():
            payload = [{"json": {
                k: (v.item() if hasattr(v, "item") else
                    v.tolist() if hasattr(v, "tolist") else v)
                for k, v in row.items()}} for row in block_rows(block)]
            if payload:
                out = t("POST", url, None, {"rows": payload})
                errs = out.get("insertErrors")
                if errs:
                    raise RuntimeError(f"bigquery insertAll: {errs}")

    def write_datasink(self, datasink) -> None:
        """Custom sink seam (reference: Dataset.write_datasink /
        ray.data.Datasink): calls ``on_write_start()``, ``write(block)``
        per block, then ``on_write_complete()`` —
        ``on_write_failed(err)`` on any raise."""
        start = getattr(datasink, "on_write_start", None)
        if start:
            start()
        try:
            for block in self.iter_blocks():
                datasink.write(block)
        except BaseException as e:
            failed = getattr(datasink, "on_write_failed", None)
            if failed:
                failed(e)
            raise
        done = getattr(datasink, "on_write_complete", None)
        if done:
            done()

    # -- refs exports (counterparts of the from_*_refs constructors) --

    def to_arrow_refs(self) -> list:
        """Blocks as stored ``pyarrow.Table`` ObjectRefs (reference:
        Dataset.to_arrow_refs)."""
        _require("pyarrow", "to_arrow_refs")
        return [ray_tpu_torch.put(b.to_arrow()) for b in self.iter_blocks()]

    def to_pandas_refs(self) -> list:
        """(reference: Dataset.to_pandas_refs)"""
        _require("pandas", "to_pandas_refs")
        return [ray_tpu_torch.put(b.to_pandas()) for b in self.iter_blocks()]

    def to_numpy_refs(self, *, column: str | None = None) -> list:
        """(reference: Dataset.to_numpy_refs — one ref per block;
        dict of all columns, or just ``column``)."""
        out = []
        for block in self.iter_blocks():
            batch = block_to_batch(block)
            out.append(ray_tpu_torch.put(
                batch[column] if column is not None else batch))
        return out

    def iter_torch_batches(self, batch_size: int | None = None,
                           drop_last: bool = False,
                           device: str | None = None):
        """Batches as torch tensors (reference:
        Dataset.iter_torch_batches; non-numeric columns pass through).
        A format conversion, as ``iter_batches``: CPU tensors unless
        ``device`` is given."""
        import torch
        for batch in self.iter_batches(batch_size, drop_last):
            out = {}
            for k, v in batch.items():
                arr = np.asarray(v)
                if arr.dtype == object:
                    out[k] = v
                    continue
                arr = np.ascontiguousarray(arr)
                if not arr.flags.writeable:
                    arr = arr.copy()   # torch rejects read-only views
                t = torch.from_numpy(arr)
                out[k] = t.to(device) if device else t
            yield out

    def to_pandas(self):
        """Materialize as one pandas DataFrame (reference:
        Dataset.to_pandas)."""
        pd = _require("pandas", "to_pandas")
        # Keep empty blocks that carry a schema: an all-filtered
        # dataset must still yield its columns.
        blocks = [b for b in self.iter_blocks() if b.num_columns]
        if not blocks:
            return pd.DataFrame()
        return concat_blocks(blocks).to_pandas()

    def to_torch(self, *, label_column: str | None = None,
                 batch_size: int | None = None,
                 drop_last: bool = False):
        """A torch ``IterableDataset`` over this Dataset (reference:
        Dataset.to_torch). Without ``label_column`` it yields batch
        dicts of tensors; with it, ``(features_dict, label_tensor)``
        pairs — re-iterating re-streams the pipeline."""
        import torch
        from torch.utils.data import IterableDataset

        outer = self

        class _TorchDataset(IterableDataset):
            def __iter__(self):
                for batch in outer.iter_torch_batches(
                        batch_size=batch_size, drop_last=drop_last):
                    if label_column is None:
                        yield batch
                    else:
                        label = batch.pop(label_column)
                        yield batch, label

        _ = torch  # import check only
        return _TorchDataset()

    def iter_tf_batches(self, batch_size: int | None = None,
                        drop_last: bool = False):
        """Batches as tf tensors (reference: Dataset.iter_tf_batches).
        Soft-gated on tensorflow: a clear ImportError where it is
        absent."""
        try:
            import tensorflow as tf
        except ImportError as e:
            raise ImportError(
                "iter_tf_batches requires tensorflow, which is not "
                "installed in this environment") from e
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            yield {k: tf.convert_to_tensor(v) for k, v in batch.items()}

    def to_tf(self, feature_columns, label_columns, *,
              batch_size: int = 1):
        """A ``tf.data.Dataset`` of (features, labels) (reference:
        Dataset.to_tf). Gated on tensorflow availability like
        iter_tf_batches."""
        try:
            import tensorflow as tf
        except ImportError as e:
            raise ImportError(
                "to_tf requires tensorflow, which is not installed "
                "in this environment") from e

        feats = ([feature_columns] if isinstance(feature_columns, str)
                 else list(feature_columns))
        labels = ([label_columns] if isinstance(label_columns, str)
                  else list(label_columns))

        def gen():
            for batch in self.iter_batches(batch_size=batch_size):
                f = {k: batch[k] for k in feats}
                l = {k: batch[k] for k in labels}
                yield (f[feats[0]] if len(feats) == 1 else f,
                       l[labels[0]] if len(labels) == 1 else l)

        # One eager probe batch builds the TensorSpecs (the generator
        # re-streams the pipeline when tf.data first iterates).
        probe = self.take_batch(batch_size)
        if not probe:
            raise ValueError(
                "to_tf needs at least one row to derive the output "
                "signature; the dataset is empty")

        def sig(cols):
            specs = {
                k: tf.TensorSpec(
                    shape=(None, *np.asarray(probe[k]).shape[1:]),
                    dtype=tf.as_dtype(np.asarray(probe[k]).dtype))
                for k in cols}
            return specs[cols[0]] if len(cols) == 1 else specs

        return tf.data.Dataset.from_generator(
            gen, output_signature=(sig(feats), sig(labels)))

    def take_batch(self, batch_size: int = 20
                   ) -> dict[str, np.ndarray]:
        """First ``batch_size`` rows as one batch dict (reference:
        Dataset.take_batch)."""
        for batch in self.limit(batch_size).iter_batches(
                batch_size=batch_size):
            return batch
        return {}

    def __repr__(self):
        return f"Dataset(stages={len(self._plan)})"


class DataIterator:
    """Picklable per-consumer shard iterator (usable inside trainer
    actors; execution happens in the consuming process, streaming
    through the shared driver runtime)."""

    def __init__(self, ds: Dataset, shard: int, num_shards: int):
        self._ds = ds
        self._shard = shard
        self._num_shards = num_shards

    def _shard_refs(self):
        for i, ref in enumerate(self._ds._stream_blocks()):
            if i % self._num_shards == self._shard:
                yield ref

    def iter_batches(self, batch_size: int | None = None,
                     drop_last: bool = False,
                     batch_format: str = "numpy"):
        convert = _convert_for(batch_format)
        blocks = (ray_tpu_torch.get(ref) for ref in self._shard_refs())
        return _batched_blocks(blocks, batch_size, drop_last, convert)

    def iter_device_batches(self, batch_size: int, mesh=None,
                            seq_sharded: bool = False,
                            prefetch: int | None = None, device=None):
        """Double-buffered device feed: a background thread pulls host
        batches (``drop_last``), places them on the card, and keeps up
        to ``prefetch`` device-resident batches queued ahead of the
        consumer, so host decode and the host-to-device copy overlap
        device compute (the same pipeline as the train loop's
        ``train.prefetch_to_device``: each batch copied into pinned
        host memory, then to the card on a side stream that the
        consumer's stream waits on).

        On the card by default, as every entry point of the port
        (``device="cpu"`` yields CPU tensors; without a card the call
        raises). With ``mesh``, each batch is this rank's block of the
        global batch (``train.shard_batch``: the batch split over the
        data axes, the sequence over ``sp`` when ``seq_sharded``),
        copied to ``mesh.device`` the same way. Object columns stay on
        the host."""
        from ray_tpu_torch.train.prefetch import prefetch_to_device
        if prefetch is None:
            from ray_tpu_torch.data.context import DataContext
            prefetch = DataContext.get_current().prefetch_batches
        place = None
        if mesh is not None:
            from ray_tpu_torch.train.step import shard_batch
            device = mesh.device

            def place(b):  # noqa: E306
                return shard_batch(b, mesh, seq_sharded=seq_sharded)
        return DeviceFeed(prefetch_to_device(
            self.iter_batches(batch_size, drop_last=True), device,
            depth=max(1, int(prefetch)), place=place))


class DeviceFeed:
    """The iterator ``iter_device_batches`` returns: the batches of its
    ``prefetcher`` (a ``train.DevicePrefetcher``, whose ``stall_s``,
    ``produce_s`` and ``batches`` read the feed), stopped when the
    batches end, on ``close()`` and when the feed is dropped."""

    def __init__(self, prefetcher):
        self.prefetcher = prefetcher

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.prefetcher)
        except BaseException:
            self.prefetcher.close()
            raise

    def close(self) -> None:
        self.prefetcher.close()

    def __del__(self):
        self.close()



# -- executor helpers ------------------------------------------------------

def _task_fusable(op) -> bool:
    # Actor-pool map_batches stages can't fuse into plain tasks: they
    # run in their own long-lived actor pool.
    return isinstance(op, _FUSABLE) and getattr(op, "compute",
                                                None) is None


def _split_stages(plan: list) -> list[tuple[str, Any]]:
    """Optimizer: fuse transform chains; barriers separate stages."""
    stages: list[tuple[str, Any]] = []
    i = 0
    assert isinstance(plan[0], _Source), "plan must start with a source"
    fused: list = []
    i = 1
    while i < len(plan) and _task_fusable(plan[i]):
        fused.append(plan[i])
        i += 1
    stages.append(("source", (plan[0].read_fns, fused)))
    while i < len(plan):
        op = plan[i]
        if isinstance(op, _MapBatches) and op.compute is not None:
            stages.append(("actor_map", op))
            i += 1
        elif isinstance(op, _Repartition):
            stages.append(("repartition", op.num_blocks))
            i += 1
        elif isinstance(op, _RandomShuffle):
            stages.append(("shuffle", op.seed))
            i += 1
        elif isinstance(op, _Limit):
            stages.append(("limit", op.n))
            i += 1
        elif isinstance(op, _Sort):
            stages.append(("sort", op))
            i += 1
        elif isinstance(op, _GroupBy):
            stages.append(("groupby", op))
            i += 1
        elif isinstance(op, _Zip):
            stages.append(("zip", op))
            i += 1
        elif isinstance(op, _Union):
            stages.append(("union", op))
            i += 1
        else:
            fused = []
            while i < len(plan) and _task_fusable(plan[i]):
                fused.append(plan[i])
                i += 1
            stages.append(("fused", fused))
    return stages


# Last actor-pool run's observability (tests assert autoscaling and
# the in-flight bound without reaching into the generator).
LAST_ACTOR_POOL_STATS: dict = {}


@ray_tpu_torch.remote(num_cpus=0)
class _PoolWorker:
    """One actor of an ActorPoolStrategy pool. A CLASS udf is
    constructed once here (stateful UDFs: load the model once, apply
    per block — reference: ActorPoolMapOperator's actor UDFs)."""

    def __init__(self, fn, fn_kwargs, batch_format: str = "numpy"):
        self._fn = fn() if isinstance(fn, type) else fn
        self._kw = dict(fn_kwargs or {})
        self._convert = _convert_for(batch_format)

    def apply(self, block):
        out = self._fn(self._convert(block), **self._kw)
        return to_block(out)


def _actor_map(upstream, op: _MapBatches):
    """Streaming actor-pool stage: pulls upstream lazily (bounded:
    pool_size * max_tasks_in_flight_per_actor blocks outstanding —
    the operator's backpressure budget), assigns blocks to the least
    loaded actor, grows the pool when every actor is busy, retires
    idle actors during drain, yields refs in submission order."""
    from collections import deque

    strat = op.compute
    mn, mx = strat.resolve()
    per = max(1, strat.max_tasks_in_flight_per_actor)
    mk = lambda: _PoolWorker.options(  # noqa: E731
        num_cpus=strat.num_cpus).remote(
            op.fn, op.fn_kwargs,
            getattr(op, "batch_format", "numpy"))
    pool: list = [mk() for _ in range(mn)]
    load: list[int] = [0] * mn
    order: deque = deque()            # (out_ref, actor_index)
    stats = {"max_actors": len(pool), "final_actors": len(pool),
             "max_in_flight": 0, "submitted": 0}
    LAST_ACTOR_POOL_STATS.clear()
    LAST_ACTOR_POOL_STATS.update(stats)
    it = iter(upstream)
    exhausted = False

    def _can_grow() -> bool:
        # Resource-aware scale-up (reference: ActorPoolMapOperator
        # consults the resource manager): a new actor permanently
        # reserves its CPUs, so growing must leave headroom for the
        # upstream block tasks — otherwise the pool starves its own
        # input and the pipeline deadlocks.
        if strat.num_cpus <= 0:
            return True
        try:
            avail = ray_tpu_torch.available_resources().get("CPU", 0.0)
        except Exception:  # noqa: BLE001
            return False
        return avail >= strat.num_cpus + 1.0

    def submit(block_ref):
        idx = min(range(len(pool)), key=load.__getitem__)
        if load[idx] >= 1 and len(pool) < mx and _can_grow():
            # Backlog: every actor busy — scale up.
            pool.append(mk())
            load.append(0)
            idx = len(pool) - 1
            stats["max_actors"] = max(stats["max_actors"], len(pool))
        load[idx] += 1
        order.append((pool[idx].apply.remote(block_ref), idx))
        stats["submitted"] += 1
        stats["max_in_flight"] = max(stats["max_in_flight"],
                                     len(order))

    try:
        while True:
            while not exhausted and len(order) < len(pool) * per:
                try:
                    submit(next(it))
                except StopIteration:
                    exhausted = True
            if not order:
                break
            ref, idx = order[0]
            ray_tpu_torch.wait([ref], num_returns=1)
            order.popleft()
            load[idx] -= 1
            if exhausted:
                # Drain-phase downscale: retire idle actors above the
                # floor (reference: the actor pool shrinks when the
                # operator's input is exhausted).
                for i in range(len(pool) - 1, mn - 1, -1):
                    if load[i] == 0 and len(pool) > mn:
                        a = pool.pop(i)
                        load.pop(i)
                        order_fixup = deque(
                            (r, j - 1 if j > i else j)
                            for r, j in order)
                        order.clear()
                        order.extend(order_fixup)
                        try:
                            ray_tpu_torch.kill(a)
                        except Exception:  # noqa: BLE001
                            pass
            yield ref
    finally:
        stats["final_actors"] = len(pool)
        LAST_ACTOR_POOL_STATS.update(stats)
        for a in pool:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass


def _bounded_submit(task_iter, max_in_flight: int,
                    op_name: str = "map"):
    """Submit lazily under the backpressure policy chain; yield refs
    in submission order.

    Reference: the streaming executor consulting its backpressure
    policies before each task launch
    (backpressure_policy/concurrency_cap_backpressure_policy.py) with
    per-operator usage accounting (execution/resource_manager.py).
    The concurrency cap is always active; a store-memory budget (and
    any custom policies) come from the DataContext."""
    import time as _time

    from ray_tpu_torch.data.backpressure import (
        default_policies,
        get_resource_manager,
        ref_nbytes,
    )
    policies = default_policies(max_in_flight)
    manager = get_resource_manager()
    usage = manager.register(op_name)
    pending: list = []

    def harvest_one():
        # Wait on the HEAD (not any-of): yields are in submission
        # order anyway, and a head that is still running must not be
        # counted as a completed zero-byte block — that would shrink
        # the operator's average output size and over-admit launches.
        ray_tpu_torch.wait([pending[0]], num_returns=1)
        ref = pending.pop(0)
        usage.in_flight = len(pending)
        usage.blocks_done += 1
        usage.bytes_done += ref_nbytes(ref)
        return ref

    for fn, args in task_iter:
        while not all(p.can_launch(usage, manager) for p in policies):
            if pending:
                yield harvest_one()
            else:
                # Over budget with nothing of ours in flight: the
                # bytes belong to neighbors — sample again shortly.
                # (Policies admit when in_flight == 0, so only a
                # custom policy can reach here.)
                _time.sleep(0.01)
        pending.append(fn.remote(*args))
        usage.in_flight = len(pending)
    while pending:
        yield harvest_one()


@ray_tpu_torch.remote
def _concat_task(*blocks):
    return concat_blocks(list(blocks))


def _do_repartition(refs: list, num_blocks: int) -> list:
    total_ref = _concat_task.remote(*refs)
    total = ray_tpu_torch.get(total_ref)
    n = total.num_rows
    per = max(1, n // num_blocks)
    bounds = [(i * per, min(n, (i + 1) * per) if i < num_blocks - 1
               else n) for i in range(num_blocks)]
    bounds = [(s, e) for s, e in bounds if s < e or n == 0]
    return [_slice_task.remote(total_ref, s, e) for s, e in bounds]


@ray_tpu_torch.remote
def _slice_task(block, start, end):
    return slice_block(block, start, end)


@ray_tpu_torch.remote
def _random_partition(block, num_parts, seed):
    """Scatter rows uniformly into num_parts sub-blocks. Called with
    options(num_returns=num_parts): each partition becomes its OWN
    object, so a downstream reducer fetches only its column — every
    byte moves once, not once per reducer."""
    import numpy as np
    batch = block_to_batch(block)
    n = block.num_rows
    ids = (np.random.default_rng(seed).integers(0, num_parts, n)
           if n else np.zeros(0, np.int64))
    parts = tuple(to_block({k: np.asarray(v)[ids == p]
                            for k, v in batch.items()})
                  for p in range(num_parts))
    return parts if num_parts > 1 else parts[0]


@ray_tpu_torch.remote
def _merge_shuffle(seed, *parts):
    """Concat one partition's pieces from every mapper and permute."""
    import numpy as np
    merged = concat_blocks(list(parts))
    if merged.num_rows == 0:
        return merged
    batch = block_to_batch(merged)
    perm = np.random.default_rng(seed).permutation(merged.num_rows)
    return to_block({k: np.asarray(v)[perm] for k, v in batch.items()})


def _do_shuffle(refs: list, seed: int | None) -> list:
    """True all-to-all shuffle (reference: push-based full shuffle):
    every input block scatters its rows uniformly across P output
    partitions; each output concatenates its pieces from every input
    and permutes — any row can land anywhere, unlike a blockwise
    permute. Unseeded shuffles draw fresh entropy (a fixed default
    would silently repeat the same "shuffle" every epoch)."""
    if not refs:
        return refs
    num_parts = len(refs)
    if seed is None:
        import os as _os
        base = int.from_bytes(_os.urandom(4), "little")
    else:
        base = seed
    # cols[i] = list of num_parts refs from mapper i
    cols = [_random_partition.options(num_returns=num_parts).remote(
                r, num_parts, base + i)
            for i, r in enumerate(refs)]
    if num_parts == 1:
        cols = [[c] for c in cols]
    return [_merge_shuffle.remote(base + 7919 * (p + 1),
                                  *[cols[i][p]
                                    for i in range(len(refs))])
            for p in range(num_parts)]


def _do_limit(refs, n: int):
    taken = 0
    for ref in refs:
        if taken >= n:
            break
        block = ray_tpu_torch.get(ref)
        rows = block.num_rows
        if taken + rows <= n:
            taken += rows
            yield ref
        else:
            yield _slice_task.remote(ref, 0, n - taken)
            taken = n


# -- distributed sort (sample → range partition → per-part sort) -----------

@ray_tpu_torch.remote
def _sample_keys(block, key, k):
    import numpy as np
    vals = np.asarray(block_to_batch(block)[key]) if block.num_rows \
        else np.asarray([])
    if len(vals) <= k:
        return vals
    idx = np.random.default_rng(0).choice(len(vals), k, replace=False)
    return vals[idx]


@ray_tpu_torch.remote
def _range_partition(block, key, cutoffs):
    """Split one block into len(cutoffs)+1 range partitions (one
    return object per partition — see _random_partition)."""
    import numpy as np
    batch = block_to_batch(block)
    vals = np.asarray(batch[key]) if block.num_rows else \
        np.asarray([])
    part_ids = np.searchsorted(np.asarray(cutoffs), vals,
                               side="right")
    parts = []
    for p in range(len(cutoffs) + 1):
        mask = part_ids == p
        parts.append(to_block(
            {k: np.asarray(v)[mask] for k, v in batch.items()}))
    return tuple(parts) if len(parts) > 1 else parts[0]


@ray_tpu_torch.remote
def _sort_partition(key, descending, *parts):
    merged = concat_blocks(list(parts)) if parts else Block({})
    if merged.num_rows == 0:
        return merged
    return _take(merged, _stable_order(merged.column(key), descending))


def _stable_order(vals: np.ndarray, descending: bool) -> np.ndarray:
    """Row order sorting ``vals``, ties in their input order in both
    directions (pyarrow's ``sort_by`` is stable both ways; reversing a
    stable ascending sort would reverse the ties)."""
    if not descending:
        return np.argsort(vals, kind="stable")
    n = len(vals)
    return n - 1 - np.argsort(vals[::-1], kind="stable")[::-1]


def _take(block: Block, idx: np.ndarray) -> Block:
    return Block({k: block.column(k)[idx] for k in block.column_names},
                 len(idx))


def _do_sort(refs: list, op: "_Sort") -> list:
    import numpy as np
    if not refs:
        return refs
    num_parts = len(refs)
    samples = ray_tpu_torch.get(
        [_sample_keys.remote(r, op.key, 64) for r in refs])
    allv = np.sort(np.concatenate([s for s in samples]))
    if len(allv) == 0 or num_parts == 1:
        return [_sort_partition.remote(
            op.key, op.descending, 0,
            _range_partition.remote(r, op.key, [])) for r in refs][:1] \
            if num_parts == 1 else refs
    cut_idx = [int(len(allv) * (i + 1) / num_parts)
               for i in range(num_parts - 1)]
    cutoffs = [allv[min(i, len(allv) - 1)] for i in cut_idx]
    cols = [_range_partition.options(num_returns=num_parts).remote(
                r, op.key, cutoffs)
            for r in refs]
    if num_parts == 1:
        cols = [[c] for c in cols]
    order = (range(num_parts) if not op.descending
             else reversed(range(num_parts)))
    return [_sort_partition.remote(op.key, op.descending,
                                   *[cols[i][p]
                                     for i in range(len(refs))])
            for p in order]


# -- distributed group-by (hash partition → per-part aggregate) ------------

@ray_tpu_torch.remote
def _hash_partition(block, key, num_parts):
    """Called with options(num_returns=num_parts): one object per
    partition (see _random_partition)."""
    import numpy as np
    batch = block_to_batch(block)
    if block.num_rows == 0:
        empty = {k: np.asarray(v)[:0] for k, v in batch.items()}
        parts = tuple(to_block(empty) for _ in range(num_parts))
    else:
        vals = np.asarray(batch[key])
        # stable content hash (python hash() is randomized per proc)
        import zlib
        ids = np.asarray([
            zlib.crc32(repr(v).encode()) % num_parts for v in vals])
        parts = tuple(to_block({k: np.asarray(v)[ids == p]
                                for k, v in batch.items()})
                      for p in range(num_parts))
    return parts if num_parts > 1 else parts[0]


@ray_tpu_torch.remote
def _agg_partition(key, agg, *parts):
    merged = concat_blocks(list(parts)) if parts else Block({})
    if merged.num_rows == 0:
        return Block({})
    kind, col = agg
    if kind == "map_groups":
        out_rows = []
        batch = block_to_batch(merged)
        import numpy as np
        keys = np.asarray(batch[key])
        for kv in sorted(set(keys.tolist())):
            mask = keys == kv
            group = {c: np.asarray(v)[mask] for c, v in batch.items()}
            res = col(group)
            if isinstance(res, dict):
                out_rows.append(res)
            else:
                out_rows.extend(res)
        return to_block(out_rows)
    return _group_aggregate(merged, key, kind, col)


def _group_aggregate(block: Block, key: str, kind: str, col) -> Block:
    """pyarrow's hash aggregation on numpy (``Table.group_by(key)
    .aggregate``): one row per key in order of first appearance, the
    key column first; ``count()``, ``sum`` (int64, uint64 or float64,
    as arrow widens), ``mean`` (float64), ``min``/``max`` (the column's
    dtype) and ``std`` (sample, ddof = 1: float64, NaN for a group of
    one row, arrow's null). Sums run in numpy's order, not arrow's: a
    float column's sums and means may differ in the last bits."""
    keys = block.column(key)
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    by_first = np.argsort(first, kind="stable")
    rank = np.empty_like(by_first)
    rank[by_first] = np.arange(len(by_first))
    group = rank[inverse.reshape(-1)]
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group, minlength=len(uniq))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out_key = keys[np.sort(first)]
    if kind == "count":
        return Block({key: out_key, "count()": counts.astype(np.int64)})
    vals = block.column(col)[order]
    segments = np.split(vals, starts[1:])
    if kind == "sum":
        wide = (np.int64 if vals.dtype.kind in "ib" else
                np.uint64 if vals.dtype.kind == "u" else np.float64)
        out = np.asarray([s.sum(dtype=wide) for s in segments], wide)
    elif kind == "mean":
        out = np.asarray([s.sum(dtype=np.float64) / len(s)
                          for s in segments], np.float64)
    elif kind in ("min", "max"):
        pick = np.min if kind == "min" else np.max
        out = np.asarray([pick(s) for s in segments], vals.dtype)
    elif kind == "std":
        out = np.asarray([np.sqrt(np.sum((s - s.mean(dtype=np.float64))
                                         ** 2) / (len(s) - 1))
                          if len(s) > 1 else np.nan
                          for s in segments], np.float64)
    else:
        raise ValueError(f"unknown group aggregation {kind!r}")
    return Block({key: out_key, f"{kind}({col})": out})


def _do_groupby(refs: list, op: "_GroupBy") -> list:
    if not refs:
        return refs
    from ray_tpu_torch.data.context import DataContext
    cap = DataContext.get_current().groupby_num_partitions
    num_parts = op.num_partitions or min(len(refs), cap)
    cols = [_hash_partition.options(num_returns=num_parts).remote(
                r, op.key, num_parts)
            for r in refs]
    if num_parts == 1:
        cols = [[c] for c in cols]
    return [_agg_partition.remote(op.key, op.agg,
                                  *[cols[i][p]
                                    for i in range(len(refs))])
            for p in range(num_parts)]


# -- zip -------------------------------------------------------------------

@ray_tpu_torch.remote
def _zip_blocks(a, b):
    names = set(a.column_names)
    cols = {n: a.column(n) for n in a.column_names}
    for n in b.column_names:
        out = f"{n}_1" if n in names else n
        cols[out] = b.column(n)
    return Block(cols, a.num_rows)


@ray_tpu_torch.remote
def _num_rows_task(block):
    return block.num_rows


def _do_zip(refs: list, op: "_Zip") -> list:
    a_ref = _concat_task.remote(*refs)
    b_refs = list(op.other._stream_blocks())
    b_ref = _concat_task.remote(*b_refs)
    # Row counts via tiny tasks — the concatenated tables themselves
    # never transit the driver.
    na, nb = ray_tpu_torch.get([_num_rows_task.remote(a_ref),
                          _num_rows_task.remote(b_ref)])
    if na != nb:
        raise ValueError(
            f"zip requires equal row counts ({na} vs {nb})")
    zipped = _zip_blocks.remote(a_ref, b_ref)
    num_blocks = max(1, len(refs))
    per = (na + num_blocks - 1) // num_blocks
    return [_slice_task.remote(zipped, s, min(na, s + per))
            for s in range(0, na, per)]


class GroupedData:
    """Result of ``Dataset.groupby`` (reference:
    ray.data.grouped_data.GroupedData): each aggregate runs as a
    hash-shuffle (all-to-all) followed by per-partition arrow
    group-by aggregation tasks (numpy, with pyarrow's results)."""

    def __init__(self, ds: Dataset, key: str,
                 num_partitions: int | None = None):
        self._ds = ds
        self._key = key
        self._parts = num_partitions

    def _agg(self, kind: str, col) -> Dataset:
        return self._ds._append(
            _GroupBy(self._key, (kind, col), self._parts))

    def count(self) -> Dataset:
        return self._agg("count", None)

    def sum(self, col: str) -> Dataset:
        return self._agg("sum", col)

    def mean(self, col: str) -> Dataset:
        return self._agg("mean", col)

    def min(self, col: str) -> Dataset:
        return self._agg("min", col)

    def max(self, col: str) -> Dataset:
        return self._agg("max", col)

    def std(self, col: str) -> Dataset:
        return self._agg("std", col)

    def map_groups(self, fn: Callable) -> Dataset:
        """fn(group_batch: dict[str, np.ndarray]) -> dict-row or
        list of dict-rows."""
        return self._agg("map_groups", fn)

    def aggregate(self, *aggs) -> Dataset:
        """AggregateFn descriptors per group -> one row per group
        keyed by each agg's name (reference: GroupedData.aggregate)."""
        from ray_tpu_torch.data.aggregate import AggregateFn
        for a in aggs:
            if not isinstance(a, AggregateFn):
                raise TypeError(f"expected AggregateFn, got {type(a)!r}")
        key = self._key

        def agg_group(batch):
            n = len(next(iter(batch.values()))) if batch else 0
            row = {key: np.asarray(batch[key])[0]}
            for a in aggs:
                col = (np.asarray(batch[a.on]) if a.on is not None
                       else np.zeros(n))
                row[a.name] = a.finalize(
                    a.accumulate_block(a.init(), col))
            return row

        return self.map_groups(agg_group)
