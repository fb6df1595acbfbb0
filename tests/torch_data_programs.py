"""Small Data programs, each run once on ``ray_tpu`` and once on
``ray_tpu_torch`` (tests/test_torch_data.py).

Every program takes the package module (``rt``), reaches the Data
library as ``rt.data`` and uses only its public API, so the same code
runs on both. Its result goes through :func:`canon`, which spells out
every array's dtype, shape and values (and every row's column order),
so two results are equal only if the batches a user would see are.
Nothing here imports either package at module level: a worker that
unpickles one of these functions loads numpy and the package it runs in.

``PYARROW_FREE`` names the programs that need neither pyarrow nor
pandas: the port runs them again in a process where both are blocked.
"""

from __future__ import annotations

import importlib
import math
import os
import shutil
import tempfile

import numpy as np


def _data(rt):
    return importlib.import_module(rt.__name__ + ".data")


def canon(x):
    """A plain, comparable form of a result: arrays as (dtype, shape,
    values), numpy scalars as (dtype, value), dicts as ordered (key,
    value) pairs, NaN as the string "nan"."""
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return ("object", x.shape, [canon(v) for v in x.ravel()])
        return ("array", x.dtype.str, x.shape, canon(x.tolist()))
    if isinstance(x, np.generic):
        return ("scalar", x.dtype.str, canon(x.item()))
    if isinstance(x, dict):
        return ("dict", [(k, canon(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if type(x).__module__.startswith("torch"):
        return ("tensor", str(x.dtype), canon(x.numpy()))
    if type(x).__name__ == "DataFrame":
        return ("frame", [(c, canon(x[c].to_numpy())) for c in x.columns])
    return x


def _rows(ds) -> list:
    return ds.take_all()


def _tmp() -> str:
    return tempfile.mkdtemp(prefix="torch_data_programs_")


# -- sources ----------------------------------------------------------------


def range_blocks(rt):
    ds = _data(rt).range(10, parallelism=3)
    return [_rows(ds), ds.count(), ds.columns(), ds.num_blocks()]


def from_items_rows(rt):
    data = _data(rt)
    rows = [{"i": i, "f": i / 4, "s": f"row{i}", "b": i % 2 == 0}
            for i in range(7)]
    ds = data.from_items(rows, parallelism=3)
    plain = data.from_items(["x", "yy", "zzz"])
    return [_rows(ds), ds.columns(), _rows(plain)]


def from_numpy_2d(rt):
    data = _data(rt)
    x = np.arange(48, dtype=np.float32).reshape(12, 2, 2)
    ds = data.from_numpy({"x": x, "y": np.arange(12, dtype=np.int32)},
                         parallelism=3)
    return [list(ds.iter_batches(5)), ds.take(2),
            list(data.from_numpy(np.arange(6).reshape(3, 2)
                                 ).iter_batches(None))]


# -- row and batch transforms ----------------------------------------------


def map_filter_flat_map(rt):
    ds = (_data(rt).range(12, parallelism=4)
          .map(lambda r: {"id": r["id"], "half": r["id"] / 2})
          .filter(lambda r: r["id"] % 3 != 0)
          .flat_map(lambda r: [r, {"id": r["id"] + 100,
                                   "half": r["half"]}]))
    return _rows(ds)


def _numpy_udf(batch):
    return {"id": batch["id"], "sq": (batch["id"] ** 2).astype(np.float32),
            "tag": np.asarray([f"t{i}" for i in batch["id"]])}


def map_batches_numpy(rt):
    ds = _data(rt).range(10, parallelism=2).map_batches(_numpy_udf)
    return [_rows(ds), list(ds.iter_batches(4))]


def _pandas_udf(df):
    df["twice"] = df["id"] * 2
    df["ratio"] = df["id"] / 4.0
    return df


def map_batches_pandas(rt):
    ds = _data(rt).range(9, parallelism=3).map_batches(
        _pandas_udf, batch_format="pandas")
    return [_rows(ds), ds.columns()]


def _arrow_udf(table):
    import pyarrow as pa
    return table.append_column(
        "neg", pa.array(table.column("id").to_numpy() * -1))


def map_batches_pyarrow(rt):
    ds = _data(rt).range(6, parallelism=2).map_batches(
        _arrow_udf, batch_format="pyarrow")
    return _rows(ds)


class _AddOffset:
    """A class UDF: built once in each pool actor."""

    def __init__(self):
        self.offset = 1000

    def __call__(self, batch):
        return {"id": batch["id"], "shifted": batch["id"] + self.offset}


def actor_pool(rt):
    data = _data(rt)
    ds = data.range(16, parallelism=4).map_batches(
        _AddOffset, compute=data.ActorPoolStrategy(size=2))
    return _rows(ds)


# -- all-to-all ----------------------------------------------------------------


def repartition_blocks(rt):
    ds = _data(rt).range(10, parallelism=2).repartition(3)
    return [_rows(ds), [b.num_rows for b in ds.iter_blocks()]]


def random_shuffle_seeded(rt):
    ds = _data(rt).range(24, parallelism=3).random_shuffle(seed=7)
    return _rows(ds)


def _tied(rt):
    keys = [3, 1, 2, 3, 1, 2, 3, 0, 1, 2, 3, 0]
    return _data(rt).from_items(
        [{"k": k, "pos": i} for i, k in enumerate(keys)], parallelism=3)


def sort_ascending_ties(rt):
    return _rows(_tied(rt).sort("k"))


def sort_descending_ties(rt):
    return [_rows(_tied(rt).sort("k", descending=True)),
            _rows(_data(rt).from_items(
                [{"s": s} for s in ["pear", "apple", "fig", "apple"]]
            ).sort("s", descending=True))]


def _grouped(rt):
    # Integer values with whole means and exact deviations, so every
    # statistic is exact in both packages' arithmetic.
    rows = [{"g": g, "v": v, "w": float(v)}
            for g, v in [("a", 1), ("b", 10), ("a", 3), ("c", 7),
                         ("b", 20), ("a", 5), ("b", 30), ("a", 7)]]
    return _data(rt).from_items(rows, parallelism=3)


def groupby_aggregates(rt):
    ds = _grouped(rt)
    out = []
    for kind, col in [("sum", "v"), ("mean", "v"), ("std", "v"),
                      ("min", "w"), ("max", "v"), ("sum", "w")]:
        out.append(_rows(getattr(ds.groupby("g"), kind)(col).sort("g")))
    out.append(_rows(ds.groupby("g").count().sort("g")))
    return out


def _group_summary(group):
    return {"g": group["g"][0], "n": len(group["v"]),
            "span": int(group["v"].max() - group["v"].min())}


def groupby_float_statistics(rt):
    """Random float columns: sums, means and stds whose last bits
    depend on the summation order (compared within CLOSE_RTOL)."""
    rng = np.random.default_rng(3)
    rows = [{"g": int(g), "x": float(x)} for g, x in
            zip(rng.integers(0, 4, 40), rng.normal(size=40) * 10)]
    ds = _data(rt).from_items(rows, parallelism=4)
    return [_rows(getattr(ds.groupby("g"), kind)("x").sort("g"))
            for kind in ("sum", "mean", "std", "min", "max")]


def groupby_map_groups(rt):
    return _rows(_grouped(rt).groupby("g").map_groups(_group_summary))


def zip_and_union(rt):
    data = _data(rt)
    a = data.range(6, parallelism=2)
    b = data.range(6, parallelism=3).map(
        lambda r: {"id": r["id"] * 10, "other": -r["id"]})
    return [_rows(a.zip(b)), _rows(a.union(data.range(3)))]


def splits(rt):
    data = _data(rt)
    ds = data.range(11, parallelism=3)
    return [[_rows(s) for s in ds.split(2)],
            [_rows(s) for s in ds.split_at_indices([3, 7])]]


def streaming_split_two(rt):
    its = _data(rt).range(10, parallelism=5).streaming_split(2)
    return [[b["id"] for b in it.iter_batches(2)] for it in its]


# -- consumption ---------------------------------------------------------------


def iter_batches_drop_last(rt):
    ds = _data(rt).range(10, parallelism=3)
    return [list(ds.iter_batches(4)),
            list(ds.iter_batches(4, drop_last=True)),
            list(ds.iterator().iter_batches(3, drop_last=True))]


def take_count_columns(rt):
    ds = _data(rt).range(9, parallelism=2).map(
        lambda r: {"a": r["id"], "b": r["id"] * 1.5})
    return [ds.take(3), ds.take_batch(4), ds.count(), ds.columns()]


def all_filtered_schema(rt):
    ds = _data(rt).range(6, parallelism=2).map(
        lambda r: {"x": r["id"], "y": float(r["id"])}).filter(
            lambda r: False)
    schema = ds.schema()
    return [ds.count(), ds.columns(), list(schema.names), ds.take_all()]


def schema_types(rt):
    """``str(ds.schema())`` and ``.types`` (by name) over float, string,
    int, bool, bytes, N-d tensor, list, struct and narrow numeric
    columns, from rows and from a batch function."""
    data = _data(rt)
    rows = [{"f": 0.5 * i, "s": f"s{i}", "i": i, "b": i % 2 == 0,
             "y": bytes([i]), "t": np.full((2, 3), i, np.float32),
             "l": [i, i + 1], "h": np.int16(i), "u": np.uint8(i),
             "f16": np.float16(i),
             "d": {"a": i, "b": f"b{i}", "c": [0.5 * i]}} for i in range(4)]
    batch = data.range(4, parallelism=2).map_batches(
        lambda b: {"x": b["id"].astype(np.int32),
                   "z": np.zeros((len(b["id"]), 5), np.int8),
                   "d": np.full(len(b["id"]), "2020-01-02",
                                dtype="datetime64[D]")})
    out = []
    for ds in (data.from_items(rows), data.from_numpy(np.zeros((4, 2, 2))),
               batch):
        schema = ds.schema()
        out.append([str(schema), [str(t) for t in schema.types],
                    list(schema.names)])
    return out


def all_filtered_to_pandas(rt):
    ds = _data(rt).range(6).map(lambda r: {"x": r["id"]}).filter(
        lambda r: False)
    df = ds.to_pandas()
    return [list(df.columns), len(df),
            _data(rt).range(4).to_pandas()]


def from_pandas_frames(rt):
    import pandas as pd
    data = _data(rt)
    indexed = pd.DataFrame({"a": [1, 2, 3], "s": ["x", "y", "z"]},
                           index=[10, 20, 30])
    return [_rows(data.from_pandas(indexed)),
            _rows(data.from_pandas(pd.DataFrame({"a": [1.5, 2.5]})))]


def torch_batches(rt):
    ds = _data(rt).from_numpy({"x": np.arange(12, dtype=np.int32)
                               .reshape(6, 2)}, parallelism=2)
    return list(ds.iter_torch_batches(batch_size=4))


# -- files ---------------------------------------------------------------------


def _tfrecord_rows(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 50257, 9).tolist(),
             "label": int(rng.integers(0, 10)),
             "score": float(np.float32(rng.random())),
             "name": f"ex{i}".encode()} for i in range(n)]


def _other(rt) -> str:
    return "ray_tpu" if rt.__name__ == "ray_tpu_torch" else "ray_tpu_torch"


def tfrecords_across_packages(rt):
    """Files written by the other package's TFRecord codec, read here;
    then this package's ``write_tfrecords`` read back."""
    data = _data(rt)
    other = importlib.import_module(_other(rt) + ".data.tfrecord")
    d = _tmp()
    try:
        for f in range(3):
            other.write_records(
                os.path.join(d, f"part-{f}.tfrecord"),
                [other.build_example(r) for r in _tfrecord_rows(4, f)])
        ds = data.read_tfrecords(d)
        first = _rows(ds)
        out = os.path.join(d, "again")
        ds.write_tfrecords(out)
        return [first, _rows(data.read_tfrecords(out))]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def tfrecords_raw_bytes(rt):
    data = _data(rt)
    codec = importlib.import_module(rt.__name__ + ".data.tfrecord")
    d = _tmp()
    try:
        path = os.path.join(d, "raw.tfrecord")
        codec.write_records(path, [b"", b"\x00abc\x00", bytes(range(256))])
        return _rows(data.read_tfrecords(path, raw_bytes=True,
                                         verify_crc=True))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def numpy_text_binary_files(rt):
    data = _data(rt)
    d = _tmp()
    try:
        np.save(os.path.join(d, "a.npy"), np.arange(6).reshape(3, 2))
        np.savez(os.path.join(d, "b.npz"), x=np.arange(4.0),
                 y=np.array([1, 0, 1, 1], dtype=bool))
        with open(os.path.join(d, "t.txt"), "w") as f:
            f.write("first line\n\nsecond\nthird line\n")
        with open(os.path.join(d, "blob.bin"), "wb") as f:
            f.write(b"\x00\x01binary\xff")
        npy = _rows(data.read_numpy(os.path.join(d, "a.npy")))
        npz = _rows(data.read_numpy(os.path.join(d, "b.npz")))
        text = _rows(data.read_text(os.path.join(d, "t.txt")))
        blob = [{k: (os.path.basename(v) if k == "path" else v)
                 for k, v in r.items()}
                for r in _rows(data.read_binary_files(
                    os.path.join(d, "blob.bin")))]
        return [npy, npz, text, blob]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def parquet_csv_json_files(rt):
    import pyarrow as pa
    import pyarrow.csv as pacsv
    import pyarrow.parquet as pq
    data = _data(rt)
    d = _tmp()
    try:
        table = pa.table({"i": np.arange(5), "f": np.linspace(0, 1, 5),
                          "s": ["a", "b", "c", "d", "e"]})
        pq.write_table(table, os.path.join(d, "t.parquet"))
        pacsv.write_csv(table, os.path.join(d, "t.csv"))
        with open(os.path.join(d, "t.json"), "w") as f:
            for r in table.to_pylist():
                f.write(f'{{"i": {r["i"]}, "s": "{r["s"]}"}}\n')
        out = [_rows(data.read_parquet(os.path.join(d, "t.parquet"))),
               _rows(data.read_csv(os.path.join(d, "t.csv"))),
               _rows(data.read_json(os.path.join(d, "t.json")))]
        data.range(4).write_parquet(os.path.join(d, "w"))
        out.append(_rows(data.read_parquet(os.path.join(d, "w"))))
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


# -- library pieces ------------------------------------------------------------


def aggregate_functions(rt):
    data = _data(rt)
    agg = importlib.import_module(rt.__name__ + ".data.aggregate")
    ds = data.from_items([{"x": v, "g": v % 2} for v in
                          [4, 8, 15, 16, 23, 42]], parallelism=3)
    whole = ds.aggregate(agg.Count(), agg.Sum("x"), agg.Min("x"),
                         agg.Max("x"), agg.Mean("x"), agg.Std("x"))
    grouped = _rows(ds.groupby("g").aggregate(agg.Sum("x"),
                                              agg.Max("x")))
    return [whole, grouped, ds.sum("x"), ds.min("x"), ds.max("x"),
            ds.mean("x"), ds.std("x"), ds.unique("g")]


def preprocessors(rt):
    data = _data(rt)
    pre = importlib.import_module(rt.__name__ + ".data.preprocessor")
    ds = data.from_items([{"a": float(v), "b": v * 2}
                          for v in [1, 2, 3, 4, 5, 6]], parallelism=2)
    scaler = pre.StandardScaler(["a"]).fit(ds)
    minmax = pre.MinMaxScaler(["b"])
    return [_rows(scaler.transform(ds)), _rows(minmax.fit_transform(ds)),
            scaler.transform_batch({"a": [7.0], "b": [0]})]


def context_knob(rt):
    data = _data(rt)
    ctx = data.DataContext.get_current()
    before = ctx.default_parallelism
    ctx.default_parallelism = 3
    try:
        ds = data.range(9)
        return [ds.num_blocks(), [b.num_rows for b in ds.iter_blocks()]]
    finally:
        ctx.default_parallelism = before


TABLE = {f.__name__: f for f in (
    range_blocks, from_items_rows, from_numpy_2d, map_filter_flat_map,
    map_batches_numpy, map_batches_pandas, map_batches_pyarrow,
    actor_pool, repartition_blocks, random_shuffle_seeded,
    sort_ascending_ties, sort_descending_ties, groupby_aggregates,
    groupby_float_statistics, groupby_map_groups, zip_and_union, splits, streaming_split_two,
    iter_batches_drop_last, take_count_columns, all_filtered_schema,
    schema_types,
    all_filtered_to_pandas, from_pandas_frames, torch_batches, tfrecords_across_packages,
    tfrecords_raw_bytes, numpy_text_binary_files, parquet_csv_json_files,
    aggregate_functions, preprocessors, context_knob)}

# Programs whose float results may differ in their last bits between the
# packages (pyarrow's summation order against numpy's): compared within
# CLOSE_RTOL, everything else in them exactly.
CLOSE = ("groupby_float_statistics",)
CLOSE_RTOL = 1e-12

PYARROW_FREE = tuple(name for name in TABLE if name not in (
    "map_batches_pandas", "map_batches_pyarrow", "all_filtered_to_pandas",
    "from_pandas_frames",
    "parquet_csv_json_files", "tfrecords_across_packages"))


def run(program, rt) -> tuple:
    """("ok", canonical result) or ("raised", class name, message)."""
    try:
        return ("ok", canon(program(rt)))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


# -- port-only probes --------------------------------------------------------


def block_worker_view(batch):
    """A map_batches probe: what the block task's worker has loaded and
    which cards it sees."""
    import sys
    n = len(next(iter(batch.values())))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & {
        "torch", "jax", "ray_tpu", "pyarrow", "pandas"})
    return {"loaded": np.asarray([",".join(loaded)] * n),
            "cuda": np.asarray(
                [os.environ.get("CUDA_VISIBLE_DEVICES", "unset")] * n),
            "pid": np.full(n, os.getpid())}


def lm_rows(n: int, vocab: int, seq: int, seed: int = 0) -> np.ndarray:
    """``n`` rows of ``seq + 1`` token ids (one TFRecord feature each)."""
    return np.random.default_rng(seed).integers(0, vocab, (n, seq + 1))


def write_lm_files(codec, directory: str, rows: np.ndarray,
                   files: int) -> None:
    """``rows`` as ``files`` TFRecord files of consecutive rows, one
    int64 feature ``tokens`` a row."""
    os.makedirs(directory, exist_ok=True)
    for f, part in enumerate(np.array_split(rows, files)):
        codec.write_records(
            os.path.join(directory, f"part-{f:05d}.tfrecord"),
            [codec.build_example({"tokens": r.tolist()}) for r in part])


def lm_batch_of(batch: dict) -> dict:
    """The LM's inputs of a batch of token rows (a map_batches function):
    int32 tokens and the next-token targets."""
    toks = np.stack(batch["tokens"]).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


# -- trainer loops on dataset shards (tests/test_torch_trainer.py) ------------

LM_BATCH = 4


def _checksums(batch) -> list[int]:
    """int64 sums of a batch's tokens and targets."""
    return [int(np.asarray(batch[k]).astype(np.int64).sum())
            for k in ("tokens", "targets")]


def data_loop(config):
    """GPT-2 tiny (float32, AdamW) from the given numpy weights on this
    rank's ``train`` shard, read through ``iter_device_batches``: one
    report a step; each step's loss and batch checksums, and the
    checksums of the unsplit ``eval`` dataset, written to
    ``config["out"]/<pkg>_rank<r>.json``. The ranks train apart (no
    gradient sync), as the JAX package's ranks do. On the port the loop
    also reads ``eval`` through the mesh route (a ``dp`` mesh over the
    gang's gloo group) and probes a block task's worker."""
    import json

    pkg = config["pkg"]
    train = importlib.import_module(pkg + ".train")
    shard = train.get_dataset_shard("train")
    if pkg == "ray_tpu":
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu.models import GPT2, GPT2Config
        from ray_tpu.models.gpt2 import gpt2_loss_fn

        model = GPT2(GPT2Config.tiny(dtype=jnp.float32))
        params = jax.tree_util.tree_map(jnp.asarray, config["params"])
        opt = optax.adamw(config["lr"], weight_decay=config["wd"],
                          mu_dtype=jnp.bfloat16)
        state = train.init_train_state(params, opt)
        step = train.make_train_step(gpt2_loss_fn(model, ce_chunk=64), opt)
        batches = shard.iter_device_batches(LM_BATCH)
    else:
        import torch

        from ray_tpu_torch.models import GPT2, GPT2Config
        from ray_tpu_torch.models.gpt2 import gpt2_loss_fn

        torch.set_num_threads(1)
        model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
        model.load_jax_params(config["params"])
        opt = train.adamw(config["lr"], weight_decay=config["wd"],
                          mu_dtype=torch.bfloat16)
        state = train.init_train_state(model, opt)
        step = train.make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
        batches = shard.iter_device_batches(LM_BATCH, device="cpu")
    out = {"losses": [], "sums": []}
    for batch in batches:
        out["sums"].append(_checksums(batch))
        state, m = step(state, batch)
        out["losses"].append(float(m["loss"]))
        train.report({"loss": out["losses"][-1]})
    out["eval"] = [_checksums(b) for b in train.get_dataset_shard(
        "eval").iter_batches(LM_BATCH)]
    if pkg == "ray_tpu_torch":
        from ray_tpu_torch import data
        from ray_tpu_torch.parallel import make_mesh
        mesh = make_mesh({"dp": -1}, device="cpu")
        halves = list(train.get_dataset_shard("eval").iter_device_batches(
            LM_BATCH, mesh=mesh))
        out["halves"] = [_checksums(b) for b in halves]
        out["half_types"] = sorted({f"{type(v).__name__}:{v.device}:"
                                    f"{tuple(v.shape)}"
                                    for b in halves for v in b.values()})
        probe = data.range(2).map_batches(block_worker_view).take_all()
        out["probe"] = {k: str(v) for k, v in probe[0].items()}
        out["loop_pid"] = os.getpid()
    rank = train.get_context().world_rank
    with open(os.path.join(config["out"], f"{pkg}_rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
