"""Datasources (reference: python/ray/data/_internal/datasource/).

Each source materializes as N read tasks (callables returning one block
each) so reads execute distributed and stream through the executor.

Counterpart of ``ray_tpu/data/io.py``. The file sources of pyarrow
(``read_parquet``, ``read_csv``, ``read_json``) import it when called
and raise ImportError naming it where it is missing; they, and
``from_pandas``, ``from_arrow`` and their ``*_refs`` forms, hand the
executor the port's numpy blocks.
"""

from __future__ import annotations

import builtins
import glob as globlib
from typing import Any, Iterable

import numpy as np

from ray_tpu_torch.data.block import _require, to_block
from ray_tpu_torch.data.dataset import Dataset, _Source


def _default_parallelism(parallelism):
    if parallelism is not None:
        return parallelism
    from ray_tpu_torch.data.context import DataContext
    return DataContext.get_current().default_parallelism


def range(n: int, *, parallelism: int | None = None) -> Dataset:
    parallelism = _default_parallelism(parallelism)
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    fns = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min(n, (i + 1) * per)
        if lo >= hi:
            break
        fns.append(lambda lo=lo, hi=hi: to_block(
            {"id": np.arange(lo, hi)}))
    return Dataset([_Source(fns)])


def from_items(items: list, *, parallelism: int | None = None
               ) -> Dataset:
    items = list(items)
    parallelism = _default_parallelism(parallelism)
    parallelism = max(1, min(parallelism, len(items) or 1))
    per = (len(items) + parallelism - 1) // parallelism
    fns = []
    for i in builtins.range(parallelism):
        chunk = items[i * per:(i + 1) * per]
        if not chunk:
            break
        fns.append(lambda c=chunk: to_block(
            c if isinstance(c[0], dict) else [{"item": x} for x in c]))
    return Dataset([_Source(fns)])


def from_numpy(arrays: dict[str, np.ndarray] | np.ndarray,
               *, parallelism: int | None = None) -> Dataset:
    if not isinstance(arrays, dict):
        arrays = {"data": arrays}
    n = len(next(iter(arrays.values())))
    parallelism = _default_parallelism(parallelism)
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    fns = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min(n, (i + 1) * per)
        if lo >= hi:
            break
        chunk = {k: v[lo:hi] for k, v in arrays.items()}
        fns.append(lambda c=chunk: to_block(c))
    return Dataset([_Source(fns)])


def from_pandas(df, *, parallelism: int | None = None) -> Dataset:
    cols = {c: df[c].to_numpy() for c in df.columns}
    if type(df.index).__name__ != "RangeIndex":
        # pyarrow's Table.from_pandas keeps any other index as a column.
        cols[df.index.name or "__index_level_0__"] = df.index.to_numpy()
    table = to_block(cols)
    n = table.num_rows
    parallelism = _default_parallelism(parallelism)
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    fns = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min(n, (i + 1) * per)
        if lo >= hi:
            break
        chunk = table.slice(lo, hi - lo)
        fns.append(lambda c=chunk: c)
    return Dataset([_Source(fns)])


def _expand(paths: str | list[str], suffix: str) -> list[str]:
    import os
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(globlib.glob(f"{p}/**/*{suffix}",
                                           recursive=True)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths}")
    return out


def read_parquet(paths: str | list[str]) -> Dataset:
    _require("pyarrow.parquet", "read_parquet")
    files = _expand(paths, ".parquet")

    def make(f):
        def read():
            import pyarrow.parquet as pq
            return to_block(pq.read_table(f))
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_csv(paths: str | list[str]) -> Dataset:
    _require("pyarrow.csv", "read_csv")
    files = _expand(paths, ".csv")

    def make(f):
        def read():
            import pyarrow.csv as pacsv
            return to_block(pacsv.read_csv(f))
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_json(paths: str | list[str]) -> Dataset:
    _require("pyarrow.json", "read_json")
    files = _expand(paths, ".json")

    def make(f):
        def read():
            import pyarrow.json as pajson
            return to_block(pajson.read_json(f))
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_images(paths: str | list[str], *, size: tuple | None = None,
                mode: str = "RGB") -> Dataset:
    """Image files → blocks with an ``image`` tensor column and a
    ``path`` column (reference: _internal/datasource/image_datasource).
    One read task per file keeps decode distributed across CPU
    workers."""
    files: list[str] = []
    for suffix in (".png", ".jpg", ".jpeg", ".bmp", ".gif"):
        try:
            files.extend(_expand(paths, suffix))
        except FileNotFoundError:
            pass
    files = sorted(set(files))
    if not files:
        raise FileNotFoundError(f"no image files match {paths}")

    def make(f):
        def read():
            from PIL import Image
            img = Image.open(f).convert(mode)
            if size is not None:
                img = img.resize(size)
            arr = np.asarray(img)
            return to_block({"image": arr[None], "path": [f]})
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_binary_files(paths: str | list[str],
                      include_paths: bool = True) -> Dataset:
    files = _expand(paths, "")

    def make(f):
        def read():
            with open(f, "rb") as fh:
                data = fh.read()
            row = {"bytes": [data]}
            if include_paths:
                row["path"] = [f]
            return to_block(row)
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_text(paths: str | list[str],
              drop_empty_lines: bool = True) -> Dataset:
    """One row per line, column "text" (reference:
    ray.data.read_text)."""
    files = _expand(paths, ".txt")

    def make(f):
        def read():
            with open(f) as fh:
                lines = [ln.rstrip("\n") for ln in fh]
            if drop_empty_lines:
                lines = [ln for ln in lines if ln.strip()]
            return to_block({"text": np.asarray(lines, dtype=object)})
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_numpy(paths: str | list[str],
               column: str = "data") -> Dataset:
    """.npy (one array -> one column) or .npz (one column per key)
    files, one block per file (reference: ray.data.read_numpy)."""
    try:
        files = _expand(paths, ".npy")
    except FileNotFoundError:
        files = []
    try:
        npz = [f for f in _expand(paths, ".npz")
               if f.endswith(".npz") and f not in files]
    except FileNotFoundError:
        npz = []
    files = sorted(files + npz)
    if not files:
        raise FileNotFoundError(f"no .npy/.npz files match {paths}")

    def make(f):
        def read():
            loaded = np.load(f, allow_pickle=False)
            if isinstance(loaded, np.lib.npyio.NpzFile):
                return to_block({k: loaded[k] for k in loaded.files})
            return to_block({column: loaded})
        return read

    return Dataset([_Source([make(f) for f in files])])


def from_arrow(tables: list) -> Dataset:
    """Dataset over existing pyarrow Tables (reference:
    ray.data.from_arrow), each converted to a block here, once."""
    if not isinstance(tables, list):
        tables = [tables]
    blocks = [to_block(t) for t in tables]
    return Dataset([_Source([(lambda b=b: b) for b in blocks])])


def read_tfrecords(paths: str | list[str], *,
                   raw_bytes: bool = False,
                   verify_crc: bool = False) -> Dataset:
    """TFRecord files of tf.train.Example protos -> one block per
    file, one column per feature (reference:
    _internal/datasource/tfrecords_datasource.py — re-based: TF isn't
    a dependency, so framing + the Example wire format are decoded by
    ray_tpu_torch.data.tfrecord directly). ``raw_bytes=True`` skips Example
    parsing and yields a single "bytes" column."""
    files = _expand(paths, ".tfrecord")

    def make(f):
        def read():
            from ray_tpu_torch.data.tfrecord import parse_example, read_records
            if raw_bytes:
                recs = list(read_records(f, verify=verify_crc))
                return to_block({"bytes": np.asarray(recs,
                                                     dtype=object)})
            cols: dict[str, list] = {}
            n = 0
            for rec in read_records(f, verify=verify_crc):
                row = parse_example(rec)
                for k, vals in row.items():
                    cols.setdefault(k, [None] * n).append(list(vals))
                n += 1
                for k in cols:
                    if len(cols[k]) < n:
                        cols[k].append(None)

            def col_array(v: list) -> np.ndarray:
                # Scalar column only when EVERY row has exactly one
                # value; a column with any multi-value (ragged) row
                # keeps per-row lists in a dtype=object array —
                # np.asarray on mixed scalars/lists raises
                # "inhomogeneous shape".
                if all(x is None or len(x) == 1 for x in v):
                    scalars = [x[0] if x else None for x in v]
                    if any(x is None for x in scalars) or \
                            isinstance(scalars[0], bytes):
                        arr = np.empty(len(scalars), dtype=object)
                        for i, x in enumerate(scalars):
                            arr[i] = x
                        return arr
                    return np.asarray(scalars)
                arr = np.empty(len(v), dtype=object)
                for i, x in enumerate(v):
                    arr[i] = x
                return arr

            return to_block({k: col_array(v) for k, v in cols.items()})
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_webdataset(paths: str | list[str], *,
                    suffixes: list[str] | None = None) -> Dataset:
    """WebDataset tar shards -> one block per shard (reference:
    ray.data.read_webdataset — re-based on stdlib tarfile: samples
    are consecutive tar members sharing a basename key, one column
    per extension, values raw bytes except ``.cls``/``.id``/
    ``.index`` (int) and ``.json`` (parsed). ``suffixes`` filters the
    loaded extensions."""
    files = _expand(paths, ".tar")

    def make(f):
        def read():
            import json as _json
            import os
            import tarfile

            want = set(s.lstrip(".") for s in suffixes) \
                if suffixes else None
            rows: list[dict] = []
            cur_key: str | None = None
            cur: dict = {}
            with tarfile.open(f) as tf:
                for m in tf:
                    if not m.isfile():
                        continue
                    # Key = full path up to the first dot AFTER the
                    # last slash (webdataset convention): samples in
                    # different subdirectories sharing a basename
                    # must NOT collide.
                    base = os.path.basename(m.name)
                    if "." not in base:
                        continue
                    stem, ext = base.split(".", 1)
                    dirname = os.path.dirname(m.name)
                    key = (f"{dirname}/{stem}" if dirname else stem)
                    if want is not None and ext not in want:
                        continue
                    if key != cur_key and cur:
                        rows.append(cur)
                        cur = {}
                    cur_key = key
                    data = tf.extractfile(m).read()
                    if ext in ("cls", "id", "index"):
                        cur[ext] = int(data)
                    elif ext == "json":
                        cur[ext] = _json.loads(data)
                    else:
                        cur[ext] = data
                    cur["__key__"] = key
            if cur:
                rows.append(cur)
            cols: dict[str, list] = {}
            for i, row in enumerate(rows):
                for k, v in row.items():
                    cols.setdefault(k, [None] * i).append(v)
                for k in cols:
                    if len(cols[k]) < i + 1:
                        cols[k].append(None)

            def arr(v):
                if all(isinstance(x, int) for x in v):
                    return np.asarray(v)
                out = np.empty(len(v), dtype=object)
                for i, x in enumerate(v):
                    out[i] = x
                return out

            return to_block({k: arr(v) for k, v in cols.items()})
        return read

    return Dataset([_Source([make(f) for f in files])])


def read_sql(sql: str | list[str], connection_factory, *,
             columns: list[str] | None = None) -> Dataset:
    """DB-API 2.0 datasource (reference: ray.data.read_sql). One read
    task per query: pass a LIST of shard queries (e.g. partitioned by
    key range) to read in parallel — arbitrary single statements
    cannot be split safely, matching the reference's sharding
    contract. ``connection_factory`` must be picklable (executes in
    workers)."""
    queries = [sql] if isinstance(sql, str) else list(sql)

    def make(q):
        def read():
            conn = connection_factory()
            try:
                cur = conn.cursor()
                cur.execute(q)
                names = columns or [d[0] for d in cur.description]
                rows = cur.fetchall()
            finally:
                conn.close()
            cols = {name: [r[i] for r in rows]
                    for i, name in enumerate(names)}
            return to_block({k: np.asarray(v) for k, v in cols.items()})
        return read

    return Dataset([_Source([make(q) for q in queries])])


class _BigQueryRest:
    """Minimal BigQuery REST v2 transport (urllib). Injectable: tests
    and air-gapped environments pass their own ``transport`` callable
    to read_bigquery with the same (method, url, params, body) -> dict
    shape. Auth: bearer token from $BIGQUERY_TOKEN (the full oauth
    dance is out of scope — the reference delegates it to
    google-cloud-bigquery's credential machinery)."""

    BASE = "https://bigquery.googleapis.com/bigquery/v2"

    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout

    def __call__(self, method: str, url: str, params: dict | None = None,
                 body: dict | None = None) -> dict:
        import json as _json
        import os as _os
        import urllib.parse
        import urllib.request
        if params:
            url = url + "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, method=method)
        tok = _os.environ.get("BIGQUERY_TOKEN")
        if tok:
            req.add_header("Authorization", f"Bearer {tok}")
        data = None
        if body is not None:
            data = _json.dumps(body).encode()
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, data,
                                    timeout=self.timeout) as resp:
            return _json.loads(resp.read())


def _bq_convert_columns(schema_fields: list, rows: list) -> dict:
    """BigQuery JSON wire rows ({"f": [{"v": ...}, ...]}) -> typed
    numpy columns, per the schema's field types."""
    names = [f["name"] for f in schema_fields]
    types = [f.get("type", "STRING") for f in schema_fields]
    cols: dict[str, list] = {n: [] for n in names}
    for r in rows:
        for (n, cell) in zip(names, r.get("f", [])):
            cols[n].append(cell.get("v"))

    def conv(vals, t):
        # NULL cells arrive as {"v": null}. Int columns with NULLs fall
        # back to float64/NaN (numpy int64 has no missing value — same
        # promotion arrow->pandas does); bool/string NULLs stay None in
        # an object column.
        has_null = any(v is None for v in vals)
        if t in ("INTEGER", "INT64"):
            if has_null:
                return np.asarray(
                    [np.nan if v is None else float(v) for v in vals],
                    dtype=np.float64)
            return np.asarray([int(v) for v in vals], dtype=np.int64)
        if t in ("FLOAT", "FLOAT64", "NUMERIC", "BIGNUMERIC"):
            return np.asarray(
                [np.nan if v is None else float(v) for v in vals],
                dtype=np.float64)
        if t in ("BOOLEAN", "BOOL"):
            if has_null:
                return np.asarray(
                    [None if v is None else v in (True, "true", "TRUE")
                     for v in vals], dtype=object)
            return np.asarray([v in (True, "true", "TRUE") for v in vals])
        return np.asarray(vals, dtype=object)

    return {n: conv(cols[n], t) for n, t in zip(names, types)}


def read_bigquery(project_id: str, *, dataset: str | None = None,
                  query: str | None = None,
                  parallelism: int | None = None,
                  transport=None) -> Dataset:
    """BigQuery datasource (reference: ray.data.read_bigquery /
    python/ray/data/_internal/datasource/bigquery_datasource.py).

    Exactly one of ``dataset`` ("dataset_id.table_id" — read via
    tabledata.list, row-range sharded into ``parallelism`` read tasks)
    or ``query`` (one jobs.query read task; arbitrary SQL cannot be
    split safely, same contract as the reference) must be given.

    The reference rides the google-cloud-bigquery client; this image
    has no cloud SDK and no egress, so the REST surface is spoken
    directly through an injectable ``transport`` (must be picklable —
    read tasks execute in workers). Default transport: urllib +
    $BIGQUERY_TOKEN bearer auth.
    """
    if (dataset is None) == (query is None):
        raise ValueError(
            "read_bigquery: pass exactly one of dataset= or query=")
    t = transport if transport is not None else _BigQueryRest()
    base = _BigQueryRest.BASE

    if query is not None:
        def run_query(q=query):
            import time as _time
            out = t("POST", f"{base}/projects/{project_id}/queries",
                    None, {"query": q, "useLegacySql": False})
            job_id = out.get("jobReference", {}).get("jobId")
            # A slow query returns jobComplete=false with no schema/rows
            # yet — poll getQueryResults until it completes.
            while out.get("jobComplete") is False:
                _time.sleep(0.5)
                out = t("GET",
                        f"{base}/projects/{project_id}/queries/{job_id}",
                        None, None)
            fields = out["schema"]["fields"]
            rows = list(out.get("rows", []))
            while out.get("pageToken"):
                out = t("GET",
                        f"{base}/projects/{project_id}/queries/{job_id}",
                        {"pageToken": out["pageToken"]}, None)
                rows.extend(out.get("rows", []))
            return to_block(_bq_convert_columns(fields, rows))

        return Dataset([_Source([run_query])])

    try:
        ds_id, table_id = dataset.split(".", 1)
    except ValueError:
        raise ValueError(
            f"dataset must be 'dataset_id.table_id', got {dataset!r}"
        ) from None
    tbl_url = (f"{base}/projects/{project_id}/datasets/{ds_id}"
               f"/tables/{table_id}")
    meta = t("GET", tbl_url, None, None)
    fields = meta["schema"]["fields"]
    n_rows = int(meta.get("numRows", 0))
    parallelism = max(1, min(_default_parallelism(parallelism),
                             n_rows or 1))
    per = (n_rows + parallelism - 1) // parallelism

    def make(lo: int, count: int):
        def read():
            got, rows = 0, []
            while got < count:
                out = t("GET", f"{tbl_url}/data",
                        {"startIndex": lo + got,
                         "maxResults": count - got}, None)
                page = out.get("rows", [])
                if not page:
                    break
                rows.extend(page)
                got += len(page)
            return to_block(_bq_convert_columns(fields, rows))
        return read

    fns = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min(n_rows, (i + 1) * per)
        if lo >= hi:
            break
        fns.append(make(lo, hi - lo))
    return Dataset([_Source(fns or [lambda: to_block(
        _bq_convert_columns(fields, []))])])


def from_huggingface(hf_dataset, *,
                     parallelism: int | None = None) -> Dataset:
    """A (map-style) huggingface ``datasets.Dataset`` -> Dataset
    (reference: ray.data.from_huggingface). The arrow shards convert
    zero-copy; parallelism slices the table row-wise."""
    if getattr(hf_dataset, "_indices", None) is not None:
        # select()/shuffle()/filter() record an indices mapping over
        # an unchanged arrow table — reading .data directly would
        # silently yield the wrong rows.
        hf_dataset = hf_dataset.flatten_indices()
    try:
        table = hf_dataset.data.table     # pyarrow.Table
    except AttributeError as e:
        raise TypeError(
            "from_huggingface expects a datasets.Dataset (map-style); "
            f"got {type(hf_dataset).__name__}") from e
    parallelism = _default_parallelism(parallelism)
    n = table.num_rows
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    fns = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min(n, (i + 1) * per)
        if lo >= hi:
            break
        # Slice EAGERLY so each read closure captures only its shard;
        # a closure over (table, lo, hi) would ship the entire table
        # to every read task.
        shard = to_block(table.slice(lo, hi - lo))
        fns.append(lambda s=shard: s)
    return Dataset([_Source(fns)])


# -- refs constructors + pluggable datasource seam -----------------------


def from_numpy_refs(refs: list, *, column: str = "data") -> Dataset:
    """Dataset over already-stored numpy arrays, one block per ref —
    ZERO data movement at construction (reference:
    ray.data.from_numpy_refs): the read task gets() its ref inside
    the executing worker."""
    import ray_tpu_torch

    def load(ref):
        arr = ray_tpu_torch.get(ref)
        return to_block(arr if isinstance(arr, dict)
                        else {column: np.asarray(arr)})

    return Dataset([_Source([
        (lambda r=r: load(r)) for r in refs])])


def from_pandas_refs(refs: list) -> Dataset:
    """(reference: ray.data.from_pandas_refs)"""
    import ray_tpu_torch

    def load(ref):
        return to_block(ray_tpu_torch.get(ref))

    return Dataset([_Source([
        (lambda r=r: load(r)) for r in refs])])


def from_arrow_refs(refs: list) -> Dataset:
    """(reference: ray.data.from_arrow_refs)"""
    import ray_tpu_torch

    return Dataset([_Source([
        (lambda r=r: to_block(ray_tpu_torch.get(r))) for r in refs])])


def range_tensor(n: int, *, shape: tuple = (1,),
                 parallelism: int | None = None) -> Dataset:
    """n rows of a "data" tensor column: row i is a full(shape, i)
    (reference: ray.data.range_tensor)."""
    parallelism = _default_parallelism(parallelism)
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    fns = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min(n, (i + 1) * per)
        if lo >= hi:
            break

        def make(lo=lo, hi=hi):
            ids = np.arange(lo, hi)
            # One materialization: _to_arrow_array's ndim>1 path
            # turns the ndarray into a FixedSizeList column directly
            # (a list() of per-row views would re-materialize twice).
            data = np.broadcast_to(
                ids.reshape((-1,) + (1,) * len(shape)),
                (hi - lo,) + tuple(shape))
            return to_block({"id": ids, "data": data})

        fns.append(make)
    return Dataset([_Source(fns)])


def read_parquet_bulk(paths: str | list[str]) -> Dataset:
    """Compat alias (reference: ray.data.read_parquet_bulk — its
    distinction from read_parquet is skipping a footer/metadata
    prefetch pass; this repo's read_parquet never had one, so the
    two are identical here)."""
    return read_parquet(paths)


class ReadTask:
    """One unit of a custom datasource read: a zero-arg callable
    returning a block-convertible value (reference:
    ray.data.ReadTask, the datasource.py seam)."""

    def __init__(self, read_fn):
        if not callable(read_fn):
            raise TypeError("ReadTask needs a zero-arg callable")
        self._fn = read_fn

    def __call__(self):
        return to_block(self._fn())


class Datasource:
    """Pluggable datasource ABC (reference: ray.data.Datasource):
    implement get_read_tasks(parallelism) -> list[ReadTask] and pass
    to read_datasource. Every in-repo reader is expressible this way
    (the internal _Source carries exactly a list of read
    callables)."""

    def get_read_tasks(self, parallelism: int) -> list:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> int | None:
        return None


def from_torch(torch_dataset, *,
               column: str = "item") -> Dataset:
    """A (map-style or iterable) torch dataset -> Dataset (reference:
    ray.data.from_torch). Items land in one ``item`` column (tensors
    convert to numpy); the torch dataset is materialized at
    construction, matching the reference's behavior."""
    rows = []
    for item in torch_dataset:
        if hasattr(item, "numpy"):
            item = item.numpy()
        rows.append({column: item})
    return from_items(rows)


def from_tf(tf_dataset) -> Dataset:
    """A ``tf.data.Dataset`` -> Dataset (reference:
    ray.data.from_tf — the tf dataset is fully materialized; element
    dicts become columns, bare tensors an ``item`` column)."""
    rows = []
    for elem in tf_dataset.as_numpy_iterator():
        if isinstance(elem, dict):
            rows.append(elem)
        elif isinstance(elem, tuple):
            rows.append({f"item_{i}": v for i, v in enumerate(elem)})
        else:
            rows.append({"item": elem})
    return from_items(rows)


def from_dask(df) -> Dataset:
    """(reference: ray.data.from_dask) Requires dask."""
    try:
        import dask.dataframe as dd  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "from_dask requires dask, which is not installed in this "
            "environment") from e
    return from_pandas(df.compute())


def from_modin(df) -> Dataset:
    """(reference: ray.data.from_modin) Requires modin."""
    if not hasattr(df, "_to_pandas"):
        raise TypeError(
            f"from_modin expects a modin DataFrame, got "
            f"{type(df).__name__}")
    return from_pandas(df._to_pandas())


def from_spark(df) -> Dataset:
    """(reference: ray.data.from_spark) Requires pyspark."""
    if not hasattr(df, "toPandas"):
        raise TypeError(
            f"from_spark expects a pyspark DataFrame, got "
            f"{type(df).__name__}")
    return from_pandas(df.toPandas())


class Datasink:
    """Pluggable write sink ABC (reference: ray.data.Datasink):
    override ``write(block)``; lifecycle hooks are optional. Drive
    with ``Dataset.write_datasink``."""

    def on_write_start(self) -> None:
        pass

    def write(self, block) -> None:
        raise NotImplementedError

    def on_write_complete(self) -> None:
        pass

    def on_write_failed(self, error: BaseException) -> None:
        pass


class BlockBasedFileDatasink(Datasink):
    """File-per-block sink base (reference:
    ray.data.BlockBasedFileDatasink): subclass and implement
    ``write_block_to_file(block, file)`` (binary file object)."""

    def __init__(self, path: str, *, file_format: str = "bin"):
        import os
        self.path = path
        self.file_format = file_format
        self._index = 0
        os.makedirs(path, exist_ok=True)

    def write_block_to_file(self, block, file) -> None:
        raise NotImplementedError

    def write(self, block) -> None:
        import os
        out = os.path.join(
            self.path,
            f"part-{self._index:05d}.{self.file_format}")
        self._index += 1
        with open(out, "wb") as f:
            self.write_block_to_file(block, f)


class RowBasedFileDatasink(Datasink):
    """File-per-row sink base (reference:
    ray.data.RowBasedFileDatasink): subclass and implement
    ``write_row_to_file(row, file)``."""

    def __init__(self, path: str, *, file_format: str = "bin"):
        import os
        self.path = path
        self.file_format = file_format
        self._index = 0
        os.makedirs(path, exist_ok=True)

    def write_row_to_file(self, row: dict, file) -> None:
        raise NotImplementedError

    def write(self, block) -> None:
        import os

        from ray_tpu_torch.data.block import block_rows
        for row in block_rows(block):
            out = os.path.join(
                self.path,
                f"row-{self._index:06d}.{self.file_format}")
            self._index += 1
            with open(out, "wb") as f:
                self.write_row_to_file(row, f)


def read_datasource(datasource: Datasource, *,
                    parallelism: int | None = None) -> Dataset:
    """(reference: ray.data.read_datasource)"""
    parallelism = _default_parallelism(parallelism)
    tasks = datasource.get_read_tasks(parallelism)
    if not tasks:
        raise ValueError(
            f"{type(datasource).__name__}.get_read_tasks returned "
            f"no tasks")
    return Dataset([_Source([
        t if isinstance(t, ReadTask) else ReadTask(t)
        for t in tasks])])
