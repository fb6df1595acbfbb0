"""Blocks: the unit of data movement.

Counterpart of ``ray_tpu/data/block.py``, whose blocks are pyarrow
Tables. The port's block is columnar numpy: an ordered dict of
equal-length columns and a row count, with the few Table methods the
executor calls (``num_rows``, ``num_columns``, ``column_names``,
``column``, ``schema``, ``slice``, ``nbytes``). Nothing here imports
pyarrow, pandas or torch, so a block task's worker loads numpy only.

Columns hold what the JAX package's blocks give back through
``block_to_batch``, so a user function sees the same batches on both:

- numbers and bools are 1-d arrays of their dtype;
- N-d tensor columns are N-d arrays (the JAX package nests them as
  FixedSizeList);
- strings, bytes, ragged rows and anything else arrow holds as a
  nested or variable-width type are ``dtype=object`` arrays, one Python
  object a row (a list row becomes a numpy array, as arrow's list
  columns come back);
- a zero-row block keeps its column names and dtypes.

pyarrow and pandas appear only at the edges (``to_arrow``,
``to_pandas``, and ``to_block`` of a Table or a DataFrame), each
importing its package when called.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np


class Schema:
    """Column names and numpy dtypes of a block (the counterpart of
    ``pyarrow.Schema`` for ``Dataset.schema()``)."""

    def __init__(self, names: list[str], types: list[np.dtype]):
        self.names = list(names)
        self.types = list(types)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schema) and self.names == other.names
                and self.types == other.types)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {t}" for n, t in zip(self.names,
                                                      self.types))
        return f"Schema({cols})"


class Block:
    """Equal-length numpy columns in insertion order."""

    __slots__ = ("_cols", "num_rows")

    def __init__(self, cols: dict[str, np.ndarray],
                 num_rows: int | None = None):
        lengths = {len(v) for v in cols.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"columns of one block differ in length: "
                f"{ {k: len(v) for k, v in cols.items()} }")
        self._cols = dict(cols)
        self.num_rows = (lengths.pop() if lengths
                         else int(num_rows or 0))

    @property
    def column_names(self) -> list[str]:
        return list(self._cols)

    @property
    def num_columns(self) -> int:
        return len(self._cols)

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]

    @property
    def schema(self) -> Schema:
        return Schema(list(self._cols),
                      [v.dtype for v in self._cols.values()])

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self._cols.values())

    def slice(self, offset: int, length: int) -> "Block":
        """Rows [offset, offset + length), as views."""
        end = min(self.num_rows, offset + length)
        return Block({k: v[offset:end] for k, v in self._cols.items()},
                     max(0, end - offset))

    def to_arrow(self):
        """This block as a ``pyarrow.Table`` (N-d columns nested as
        FixedSizeList, as the JAX package's blocks hold them)."""
        pa = _require("pyarrow", "a pyarrow batch or table")
        return pa.table({k: _to_arrow_array(pa, v)
                         for k, v in self._cols.items()})

    def to_pandas(self):
        """This block as a ``pandas.DataFrame`` (an N-d column becomes
        an object column of row arrays)."""
        pd = _require("pandas", "a pandas batch or DataFrame")
        return pd.DataFrame({k: (list(v) if v.ndim > 1 else v)
                             for k, v in self._cols.items()})

    def __repr__(self) -> str:
        return f"Block({self.num_rows} rows, {self.schema})"


def _require(package: str, what: str):
    """Import ``package`` for ``what``; ImportError naming it when it
    is missing (nothing falls back)."""
    import importlib
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"{what} needs {package}, which is not installed") from e


# -- building blocks -------------------------------------------------------


def to_block(rows_or_batch) -> Block:
    if isinstance(rows_or_batch, Block):
        return rows_or_batch
    kind = _foreign_kind(rows_or_batch)
    if kind == "arrow":
        return _from_arrow(rows_or_batch)
    if kind == "pandas":
        return to_block({c: rows_or_batch[c].to_numpy()
                         for c in rows_or_batch.columns})
    if isinstance(rows_or_batch, dict):
        return Block({k: _to_column(v) for k, v in rows_or_batch.items()})
    if isinstance(rows_or_batch, list):
        if not rows_or_batch:
            return Block({})
        if isinstance(rows_or_batch[0], dict):
            cols = {k: [r[k] for r in rows_or_batch]
                    for k in rows_or_batch[0]}
            return Block({k: _to_column(v) for k, v in cols.items()})
        return Block({"item": _to_column(rows_or_batch)})
    raise TypeError(f"cannot make a block from {type(rows_or_batch)}")


def _foreign_kind(obj) -> str | None:
    """"arrow" for a pyarrow Table, "pandas" for a pandas DataFrame,
    by the defining module alone (neither package is imported here; a
    polars or cuDF "DataFrame" falls to the TypeError of to_block)."""
    cls = type(obj)
    top = cls.__module__.partition(".")[0]
    if top == "pyarrow" and cls.__name__ == "Table":
        return "arrow"
    if top == "pandas" and cls.__name__ == "DataFrame":
        return "pandas"
    return None


def _to_column(v) -> np.ndarray:
    """One column as its batch array: what the JAX package's
    numpy -> arrow -> numpy round trip gives back."""
    # bytes must not round-trip through numpy: np.asarray gives an |S
    # dtype that silently truncates trailing NULs.
    if isinstance(v, (list, tuple)) and v and \
            isinstance(v[0], (bytes, bytearray)):
        return _objects([bytes(x) for x in v])
    if isinstance(v, np.ndarray) and v.dtype == object:
        arr = v
    else:
        arr = np.asarray(v)
    if arr.dtype.kind == "S":
        return _objects([bytes(x) for x in v])
    if arr.dtype.kind == "U":
        return _objects(arr.tolist())
    if arr.dtype == object:
        if arr.ndim > 1:
            arr = _objects(list(arr))
        return _infer_objects(arr)
    return arr


def _objects(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, x in enumerate(values):
        out[i] = x
    return out


def _infer_objects(arr: np.ndarray) -> np.ndarray:
    """A 1-d object column typed as arrow types ``arr.tolist()``:
    Python bools, ints and floats become bool, int64 and float64 (an
    int column with a None becomes float64 with NaN, as arrow's nulls
    come back); list rows become arrays; strings, bytes and anything
    else stay objects."""
    vals = arr.tolist()
    present = [x for x in vals if x is not None]
    if not present:
        return arr
    missing = len(present) < len(vals)
    if all(isinstance(x, (bool, np.bool_)) for x in present):
        return arr if missing else np.asarray(vals, dtype=bool)
    if all(isinstance(x, (int, np.integer))
           and not isinstance(x, (bool, np.bool_)) for x in present):
        if missing:
            return np.asarray([np.nan if x is None else float(x)
                               for x in vals])
        return np.asarray(vals, dtype=np.int64)
    if all(isinstance(x, (int, float, np.integer, np.floating))
           and not isinstance(x, (bool, np.bool_)) for x in present):
        return np.asarray([np.nan if x is None else float(x)
                           for x in vals])
    if all(isinstance(x, (list, tuple, np.ndarray)) for x in present):
        return _objects([None if x is None else _to_column(list(x))
                         for x in arr])
    return arr


def block_to_batch(block: Block) -> dict[str, np.ndarray]:
    """Block -> dict of numpy. The arrays are read-only views, as the
    JAX package's zero-copy arrow columns are: a function that writes
    into its batch fails on both packages alike."""
    out = {}
    for name in block.column_names:
        v = block.column(name).view()
        v.flags.writeable = False
        out[name] = v
    return out


def block_num_rows(block) -> int:
    return block.num_rows


def block_rows(block) -> Iterable[dict[str, Any]]:
    batch = block_to_batch(block)
    keys = list(batch)
    for i in range(block.num_rows):
        yield {k: batch[k][i] for k in keys}


def concat_blocks(blocks: list) -> Block:
    blocks = [b for b in blocks if b.num_rows > 0] or blocks[:1]
    if not blocks:
        return Block({})
    if len(blocks) == 1:
        return blocks[0]
    schema = blocks[0].schema
    for b in blocks[1:]:
        if b.schema != schema:
            # pyarrow.concat_tables refuses the same way.
            raise ValueError(f"cannot concatenate blocks of schemas "
                             f"{schema} and {b.schema}")
    return Block({k: np.concatenate([b.column(k) for b in blocks])
                  for k in schema.names})


def slice_block(block, start: int, end: int) -> Block:
    return block.slice(start, end - start)


# -- the arrow edge --------------------------------------------------------


def _to_arrow_array(pa, arr: np.ndarray):
    if arr.dtype == object:
        vals = [x.tolist() if isinstance(x, np.ndarray) else x
                for x in arr]
        return pa.array(vals)
    if arr.ndim <= 1:
        return pa.array(arr)
    # N-d columns -> FixedSizeList nesting (tensors per row). Explicit
    # trailing size: reshape(0, -1) on an empty block is a ValueError.
    trailing = int(np.prod(arr.shape[1:]))
    inner = pa.array(np.ascontiguousarray(arr).reshape(
        len(arr), trailing).ravel())
    for dim in reversed(arr.shape[1:]):
        inner = pa.FixedSizeListArray.from_arrays(inner, dim)
    return inner


def _from_arrow(table) -> Block:
    import pyarrow as pa
    return Block({name: _to_column(_arrow_column_to_numpy(
        pa, table.column(name))) for name in table.column_names},
        table.num_rows)


def _arrow_column_to_numpy(pa, col) -> np.ndarray:
    typ = col.type
    dims = []
    while pa.types.is_fixed_size_list(typ):
        dims.append(typ.list_size)
        typ = typ.value_type
    arr = col.combine_chunks()
    if dims:
        flat = arr.flatten()
        for _ in range(len(dims) - 1):
            flat = flat.flatten()
        np_flat = flat.to_numpy(zero_copy_only=False)
        return np_flat.reshape((len(col), *dims))
    return arr.to_numpy(zero_copy_only=False)
