"""Preprocessors (reference: python/ray/data/preprocessor.py +
python/ray/data/preprocessors/): fit statistics on a Dataset once,
apply the transform to any Dataset (train AND serve time — the object
pickles into checkpoints).
"""

from __future__ import annotations

import numpy as np


class Preprocessor:
    """Fit/transform ABC (reference: ray.data.preprocessor
    .Preprocessor). Subclasses implement ``_fit(ds)`` (record stats on
    self) and ``_transform_batch(batch) -> batch``."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted and type(self)._fit is not Preprocessor._fit:
            raise RuntimeError(
                f"{type(self).__name__} must be fit() before "
                f"transform()")
        return ds.map_batches(self._transform_batch)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: dict) -> dict:
        """Apply to one in-memory batch (serve-time path)."""
        return self._transform_batch(
            {k: np.asarray(v) for k, v in batch.items()})

    # -- override points --

    def _fit(self, ds) -> None:
        pass

    def _transform_batch(self, batch: dict) -> dict:
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """Zero-mean/unit-variance per column (reference:
    ray.data.preprocessors.StandardScaler)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        from ray_tpu_torch.data.aggregate import Mean, Std
        aggs = []
        for c in self.columns:
            aggs += [Mean(c), Std(c, ddof=0)]
        out = ds.aggregate(*aggs)
        self.stats_ = {
            c: (out[f"mean({c})"], out[f"std({c})"] or 1.0)
            for c in self.columns}

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            out[c] = (np.asarray(batch[c], dtype=np.float64)
                      - mean) / (std if std else 1.0)
        return out


class MinMaxScaler(Preprocessor):
    """Scale columns to [0, 1] (reference:
    ray.data.preprocessors.MinMaxScaler)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        from ray_tpu_torch.data.aggregate import Max, Min
        aggs = []
        for c in self.columns:
            aggs += [Min(c), Max(c)]
        out = ds.aggregate(*aggs)
        self.stats_ = {c: (out[f"min({c})"], out[f"max({c})"])
                       for c in self.columns}

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[c]
            span = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c], dtype=np.float64)
                      - lo) / span
        return out


class LabelEncoder(Preprocessor):
    """String/categorical column -> int codes (reference:
    ray.data.preprocessors.LabelEncoder)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: list = []
        self._index: dict = {}

    def _fit(self, ds) -> None:
        self.classes_ = sorted(ds.unique(self.label_column))
        # built once here, not per batch on the map_batches hot path
        self._index = {v: i for i, v in enumerate(self.classes_)}

    def _transform_batch(self, batch: dict) -> dict:
        index = self._index
        out = dict(batch)
        try:
            out[self.label_column] = np.asarray(
                [index[v] for v in batch[self.label_column]],
                dtype=np.int64)
        except KeyError as e:
            raise ValueError(
                f"LabelEncoder({self.label_column!r}): unseen label "
                f"{e.args[0]!r} (not in the fitted classes)") from None
        return out


class OneHotEncoder(Preprocessor):
    """Categorical columns -> one-hot vector columns (reference:
    ray.data.preprocessors.OneHotEncoder): each listed column becomes
    a ``{col}_onehot`` float vector over the classes seen at fit."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.classes_: dict[str, list] = {}
        self._index: dict[str, dict] = {}

    def _fit(self, ds) -> None:
        self.classes_ = {c: sorted(ds.unique(c))
                         for c in self.columns}
        self._index = {c: {v: i for i, v in enumerate(vals)}
                       for c, vals in self.classes_.items()}

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            index = self._index[c]
            n = len(index)
            vals = batch[c]
            mat = np.zeros((len(vals), n), dtype=np.float64)
            try:
                rows = [index[v] for v in vals]
            except KeyError as e:
                raise ValueError(
                    f"OneHotEncoder({c!r}): unseen value "
                    f"{e.args[0]!r}") from None
            mat[np.arange(len(vals)), rows] = 1.0
            out[f"{c}_onehot"] = mat
            del out[c]
        return out


class SimpleImputer(Preprocessor):
    """Fill missing values (NaN/None) per column (reference:
    ray.data.preprocessors.SimpleImputer): strategy mean|most_frequent
    |constant (with ``fill_value``)."""

    def __init__(self, columns: list[str], *,
                 strategy: str = "mean", fill_value=None):
        if strategy not in ("mean", "most_frequent", "constant"):
            raise ValueError(
                f"strategy must be mean|most_frequent|constant, "
                f"got {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' needs fill_value")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: dict = {}

    def _fit(self, ds) -> None:
        if self.strategy == "constant":
            self.stats_ = {c: self.fill_value for c in self.columns}
            return
        # ONE pass over the dataset for every listed column
        rows = ds.select_columns(self.columns).take_all()
        for c in self.columns:
            present = [r[c] for r in rows
                       if r[c] is not None and not (
                           isinstance(r[c], float)
                           and np.isnan(r[c]))]
            if self.strategy == "mean":
                self.stats_[c] = (float(np.mean(
                    np.asarray(present, dtype=np.float64)))
                    if present else 0.0)
            else:  # most_frequent
                from collections import Counter
                self.stats_[c] = (Counter(present).most_common(1)[0][0]
                                  if present else None)

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            fill = self.stats_[c]
            orig = np.asarray(batch[c])
            arr = orig.astype(object)
            mask = np.array(
                [v is None or (isinstance(v, float) and np.isnan(v))
                 for v in arr])
            if not mask.any():
                out[c] = orig      # untouched column keeps its dtype
                continue
            arr = arr.copy()
            arr[mask] = fill
            if np.issubdtype(orig.dtype, np.floating) or all(
                    isinstance(v, (int, float)) and
                    not isinstance(v, bool) for v in arr):
                out[c] = arr.astype(np.float64)
            else:
                out[c] = arr       # strings/mixed stay object
        return out


class Concatenator(Preprocessor):
    """Concatenate numeric columns into one vector column (reference:
    ray.data.preprocessors.Concatenator) — the feed-the-model step."""

    def __init__(self, columns: list[str],
                 output_column_name: str = "concat_out",
                 *, drop: bool = True):
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.drop = drop

    def _transform_batch(self, batch: dict) -> dict:
        cols = [np.asarray(batch[c], dtype=np.float64).reshape(
            len(batch[c]), -1) for c in self.columns]
        out = {k: v for k, v in batch.items()
               if not (self.drop and k in self.columns)}
        out[self.output_column_name] = np.concatenate(cols, axis=1)
        return out
