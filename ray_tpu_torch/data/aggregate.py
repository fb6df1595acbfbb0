"""Aggregation descriptors (reference: python/ray/data/aggregate.py —
AggregateFn and the Count/Sum/Min/Max/Mean/Std family).

Used by ``Dataset.aggregate(*aggs)`` and
``GroupedData.aggregate(*aggs)``. Each descriptor names its output
column the way the reference does (``sum(x)``, ``count()``...).
"""

from __future__ import annotations

import numpy as np


class AggregateFn:
    """Custom aggregation: ``init`` (zero accumulator),
    ``accumulate_block(acc, column_array) -> acc``, ``merge(a, b)``,
    ``finalize(acc)``, over column ``on`` (None = row count)."""

    def __init__(self, *, init, accumulate_block, merge,
                 finalize=lambda a: a, on: str | None = None,
                 name: str | None = None):
        self.init = init
        self.accumulate_block = accumulate_block
        self.merge = merge
        self.finalize = finalize
        self.on = on
        self.name = name or (f"custom({on})" if on else "custom()")


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda: 0,
            accumulate_block=lambda a, col: a + len(col),
            merge=lambda a, b: a + b,
            on=None, name="count()")


class Sum(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda: 0,
            accumulate_block=lambda a, col: a + col.sum(),
            merge=lambda a, b: a + b,
            on=on, name=f"sum({on})")


class Min(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda: None,
            accumulate_block=lambda a, col: (
                a if len(col) == 0 else
                col.min() if a is None else min(a, col.min())),
            merge=lambda a, b: (b if a is None else
                                a if b is None else min(a, b)),
            on=on, name=f"min({on})")


class Max(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda: None,
            accumulate_block=lambda a, col: (
                a if len(col) == 0 else
                col.max() if a is None else max(a, col.max())),
            merge=lambda a, b: (b if a is None else
                                a if b is None else max(a, b)),
            on=on, name=f"max({on})")


class Mean(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda: (0.0, 0),
            accumulate_block=lambda a, col: (a[0] + col.sum(),
                                             a[1] + len(col)),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: (a[0] / a[1]) if a[1] else None,
            on=on, name=f"mean({on})")


class Std(AggregateFn):
    """Sample stddev (ddof=1, the reference default) via the
    Welford/Chan (count, mean, M2) parallel merge — sum-of-squares
    cancels catastrophically when mean >> std (the reference's
    AggregateFn uses the same M2 merge for this reason)."""

    def __init__(self, on: str, ddof: int = 1):
        def merge(a, b):
            na, ma, m2a = a
            nb, mb, m2b = b
            if na == 0:
                return b
            if nb == 0:
                return a
            n = na + nb
            d = mb - ma
            return (n, ma + d * nb / n,
                    m2a + m2b + d * d * na * nb / n)

        def acc_block(a, col):
            col = np.asarray(col, dtype=np.float64)
            nb = len(col)
            if nb == 0:
                return a
            mb = float(col.mean())
            m2b = float(((col - mb) ** 2).sum())
            return merge(a, (nb, mb, m2b))

        def fin(a):
            n, _, m2 = a
            if n <= ddof:
                return None
            return float(np.sqrt(m2 / (n - ddof)))

        super().__init__(
            init=lambda: (0, 0.0, 0.0),
            accumulate_block=acc_block,
            merge=merge,
            finalize=fin,
            on=on, name=f"std({on})")
