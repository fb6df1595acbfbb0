"""Rule-based logical-plan optimizer.

Reference analog: python/ray/data/_internal/logical/optimizers.py:59
— an ordered list of rewrite rules applied to the logical plan before
physical planning. The fusion of transform chains into one task per
block (the reference's biggest win) lives in the stage splitter;
these rules normalize the plan ahead of it.
"""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.data.dataset import (
    _Filter,
    _Limit,
    _MapRows,
    _RandomShuffle,
    _Repartition,
    _Sort,
)


class Rule:
    """One plan -> plan rewrite."""

    def apply(self, plan: list) -> list:
        raise NotImplementedError


def _bubble(plan: list, should_swap) -> list:
    """Swap adjacent (prev, op) pairs to fixpoint wherever
    should_swap(prev, op) — the shared traversal behind the pushdown
    rules."""
    out = list(plan)
    changed = True
    while changed:
        changed = False
        for i in range(1, len(out)):
            if should_swap(out[i - 1], out[i]):
                out[i - 1], out[i] = out[i], out[i - 1]
                changed = True
    return out


class MergeLimits(Rule):
    """limit(a).limit(b) == limit(min(a, b)) — also across
    row-count-preserving ops between them."""

    def apply(self, plan: list) -> list:
        out: list = []
        for op in plan:
            if isinstance(op, _Limit):
                for prev in reversed(out):
                    if isinstance(prev, _Limit):
                        prev.n = min(prev.n, op.n)
                        break
                    if not isinstance(prev, _MapRows):
                        out.append(op)
                        break
                else:
                    out.append(op)
                continue
            out.append(op)
        return out


class LimitPushdown(Rule):
    """Push limit BEFORE row-count-preserving transforms (map): the
    truncated rows are never transformed (reference:
    LimitPushdownRule)."""

    def apply(self, plan: list) -> list:
        return _bubble(plan, lambda prev, op: isinstance(op, _Limit)
                       and isinstance(prev, _MapRows))


class DropRedundantRepartition(Rule):
    """repartition(a).repartition(b) == repartition(b); a shuffle
    immediately followed by repartition keeps both (different
    semantics), but back-to-back shuffles collapse to the LAST one
    (each is a full row permutation)."""

    def apply(self, plan: list) -> list:
        out: list = []
        for op in plan:
            if out and isinstance(op, _Repartition) and isinstance(
                    out[-1], _Repartition):
                out[-1] = op
                continue
            if out and isinstance(op, _RandomShuffle) and isinstance(
                    out[-1], _RandomShuffle) \
                    and out[-1].seed is None:
                # Only collapse an UNSEEDED earlier shuffle: seeded
                # pipelines promise a deterministic row order, and
                # P1(P0(X)) != P1(X) concretely.
                out[-1] = op
                continue
            out.append(op)
        return out


class DropShuffleBeforeSort(Rule):
    """An UNSEEDED random_shuffle immediately before sort is dead
    work — the sort imposes its own order, and an unseeded shuffle
    promises nothing about tie order. A SEEDED shuffle stays: sorts
    are stable, so with duplicate keys the seeded permutation
    deterministically fixes the tie order and dropping it would
    change reproducible results."""

    def apply(self, plan: list) -> list:
        out: list = []
        for op in plan:
            if out and isinstance(out[-1], _RandomShuffle) \
                    and out[-1].seed is None \
                    and isinstance(op, _Sort):
                out[-1] = op
                continue
            out.append(op)
        return out


class FilterPushdown(Rule):
    """Filters move BEFORE all-to-all ops so fewer rows shuffle/sort
    (reference: predicate pushdown in logical/optimizers.py). Safe
    past sort (filter preserves relative order; sort then imposes its
    own), repartition (only block boundaries differ), and UNSEEDED
    shuffles (order is random either way; a seeded shuffle promises a
    specific permutation that filtering first would change)."""

    def apply(self, plan: list) -> list:
        def swap(prev, op):
            movable = (isinstance(prev, (_Sort, _Repartition))
                       or (isinstance(prev, _RandomShuffle)
                           and prev.seed is None))
            return isinstance(op, _Filter) and movable
        return _bubble(plan, swap)


class ReorderShuffleAfterRowOps(Rule):
    """Unseeded random_shuffle moves past strictly per-row transforms
    (map/filter), keeping those transforms adjacent to their source so
    the fusion pass folds them into one task per block (reference:
    ReorderRandomizeBlocksRule — randomization is deferred so it
    cannot break read fusion). Row multiset is unchanged and the
    output order is random either way. Batch transforms are NOT moved:
    a batch fn can be non-elementwise, and regrouping rows before it
    changes results."""

    def apply(self, plan: list) -> list:
        return _bubble(plan, lambda prev, op: (
            isinstance(prev, _RandomShuffle) and prev.seed is None
            and isinstance(op, (_MapRows, _Filter))))


DEFAULT_RULES: list[Callable[[], Rule]] = [
    MergeLimits, LimitPushdown, FilterPushdown,
    ReorderShuffleAfterRowOps, DropShuffleBeforeSort,
    DropRedundantRepartition,
]


def optimize(plan: list, rules=None) -> list:
    import copy

    # Rules mutate op fields (MergeLimits): operate on copies so the
    # lazy Dataset's recorded plan is untouched and re-executable.
    plan = [copy.copy(op) for op in plan]
    rule_list = [rc() for rc in (rules or DEFAULT_RULES)]

    def snapshot(p):
        # dict COPIES: rules mutate op fields in place, and a live
        # reference would make before == after trivially true.
        return [(type(op), dict(getattr(op, "__dict__", {}) or {}))
                for op in p]

    # To fixpoint: one rule's rewrite can expose another's pattern
    # (e.g. dropping a dead shuffle makes two shuffles adjacent).
    for _ in range(8):
        before = snapshot(plan)
        for rule in rule_list:
            plan = rule.apply(plan)
        if snapshot(plan) == before:
            break
    return plan
