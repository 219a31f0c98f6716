"""Query routing record and the shared top-k head (port of the dense-path
half of ``repro.planner.plan``). The cost-model planner and the pruned
routes arrive with their slices of the port."""

from __future__ import annotations

import dataclasses

import numpy as np

PLAN_MODES = ("auto", "dense", "pruned")


@dataclasses.dataclass
class QueryPlan:
    """One batch's routing decision (attached to indexes as .last_plan)."""

    path: str              # "dense" | "pruned"
    est_dense: float       # cost-model units
    est_pruned: float
    hits: int              # posting entries the batch's hashes/bits touch
    reason: str


def normalize_plan(plan: str | None) -> str:
    plan = "auto" if plan is None else plan
    if plan not in PLAN_MODES:
        raise ValueError(f"plan must be one of {PLAN_MODES}, got {plan!r}")
    return plan


def topk_select(rec_ids, scores, k: int,
                num_records: int) -> tuple[np.ndarray, np.ndarray]:
    """The top-k output head: score descending, ties by ascending record
    id, and records absent from ``rec_ids`` (or scoring exactly 0)
    filling any shortfall in ascending-id order."""
    k = min(int(k), int(num_records))
    if k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    ids = np.asarray(rec_ids, np.int64)
    s = np.asarray(scores, np.float32)
    pos_mask = s > 0
    ids, s = ids[pos_mask], s[pos_mask]
    order = np.lexsort((ids, -s))           # score desc, id asc
    ids, s = ids[order][:k], s[order][:k]
    if len(ids) < k:
        fill = np.setdiff1d(np.arange(num_records, dtype=np.int64),
                            ids)[: k - len(ids)]
        ids = np.concatenate([ids, fill])
        s = np.concatenate([s, np.zeros(len(fill), np.float32)])
    return ids.astype(np.int64), s.astype(np.float32)
