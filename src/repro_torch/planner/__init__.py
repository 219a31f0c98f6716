"""Candidate-pruning query planner: filter-and-verify over block postings
(port of ``repro.planner``, host side).

    postings.py  block-compressed hash/buffer-bit postings
    prune.py     threshold-aware candidate generation with per-block
                 header skipping, and the dense route's threshold cut
    plan.py      per-batch dense-vs-pruned cost decision and executors
                 (pruned_batch, pruned_topk)

The ragged verify kernel (B5) lives with the other kernels in
:mod:`repro_torch.kernels.gather_score`.
"""

from repro_torch.planner.plan import (PLAN_MODES, QueryPlan, choose_plan,
                                      normalize_plan,
                                      probe_block_stats, probe_hits,
                                      probe_hits_per_query, pruned_batch,
                                      pruned_topk, topk_select,
                                      unpack_query_rows)
from repro_torch.planner.postings import (BLOCK, BlockStore, PostingsIndex,
                                          build_postings, decode_blocks,
                                          decode_store, encode_store,
                                          from_flat, postings_equal)
from repro_torch.planner.prune import (CandidateSet, candidates_for,
                                       f32_threshold, mask_to_hits,
                                       query_bits, tail_bound,
                                       threshold_hits_packed)

__all__ = [
    "PLAN_MODES", "QueryPlan", "choose_plan",
    "normalize_plan", "probe_block_stats", "probe_hits",
    "probe_hits_per_query", "pruned_batch", "pruned_topk", "topk_select",
    "unpack_query_rows",
    "BLOCK", "BlockStore", "PostingsIndex", "build_postings",
    "decode_blocks", "decode_store", "encode_store", "from_flat",
    "postings_equal",
    "CandidateSet", "candidates_for", "f32_threshold", "mask_to_hits",
    "query_bits", "tail_bound", "threshold_hits_packed",
]
