"""Candidate-pruning query planner: filter-and-verify over block postings
(port of ``repro.planner``).

    postings.py  block-compressed hash/buffer-bit postings (host build,
                 and the device encode of the tail store)
    prune.py     threshold-aware candidate generation with per-block
                 header skipping, and the dense route's threshold cut
    plan.py      per-batch dense-vs-pruned cost decision and the host
                 executors (pruned_batch, pruned_topk)
    device.py    the device pruned pipeline over a SketchArena (staged
                 queries, packed hit words, top-k); imported as a module

The kernels live in :mod:`repro_torch.kernels`: the ragged verify (B5) in
``gather_score``, the probe (B3) and block decode (B4) in
``postings_merge``.
"""

from repro_torch.planner.plan import (PLAN_MODES, QueryPlan, choose_plan,
                                      normalize_plan,
                                      probe_block_stats, probe_hits,
                                      probe_hits_per_query, pruned_batch,
                                      pruned_topk, scored_prefix,
                                      topk_candidates, topk_select,
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
    "probe_hits_per_query", "pruned_batch", "pruned_topk", "scored_prefix",
    "topk_candidates", "topk_select", "unpack_query_rows",
    "BLOCK", "BlockStore", "PostingsIndex", "build_postings",
    "decode_blocks", "decode_store", "encode_store", "from_flat",
    "postings_equal",
    "CandidateSet", "candidates_for", "f32_threshold", "mask_to_hits",
    "query_bits", "tail_bound", "threshold_hits_packed",
]
