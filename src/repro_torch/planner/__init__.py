"""Query planning (dense route only in this slice of the port)."""

from repro_torch.planner.plan import (PLAN_MODES, QueryPlan, normalize_plan,
                                      topk_select)
from repro_torch.planner.prune import (f32_threshold, mask_to_hits,
                                       threshold_hits_packed)

__all__ = ["PLAN_MODES", "QueryPlan", "normalize_plan", "topk_select",
           "f32_threshold", "mask_to_hits", "threshold_hits_packed"]
