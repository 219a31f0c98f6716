"""The device pipeline's staging pool keeps one blob per card.

A blob is keyed by its layout and the full device (type and index), and the
event that orders its next refill is recorded on the stream of the card it
was copied to. The key test needs no card; the second test needs two and
skips with fewer.
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.data.synth import generate_dataset, make_query_workload
from repro_torch.planner import device as planner_device


def test_pool_key_tells_cards_apart():
    key = planner_device.staging_key
    assert key(8, 1, torch.device("cuda:0")) != key(8, 1, torch.device("cuda:1"))
    assert key(8, 1, "cuda:1") == key(8, 1, torch.device("cuda", 1))
    assert key(8, 1, "cpu") != key(8, 1, "cuda:0")
    assert key(8, 1, "cuda:0") != key(8, 2, "cuda:0")


@pytest.mark.cuda
def test_index_on_a_second_card_stages_on_its_own_stream():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    recs = generate_dataset(m=2000, n_elems=3000, alpha_freq=1.14,
                            alpha_size=2.5, size_min=5, size_max=80, seed=3)
    budget = int(0.15 * sum(len(r) for r in recs))
    queries = make_query_workload(recs, 32, seed=2)
    torch.cuda.set_device(0)
    index = api.build("gbkmv", recs, budget, postings="eager",
                      device="cuda:1")
    assert index.core.sketches.device_pack(index.device).device.index == 1
    want = [index.batch_query(queries[i:i + 16], 0.5, plan="dense")
            for i in (0, 16)]
    planner_device.reset_pipeline_stats()
    # Two pruned batches back to back: the second refills the pooled blob
    # only after the first one's copy to cuda:1 is done.
    got = [index.batch_query(queries[i:i + 16], 0.5, plan="pruned")
           for i in (0, 16)]
    assert index.last_candidate_sizes is None          # the device route
    assert torch.cuda.current_device() == 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    st = planner_device.pipeline_stats()
    assert st["staging_alloc"] == 1 and st["staging_reuse"] == 1
