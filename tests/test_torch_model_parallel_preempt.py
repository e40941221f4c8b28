"""SIGTERM under ``--tp 2`` and ``--ep 2`` on 2 gloo ranks
(``tests/torch_ranks.py::resume_rank``): the signal reaches rank 0 alone at
its 5th step, both ranks stop after it (the step's vote), agree to take the
emergency snapshot (whose save gathers the shards over the model or expert
group, so no rank may skip it alone), and the resumed run ends exactly
where the uninterrupted one does."""

import numpy as np
import pytest
from torch_ranks import free_port, resume_rank, run_ranks

RUN = dict(num_classes=10, dataset="synthetic", synthetic_n=96, batch_size=16, epochs=2,
           steps_per_epoch=3, lr=0.02, log_every=1, eval_every=1, device="cpu")
CASES = {"tp2": dict(model="vit_tiny", tp=2), "ep2": dict(model="vit_moe_tiny", ep=2,
                                                          moe_top_k=2)}


@pytest.mark.parametrize("case", list(CASES))
def test_a_sharded_run_stops_together_and_resumes_exactly(case, tmp_path):
    cfg = dict(RUN, **CASES[case], port=free_port())
    ranks = run_ranks(resume_rank, 2, cfg, str(tmp_path), 4, timeout=120)
    for full, cut, rest in ranks:
        assert (len(cut["losses"]), cut["error"]) == (5, "PreemptedError")
        meta = cut["meta"]  # the emergency snapshot rank 0 wrote
        assert (meta["epoch"], meta["mid_epoch_step"]) == (1, 2) and rest["start_epoch"] == 1
        # f32 on the CPU, the same steps on the same batches from the
        # restored shards and momentum: exact
        assert cut["losses"] + rest["losses"] == full["losses"]
        assert rest["state"].keys() == full["state"].keys()
        for k, v in full["state"].items():
            np.testing.assert_array_equal(rest["state"][k], v, err_msg=k)
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
