"""The port's straggler check (``tpu_dist_torch/obs/straggler.py`` and the
trainer's call after each epoch) against the JAX package's
(``tpu_dist/obs/straggler.py``).

* ``epoch_skew`` with the same injected rows gives the same record and the
  same rank-0 warning (host arithmetic in f64: exact).
* Two gloo ranks of ``Trainer.fit``, rank 1 held 2 s after the last step
  of its first epoch (a bounded ``hang`` fault: the time a slow disk or a
  busy host adds outside the step's collectives): rank 0's history has a
  ``straggler`` record for that epoch naming rank 1, none for the second
  epoch, and every rank counts one ``comm.all_gather.straggler`` an epoch.
* At a world of one the check runs with no collective: the counts do not
  move.
"""

import numpy as np
import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)
from torch_ranks import free_port, history_fit_rank, run_ranks

from tpu_dist.obs import counters as jax_counters
from tpu_dist.obs import straggler as jax_straggler
from tpu_dist_torch.obs import counters, straggler

ROWS = [
    np.array([[10.0, 0.01], [10.4, 0.02], [18.4, 0.31], [9.9, 0.0]]),
    np.array([[5.0, 0.1], [5.1, 0.0]]),
    np.array([[3.0, 0.0]]),
    np.array([[0.0, 0.0], [0.0, 0.0]]),
    np.array([[2.0, 0.5], [1.0, 0.25], [7.5, 0.75]]),
]


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.5, 3.0])
@pytest.mark.parametrize("i", range(len(ROWS)))
def test_epoch_skew_with_the_same_rows_gives_the_same_record(i, threshold, capsys):
    rows = ROWS[i]
    counters.reset()
    jax_counters.reset()
    ours = straggler.epoch_skew(float(rows[0, 0]), float(rows[0, 1]), epoch=i,
                                threshold=threshold, allgather=lambda row: rows)
    our_out = capsys.readouterr().out
    theirs = jax_straggler.epoch_skew(float(rows[0, 0]), float(rows[0, 1]), epoch=i,
                                      threshold=threshold, allgather=lambda row: rows)
    assert ours == theirs
    assert our_out == capsys.readouterr().out
    assert (counters.get("straggler.epochs_flagged")
            == jax_counters.get("straggler.epochs_flagged") == int(ours["straggler"]))


def test_the_default_gather_at_world_one_is_no_collective():
    counters.reset()
    rec = straggler.epoch_skew(4.0, 0.25, threshold=0.5)
    assert rec == {"skew": 1.0, "straggler": True, "worst_rank": 0, "median_s": 4.0,
                   "max_s": 4.0, "epoch_times": [4.0], "stall_fracs": [0.25]}
    assert not any(k.startswith("comm.") for k in counters.snapshot())


RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=128,
           batch_size=16, epochs=2, steps_per_epoch=3, lr=0.02, log_every=1, eval_every=0,
           seed=0, device="cpu", straggler_threshold=1.2)


def test_a_slow_rank_is_named_on_rank_0_with_one_gather_an_epoch(tmp_path):
    cfg = dict(RUN, port=free_port(), log_file=str(tmp_path / "h.jsonl"),
               fault_plan="hang@epoch=0:step=2:rank=1:seconds=2")
    ranks = run_ranks(history_fit_rank, 2, cfg, timeout=120)
    for r in ranks:
        assert r["error"] is None
        assert r["counters"]["comm.all_gather.straggler"] == 2  # one an epoch
    recs = [x for x in ranks[0]["records"] if x["kind"] == "straggler"]
    assert [x["epoch"] for x in recs] == [0]
    rec = recs[0]
    assert rec["straggler"] and rec["worst_rank"] == 1 and rec["skew"] > 1.2
    assert rec["epoch_times"][1] - rec["epoch_times"][0] > 1.5
    assert ranks[0]["counters"]["straggler.epochs_flagged"] == 1


def test_one_rank_checks_every_epoch_with_no_collective(tmp_path):
    cfg = dict(RUN, port=free_port(), log_file=str(tmp_path / "h.jsonl"),
               straggler_threshold=0.5, epochs=1, steps_per_epoch=1)
    [r] = run_ranks(history_fit_rank, 1, cfg, timeout=120)
    assert r["error"] is None
    assert "comm.all_gather.straggler" not in r["counters"]
    [rec] = [x for x in r["records"] if x["kind"] == "straggler"]
    assert (rec["skew"], rec["worst_rank"], rec["straggler"]) == (1.0, 0, True)
