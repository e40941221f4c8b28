"""The fleet drill's grow phase (``python -m tpu_dist_torch.fleet.drill
--phase grow``) end to end on the CPU, the counterpart of the JAX drill's
``tests/test_fleet.py:787`` at the smallest size that still shrinks,
grows and re-lays the ZeRO-1 state: 3 gloo ranks, preempted after epoch
0's first step, resumed at 1 rank under the real supervisor with the
census capping the relaunch, and grown back to 3 by the real capacity
probe, whose SIGTERM ends the shrunken round's hold; vit_tiny, 2 epochs of
2 steps. ``vit_tiny``'s 107,978 parameters do not divide by 3, so both
resumes re-lay the flat optimizer state (``resharded``). The drill itself
checks the shrink and grow ``resume`` records, ``elastic.grows`` and each
epoch's loss against the golden run's (2e-3 relative; the rounds replay
the golden world's batches, so the gaps are summation order only)."""

import json
import os

import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist_torch.fleet import drill


def test_fleet_drill_grow_phase_shrinks_and_grows_back(tmp_path, capsys):
    rc = drill.main(["--workdir", str(tmp_path), "--phase", "grow", "--device", "cpu",
                     "--devices", "3", "--batch_size", "48", "--epochs", "2",
                     "--steps_per_epoch", "2", "--kill_epoch", "0", "--kill_step", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS grow" in out
    with open(os.path.join(tmp_path, "elastic.jsonl")) as f:
        resumes = [r for r in map(json.loads, f) if r.get("kind") == "resume"]
    assert [(r["prev_dp"], r["dp"], r["resharded"], r["restarts"]) for r in resumes] == [
        (3, 1, True, 1), (1, 3, True, 2)]


def test_a_world_larger_than_the_cards_fails_and_names_the_count(tmp_path, capsys):
    """No round moves to the CPU when the cards are missing: ``--device
    cuda`` on a machine without enough of them fails before any round."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rc = drill.main(["--workdir", str(tmp_path), "--phase", "grow", "--device", "cpu",
                     "--shrink_device", "cuda", "--devices", "2", "--shrink_to", "1"]
                    if cards == 0 else
                    ["--workdir", str(tmp_path), "--phase", "grow", "--device", "cuda",
                     "--devices", str(cards + 1), "--shrink_to", "1"])
    out = capsys.readouterr().out
    assert rc == 1
    assert f"and this machine has {cards}" in out
    assert not os.path.exists(os.path.join(tmp_path, "golden.jsonl"))
