"""The tenancy drill of the port (``python -m
tpu_dist_torch.fleet.tenancy_drill``), the counterpart of
``tpu_dist/fleet/tenancy_drill.py``:

* phase policy, at JAX's defaults (8 -> 4 ranks, an 11-card pod): the
  same report, line for line, and the same scheduler records, field for
  field, as the JAX drill's; the decisions at ticks 3 (the preempting
  donation), 4 (its grant, the same ``decision_id``), 8 (the off-peak
  release) and 9 (the grow back); the chip-second audit exact in integer
  chip-ticks. At 2 -> 1 ranks (a one-card machine's shrunken round), where
  the JAX drill's pod has no feasible serving size and refuses, the port's
  pod (3 cards) gives the same tick positions and an exact audit;
* phase cycle on CPU gloo ranks at its smallest size (2 -> 1 -> 2 ranks,
  3 epochs of 3 steps): the PASS, both resume records, every epoch's loss
  equal to the golden run's, the decision chain and the serve-preempt gap
  in ``preempt_for_serve_s``;
* phase replica on the CPU: SIGKILL, bundle, relaunch with the same
  digest, drain;
* a world larger than the cards fails naming the count, and the options
  are checked.
"""

import json
import os
import re
import types

import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.fleet import tenancy_drill as jax_drill
from tpu_dist_torch.fleet import scheduler as sched
from tpu_dist_torch.fleet import tenancy_drill as drill


def _args(root, **kw) -> types.SimpleNamespace:
    return types.SimpleNamespace(workdir=str(root), **{"devices": 8, "shrink_to": 4, **kw})


def _fleet_records(root) -> list:
    path = os.path.join(root, "policy_fleet", "fleet.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _positions(records: list) -> list:
    return [(r["tick"], r["action"], r.get("donor"), r.get("recipient"), bool(r.get("preempt")),
             r.get("decision_id")) for r in records if r["kind"] == "fleet"]


def test_the_policy_phase_equals_jax(tmp_path, capsys):
    assert drill.run_policy_phase(_args(tmp_path / "port")) == 0
    ours = capsys.readouterr().out
    assert jax_drill.run_policy_phase(_args(tmp_path / "jax")) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs
    recs = _fleet_records(tmp_path / "port")
    assert recs == _fleet_records(tmp_path / "jax")
    assert _positions(recs) == [
        (3, "donate", "trainer", None, True, 1), (4, "grant", None, "svc", True, 1),
        (8, "donate", "svc", None, False, 2), (9, "grant", None, "trainer", False, 2)]
    audit = sched.audit_chip_seconds(recs, tick_s=drill.TICK_SECONDS)
    assert audit["conserved"] and audit["accounted_chip_s"] == audit["pod_chip_s"] == 110
    assert drill.DIURNAL_TRACE == jax_drill.DIURNAL_TRACE
    assert drill.SPIKE_TICK == jax_drill.SPIKE_TICK == 2


def test_the_policy_phase_at_one_card(tmp_path, capsys):
    # the JAX pod has no feasible serving size at --shrink_to 1
    with pytest.raises(ValueError, match="not a feasible size"):
        jax_drill.run_policy_phase(_args(tmp_path / "jax", devices=2, shrink_to=1))
    assert drill.run_policy_phase(_args(tmp_path / "port", devices=2, shrink_to=1)) == 0
    assert "PASS policy" in capsys.readouterr().out
    recs = _fleet_records(tmp_path / "port")
    assert _positions(recs) == [
        (3, "donate", "trainer", None, True, 1), (4, "grant", None, "svc", True, 1),
        (8, "donate", "svc", None, False, 2), (9, "grant", None, "trainer", False, 2)]
    audit = sched.audit_chip_seconds(recs, tick_s=drill.TICK_SECONDS)
    assert audit["conserved"] and audit["total_chips"] == 3 and audit["pod_chip_s"] == 30


def test_the_cycle_on_cpu_ranks(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the drill's trainer children
    rc = drill.main(["--workdir", str(tmp_path), "--phase", "cycle", "--device", "cpu",
                     "--devices", "2", "--shrink_to", "1", "--epochs", "3",
                     "--steps_per_epoch", "3", "--kill_step", "0", "--batch_size", "32",
                     "--tick_s", "0.1", "--fused_optimizer"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = [ln.removeprefix("tenancy-drill: ") for ln in out.splitlines()
             if ln.startswith("tenancy-drill: ")]
    assert "PASS cycle" in lines[-2]
    records = {m.group(1): json.loads(m.group(2)) for m in
               (re.match(r"resume record \((\w+)\): (.*)", ln) for ln in lines) if m}
    assert (records["shrink"]["prev_dp"], records["shrink"]["dp"],
            records["shrink"]["decision_cause"]) == (2, 1, "serve_breach")
    assert (records["grow"]["prev_dp"], records["grow"]["dp"]) == (1, 2)
    # the grown world closes the preempted epoch from the end-of-epoch snapshot
    assert records["grow"]["epoch"] == 1 and records["grow"]["examples_offset"] == 96
    gaps = [float(m.group(1)) for m in
            (re.match(r"epoch \d: .* \(rel (\S+)\)", ln) for ln in lines) if m]
    assert len(gaps) == 3 and max(gaps) <= drill.LOSS_RTOL
    assert any(ln.startswith("causal chain: decision #1 ") for ln in lines)
    assert any(ln.startswith("preemption latency: donate at tick") for ln in lines)
    launches = [ln for ln in lines if ln.startswith("launches: ")]
    assert [ln.split(":")[1].strip() for ln in launches] == ["golden", "round 0", "round 1",
                                                              "round 2"]


def test_the_replica_phase_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the replica children
    assert drill.main(["--workdir", str(tmp_path), "--phase", "replica",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "relaunch restored BIT-EXACT weights" in out and "PASS replica" in out
    assert re.search(r"replica launches: pid \d+ served \d+ request\(s\) in \d+ forward\(s\): "
                     r"flash_attention_fwd 0 \(0 on the tensor cores\)", out)


def test_worlds_larger_than_the_cards_fail_naming_the_count(tmp_path, capsys):
    if drill._check_world(8, "cuda") is None:
        pytest.skip("this machine has 8 cards")
    assert drill.run_cycle_phase(_args(tmp_path, device="cuda", shrink_device=None)) == 1
    assert "need 8 card(s)" in capsys.readouterr().out


@pytest.mark.parametrize("bad", [["--kill_epoch", "2", "--epochs", "3"],
                                 ["--kill_step", "2", "--steps_per_epoch", "4"]])
def test_the_cycle_options_are_checked(tmp_path, bad):
    with pytest.raises(SystemExit) as e:
        drill.main(["--workdir", str(tmp_path), "--phase", "cycle", *bad])
    assert e.value.code == 2
