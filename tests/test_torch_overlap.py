"""The port's overlap tuner (``tpu_dist_torch/analysis/overlap.py``) over 4
gloo ranks, against JAX's tuner where they share a report:

* every ``KNOB_SPACE`` candidate is TD121-clean: its payload bytes are the
  baseline's and its schedule moved (its executed ops, their dispatch
  distances or its count of collective calls);
* ``inject_payload`` is caught by the port's re-gate and by JAX's;
* ``chosen_knobs`` and ``load_tune_report`` read the port's report as
  JAX's do, and malformed reports give JAX's ``TuneReportError`` messages.
"""

import copy
import json

import pytest
from torch_ranks import run_ranks, tune_rank

from tpu_dist.analysis import overlap as jax_overlap
from tpu_dist_torch.analysis import overlap

WORLD = 4


@pytest.fixture(scope="module")
def tuned():
    report, vs, inj = run_ranks(tune_rank, WORLD, timeout=240)[0]
    return {"report": report, "vs": vs, "inj": inj}


def test_knob_space_is_jaxs():
    assert overlap.KNOB_SPACE == jax_overlap.KNOB_SPACE


CANDIDATES = [(fam, knobs) for fam, space in overlap.KNOB_SPACE.items() for knobs in space[1:]]


@pytest.mark.parametrize("family,knobs", CANDIDATES,
                         ids=[f"{f}-{json.dumps(k, sort_keys=True)}" for f, k in CANDIDATES])
def test_every_candidate_is_td121_clean(tuned, family, knobs):
    entry = tuned["report"]["families"][family]
    base = entry["baseline"]
    [cand] = [c for c in entry["candidates"] if c["knobs"] == knobs]
    assert cand["td121"] == {"clean": True, "violations": []}
    assert cand["wire"]["payload_bytes"] == base["wire"]["payload_bytes"]
    assert cand["wire"]["quantized_payload_bytes"] == base["wire"]["quantized_payload_bytes"]
    assert (cand["fingerprint"] != base["fingerprint"] or cand["distances"] != base["distances"]
            or cand["jaxpr_collectives"] != base["jaxpr_collectives"])
    # JAX's gate over the port's measurements agrees
    assert jax_overlap.check_candidate(family, base, cand) == []


def test_the_report_is_clean_and_chooses_deterministically(tuned):
    report = tuned["report"]
    assert tuned["vs"] == [] and report["skips"] == {}
    assert report["objective"] == overlap.PROXY_OBJECTIVE
    assert report["counts"] == {"families": 4, "skipped": 0, "violations": 0}
    for fam, entry in report["families"].items():
        best = max(c["schedule"]["mean_distance"] for c in entry["candidates"])
        assert entry["chosen"]["schedule"]["mean_distance"] == best, fam
    # ZeRO-1's chunked pair leaves ops between each reduce-scatter and the
    # concatenation that reads it: the schedule moves the most there
    assert report["families"]["zero1_sgd"]["chosen"]["knobs"] == {"rs_ag_chunks": 4}


def test_inject_payload_is_caught(tuned):
    assert tuned["inj"] and {v["rule"] for v in tuned["inj"]} == {"TD121"}
    bad = overlap.inject_payload(tuned["report"])
    assert jax_overlap.recheck_report(bad)
    assert overlap.recheck_report(tuned["report"]) == []
    assert jax_overlap.recheck_report(tuned["report"]) == []


def test_chosen_knobs_and_the_loader_are_jaxs(tuned, tmp_path):
    path = str(tmp_path / "t.json")
    overlap.save_tune_report(tuned["report"], path)
    ours, theirs = overlap.load_tune_report(path), jax_overlap.load_tune_report(path)
    assert ours == theirs
    for fam in list(overlap.KNOB_SPACE) + ["fsdp"]:
        assert overlap.chosen_knobs(ours, fam) == jax_overlap.chosen_knobs(theirs, fam)
    # a JAX-written report through the port's loader
    jpath = str(tmp_path / "j.json")
    jax_overlap.save_tune_report(theirs, jpath)
    assert overlap.load_tune_report(jpath)["families"].keys() == ours["families"].keys()


def test_newer_schema_is_tolerated_with_a_count(tuned, tmp_path):
    data = copy.deepcopy(tuned["report"])
    data["schema"] = "tune_report_v3"
    del data["families"]["dp_sgd"]["chosen"]["schedule"]
    path = str(tmp_path / "t.json")
    overlap.save_tune_report(data, path)
    assert overlap.load_tune_report(path)["load_notes"] == \
        jax_overlap.load_tune_report(path)["load_notes"]


MALFORMED = (
    ("foreign", {"schema": "plan_report_v1", "families": {}}),
    ("older", {"schema": "tune_report_v0", "families": {}}),
    ("no families", {"schema": "tune_report_v1"}),
    ("missing chosen keys", {"schema": "tune_report_v1",
                             "families": {"dp_sgd": {"chosen": {"knobs": {}}}}}),
    ("not a dict", "x"),
)


@pytest.mark.parametrize("name,data", MALFORMED, ids=[m[0] for m in MALFORMED])
def test_malformed_tune_reports_raise_jaxs_messages(tmp_path, name, data):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(jax_overlap.TuneReportError) as theirs:
        jax_overlap.load_tune_report(path)
    with pytest.raises(overlap.TuneReportError) as ours:
        overlap.load_tune_report(path)
    assert str(ours.value) == str(theirs.value)


def test_format_text_renders_the_report(tuned):
    text = overlap.format_text(tuned["report"])
    assert "objective=dispatch_schedule_proxy" in text
    assert "families=4 skipped=0 violations=0" in text
