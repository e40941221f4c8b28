"""The audit cases of ``tpu_dist_torch/analysis/step_audit.py`` at 4 gloo
ranks: every case clean under TD101-TD103 and TD104, the budgets' four
invariants (JAX's: ``no_sync``, error feedback, device metrics and the
fused epoch's 2 steps), and three planted faults caught: a mutated budget
(TD101), a host read inside the step (TD102) and a decompressed wire leg
(TD104)."""

import pytest
from torch_ranks import audit_rank, run_ranks

from tpu_dist_torch.analysis import step_audit

WORLD = 4


@pytest.fixture(scope="module")
def audited():
    return run_ranks(audit_rank, WORLD, timeout=120.0)


def test_every_case_is_clean_on_every_rank(audited):
    for report, vs, _, _ in audited:
        assert vs == []
        assert sorted(report) == step_audit.registered_cases()
        for name, counts in report.items():
            assert counts["transfers"] == 0, name
            # one c10d op a call: gloo runs each of these calls as one op
            assert sum(counts["executed"].values()) == sum(counts["collectives"].values()), name
            assert counts["launches"] == {}, name  # no kernel on the CPU


def test_budget_invariants(audited):
    budgets = audited[0][2]
    coll = {name: b[0] for name, b in budgets.items()}
    assert coll["dp_sgd_accum4"] == coll["dp_sgd"]  # torch's no_sync contract
    assert coll["dp_int8_ef"] == coll["dp_int8"]  # error feedback is local arithmetic
    assert coll["dp_device_metrics"] == coll["dp_sgd"]  # the health scalars add none
    for fused, step in (("fused_none", "dp_sgd"), ("fused_bf16", "dp_wire_bf16"),
                        ("fused_int8", "dp_int8"), ("fused_int8_ef", "dp_int8_ef")):
        assert coll[fused] == {k: 2 * v for k, v in coll[step].items()}, fused
    assert budgets["dp_bf16"][2] == 6  # JAX's _BF16_CONVERTS
    assert all(b[1] == 0 for b in budgets.values())


def test_wire_ratios(audited):
    report = audited[0][0]
    pay = {name: report[name]["wire"]["payload_bytes"] for name in report}
    # the proxy's 480 parameters divide over 4 ranks: no padding, so the
    # ratios land exactly on JAX's 0.25x f32 and 0.5x bf16
    for q, ref32, ref16 in (("dp_int8", "dp_sgd", "dp_wire_bf16"),
                            ("dp_int8_ef", "dp_sgd", "dp_wire_bf16"),
                            ("fused_int8", "fused_none", "fused_bf16"),
                            ("fused_int8_ef", "fused_none", "fused_bf16")):
        assert pay[q] == 0.25 * pay[ref32] == 0.5 * pay[ref16], q


def test_planted_faults_are_caught(audited):
    for _, _, _, (mutated, item, leg) in audited:
        assert [v["rule"] for v in mutated] == ["TD101"]
        assert "psum: expected 3" in mutated[0]["message"]
        assert [v["rule"] for v in item] == ["TD102"]
        # the f32 all-gather leg breaks both of dp_int8's ratios
        assert sorted((v["rule"], v["path"]) for v in leg) == [("TD104", "<step:dp_int8>")] * 2
