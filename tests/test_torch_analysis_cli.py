"""``python -m tpu_dist_torch.analysis``: the exit codes of ``shard``,
``plan`` and ``tune-overlap`` (0 clean, 1 violations, 2 an error or a dead
detector), over the group of one it starts in this process, over 2 gloo
ranks it spawns, and of the default command (JAX's lint and audit): 0 on
the tree, 1 on a planted violation, 2 on an unknown case or a partial
``--write-baseline``; ``--list-rules`` gives JAX's IDs and names."""

import json
import os
import subprocess
import sys

import pytest
from torch_ranks import child_env

from tpu_dist.analysis import planner as jax_planner
from tpu_dist.analysis.rules import RULES as JAX_RULES
from tpu_dist.analysis import shardlint as jax_shardlint
from tpu_dist_torch.analysis import __main__ as cli
from tpu_dist_torch.analysis import overlap, planner, shardlint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = ["--device", "cpu", "--nprocs", "1"]


def test_shard_with_the_probe_exits_0_and_writes_a_report(tmp_path):
    out = str(tmp_path / "shard.json")
    assert cli.main(["shard", *ONE, "--family", "zero1_sgd", "--family", "dp_int8",
                     "--inject-reshard", "--out", out]) == 0
    report = jax_shardlint.load_shard_report(out)
    assert sorted(report["families"]) == ["dp_int8", "zero1_sgd"]
    assert report["injected_reshard_probe"]["caught"]


def test_a_full_shard_run_at_one_rank_exits_2_for_the_skipped_families(capsys):
    # tp_vit and sp_vit need 2 and 4 ranks: a full run that skipped
    # families fails the gate, as JAX's does
    assert cli.main(["shard", *ONE]) == 2
    assert "famil(ies) skipped" in capsys.readouterr().err


def test_a_dead_detector_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(shardlint, "injected_bad_zero1",
                        lambda device=None: shardlint._FAMILIES["zero1_sgd"].build(device)[:2])
    assert cli.main(["shard", *ONE, "--family", "zero1_sgd", "--inject-reshard"]) == 2
    assert "TD117 detector is dead" in capsys.readouterr().err
    monkeypatch.setattr(planner, "inject_miscost", lambda plan: plan)
    assert cli.main(["plan", *ONE, "--family", "dp_sgd", "--inject-miscost"]) == 2
    assert "TD118 detector is dead" in capsys.readouterr().err
    monkeypatch.setattr(overlap, "inject_payload", lambda report: report)
    assert cli.main(["tune-overlap", *ONE, "--family", "dp_sgd", "--inject-payload"]) == 2
    assert "TD121 detector is dead" in capsys.readouterr().err


def test_plan_and_tune_exit_0_from_reports(tmp_path):
    shard, tune, plan = (str(tmp_path / f"{n}.json") for n in ("s", "t", "p"))
    assert cli.main(["shard", *ONE, "--family", "dp_sgd", "--family", "zero1_sgd",
                     "--out", shard]) == 0
    assert cli.main(["tune-overlap", *ONE, "--family", "zero1_sgd", "--inject-payload",
                     "--out", tune]) == 0
    # a full search over a partial report skips the families it lacks: exit 2
    assert cli.main(["plan", *ONE, "--from-report", shard]) == 2
    assert cli.main(["plan", *ONE, "--from-report", shard, "--tune-report", tune,
                     "--family", "dp_sgd", "--family", "zero1_sgd", "--inject-miscost",
                     "--out", plan]) == 0
    report = jax_planner.load_plan_report(plan)
    assert report["verification"]["verified"] and report["injected_miscost_probe"]["caught"]
    assert {r["family"] for r in report["candidates"]} == {"dp_sgd", "zero1_sgd"}
    assert report["candidates"][0]["tune_knobs"] is not None


def test_violations_exit_1(monkeypatch):
    def lying(name, ops, predicted, tolerance=0.0):
        verdict, _ = real(name, ops, predicted, tolerance=tolerance)
        return verdict, [shardlint.Violation("TD116", f"<hlo:{name}>", 0, "forced")]

    real = shardlint.compare_compiled_vs_predicted
    monkeypatch.setattr(shardlint, "compare_compiled_vs_predicted", lying)
    assert cli.main(["shard", *ONE, "--family", "dp_sgd"]) == 1


@pytest.mark.parametrize("argv", [["shard", "--family", "nope"],
                                  ["tune-overlap", "--family", "fsdp"],
                                  ["plan", "--from-report", "/nonexistent.json"]])
def test_errors_exit_2(argv):
    assert cli.main([*argv, *ONE]) == 2


def test_list_families_needs_no_group(capsys):
    assert cli.main(["plan", "--list-families", *ONE]) == 0
    names = capsys.readouterr().out.split()
    assert "dp_sgd" in names and "tp_vit" not in names and "serve_eval" not in names


def _run(*argv):
    return subprocess.run([sys.executable, "-m", "tpu_dist_torch.analysis", *argv], cwd=ROOT,
                          env=child_env(), capture_output=True, text=True, timeout=120)


def test_two_spawned_ranks_and_no_subcommand():
    proc = _run("shard", "--device", "cpu", "--nprocs", "2", "--format", "json",
                "--family", "tp_vit", "--family", "dp_sgd")
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["n_devices"] == 2 and report["families"]["tp_vit"]["mesh"] == {
        "data": 1, "model": 2}
    # no subcommand: the lint of the port and the whole audit over 2 ranks
    lint = _run("--format", "json", "--device", "cpu", "--nprocs", "2")
    assert lint.returncode == 0, lint.stderr
    out = json.loads(lint.stdout)
    assert out["counts"] == {"new": 0, "stale_baseline": 0}
    assert out["audit_report"]["dp_elastic_grow_noop"] == {"identical": True}


def test_default_command_exit_codes(tmp_path, capsys):
    assert cli.main(["--no-audit"]) == 0
    assert cli.main([*ONE, "--no-lint", "--case", "dp_sgd", "--case", "dp_int8"]) == 0
    planted = tmp_path / "planted.py"
    planted.write_text("def f(x):\n    print(x)\n")
    assert cli.main([str(planted), "--no-audit"]) == 1
    assert "TD007" in capsys.readouterr().out
    assert cli.main([*ONE, "--case", "nope"]) == 2
    assert cli.main([*ONE, "--write-baseline", "--case", "dp_sgd"]) == 2
    assert cli.main([str(tmp_path / "missing"), "--no-audit"]) == 2
    assert "refusing --write-baseline" in capsys.readouterr().err


def test_a_baseline_accepts_a_finding(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text("def f(x):\n    print(x)\n")
    accepted = tmp_path / "baseline.json"
    from tpu_dist_torch.analysis import baseline, lint  # noqa: PLC0415

    baseline.write(lint.lint_paths([str(planted)]), str(accepted))
    assert cli.main([str(planted), "--no-audit", "--baseline", str(accepted)]) == 0


def test_list_rules_gives_jaxs_ids_and_names(capsys):
    assert cli.main(["--list-rules"]) == 0
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines() if ln.startswith("TD")]
    assert {(i, n) for i, n in lines} == {(r.id, r.name) for r in JAX_RULES.values()}
    assert len(lines) == 32
