"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries in ``BENCHMARK.json`` and found by their names,
with no file of the harness edited; the harness runs such cells on the
CPU end to end (the chip's look skipped)."""

import json

import pytest

from gpubench import check, run
from gpubench.manifest import Manifest
from tiny import tiny_root

NEW_METRIC = '''
def read(run):
    return float(run.window["calls"])
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dst = tiny_root(tmp_path_factory.mktemp("bench"))
    pkg = dst / "gpubench"
    # a second traffic mix of the tiny ViT, data alone
    step = json.loads((pkg / "traffic/t_step.json").read_text())
    (pkg / "traffic/t_step_b2.json").write_text(json.dumps(dict(step, batch=2)))
    # a per-layer metric of its own, in a file named with a dot
    (pkg / "metrics/window_calls.train.py").write_text(NEW_METRIC)
    man = json.loads((dst / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "vit_tiny.t_step_b2", "config": "vit_tiny",
                             "traffic": "t_step_b2", "chips": 1, "why": "batch 2"})
    (pkg / "limits/vit_tiny.t_step_b2.json").write_text(
        (pkg / "limits/vit_tiny.t_step.json").read_text())
    for m in man["end_to_end"]:
        if "vit_tiny.t_step" in m.get("workloads", ()):
            m["workloads"].append("vit_tiny.t_step_b2")
    man["per_layer"].append({"name": "window_calls.train", "unit": "calls", "better": "higher",
                             "source": "program_counter", "layer": "train step",
                             "moves": "images_per_s",
                             "workloads": ["vit_tiny.t_step", "vit_tiny.t_step_b2"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(man))
    return dst


def test_new_files_are_found_by_name(root):
    man = Manifest(root)
    assert man.config("vit_tiny")["hidden_size"] == 128
    assert man.traffic("t_step_b2")["batch"] == 2
    assert [m["name"] for m in man.metrics("vit_tiny.t_step_b2", True)][-1] == "window_calls.train"
    assert man.reader("window_calls.train").read.__module__ == "gpubench.metrics.window_calls.train"


@pytest.mark.parametrize("cell", ["vit_tiny.t_step", "vit_tiny.t_step_b2", "resnet_tiny.t_fused"])
def test_a_traced_run_on_the_cpu_reports_what_it_can_read(root, cell):
    res = run.run_cell(Manifest(root), cell, 2 ** 31 + 11, 0.3, True, "cpu")
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(res)[-1] == "checks" and set(res["checks"]) <= set(check.NUMBERS)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    # no device number is read off the card; the new metric is, where listed
    expect = {"window_calls.train"} if cell.startswith("vit") else set()
    assert set(res["metrics"]) == expect
    if expect:
        assert res["metrics"]["window_calls.train"]["unit"] == "calls"


def test_an_untraced_run_reports_the_end_to_end_metrics_it_can_read(root):
    res = run.run_cell(Manifest(root), "vit_tiny.t_step_b2", 5, 0.3, False, "cpu",
                       clock=lambda: 1.5)
    assert res["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    assert res["metrics"]["images_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"setup_s", "images_per_s"}  # p90 and memory are the card's
