"""``BENCHMARK.json`` against the rules of its contract, and every file it
names present: the names and units in the allowed characters, each metric
with its direction, source, ``workloads`` and (per layer) its ``layer``
and ``moves``, the bounds, the run length within the check's budget, and a
reader, a traffic file, an entry and a limits file for every piece."""

import json
import re
from pathlib import Path

import pytest

from gpubench import check
from gpubench.manifest import NAME, UNIT, Manifest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_command_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert all(LINE.match(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in MAN["command"]:
        if "/" in word:  # a file the command names lies under paths
            assert any(word.startswith(p + "/") for p in MAN["paths"]), word
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[key]]
    names += [w["config"] for w in MAN["workloads"]] + [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in MAN[key]]
        assert len(seen) == len(set(seen)), key
    assert len(set(e["name"] for e in METRICS)) == len(METRICS)


def test_configs_and_cells():
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(CELLS) // 4)
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"


def test_metrics_keys_sources_and_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # each cell it reads reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in METRICS:
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS) and m.get("workloads", CELLS)
    # setup_s is every cell's, those that later PRs add too: it lists none
    assert "workloads" not in e2e["setup_s"]
    for cell in CELLS:  # another end-to-end metric and a per-layer one in every cell
        assert any(cell in m["workloads"] for m in MAN["end_to_end"] if m["name"] != "setup_s")
        assert any(cell in m["workloads"] for m in MAN["per_layer"])


def test_one_layer_name_per_layer_and_mfu_beside_the_rooflines():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers == {"train step", "device", "attention", "optimizer"}
    mfu = [m for m in MAN["per_layer"] if "mfu" in m["name"]]
    for m in MAN["per_layer"]:
        if "roofline" in m["name"]:
            assert any(set(m["workloads"]) <= set(f["workloads"]) and f["moves"] == m["moves"]
                       for f in mfu)


def test_the_run_length_fits_the_check_with_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_its_name(cell):
    man = Manifest(ROOT)
    w = man.workload(cell)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    model, entry = man.model(w["config"]), man.entry(traffic["entry"])
    assert callable(model.weight_specs) and callable(model.port_model)
    assert hasattr(entry, "System") and callable(entry.reference_batches)
    assert set(man.limits(cell)) <= set(check.NUMBERS)
    for m in man.metrics(cell, False) + man.metrics(cell, True):
        assert callable(man.reader(m["name"]).read)
    specs = model.weight_specs(cfg, traffic)
    assert len({n for n, _, _ in specs}) == len(specs)


def test_the_configurations_count_their_published_parameters():
    man = Manifest(ROOT)
    for c in MAN["configs"]:
        cfg = man.config(c["name"])
        traffic = {"image_size": cfg["image_size"]}
        n = sum(_numel(shape) for _, shape, _ in man.model(c["name"]).weight_specs(cfg, traffic))
        assert n == cfg["params"], c["name"]


def _numel(shape):
    out = 1
    for s in shape:
        out *= s
    return out
