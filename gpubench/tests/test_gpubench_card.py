"""On the card, at each real cell's own size: the program's compared steps
pass their limits and the control's do not (skips without a card; on the
chip: ``python3 -m pytest gpubench/tests/test_gpubench_card.py -q``)."""

import json
from pathlib import Path

import pytest
import torch

from gpubench import calibrate, check, run
from gpubench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(card, cell):
    man = Manifest(ROOT)
    w = man.workload(cell)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    model, entry = man.model(w["config"]), man.entry(traffic["entry"])
    prog = calibrate.program_record(man, w, 1234, card, "program")
    torch.cuda.empty_cache()
    ref = run.reference_record(model, entry, cfg, traffic, 1234, card)
    control = run.reference_record(model, entry, cfg, traffic, 1234, card, precision="fp8")
    limits = man.limits(cell)
    assert check.judge(check.compare(prog, ref), limits)
    assert not check.judge(check.compare(control, ref), limits)
