"""``correct`` fails where it must: the control (the reference put in the
program's place at fp8, the precision below the configurations' bf16) and
the planted faults of a training cell (a step that leaves its state
unchanged; half of each batch left out of the loss, the mean taken over the
rest), each in a run on the CPU with the chip's look skipped, at a size a
test run holds, against the limits of the real cell. At that size the
unbroken program's gaps are not the real cell's, so it is held to the
separation the limits rest on instead: its first gradient's gap at least
three times under the control's. (One card, no exchange between cards to
leave out; a training step answers with its state and loss, which these
numbers read.)"""

import pytest

from gpubench import calibrate, check, run
from gpubench.manifest import Manifest
from tiny import CELLS, tiny_root

SEEDS = (2 ** 31 + 3, 17)


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    return Manifest(tiny_root(tmp_path_factory.mktemp("bench")))


GRADIENT = {"vit_tiny.t_step": "grad_gap", "resnet_tiny.t_fused": "grad_gap_median"}


def _records(man, cell, seed):
    w = man.workload(cell)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    model, entry = man.model(w["config"]), man.entry(traffic["entry"])
    ref = run.reference_record(model, entry, cfg, traffic, seed, "cpu")
    control = run.reference_record(model, entry, cfg, traffic, seed, "cpu", precision="fp8")
    return ref, control


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_unbroken_program_reads_well_under_the_control(man, cell, seed):
    res = run.run_cell(man, cell, seed, 0.2, False, "cpu")
    ref, control = _records(man, cell, seed)
    key = GRADIENT[cell]
    program = calibrate.program_record(man, man.workload(cell), seed, "cpu", "program")
    assert 3 * check.compare(program, ref)[key] <= check.compare(control, ref)[key]
    assert res["attempted"] > 0 and set(res["checks"]) == set(man.limits(cell))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(man, cell, fault):
    with calibrate.fault(fault):
        res = run.run_cell(man, cell, SEEDS[0], 0.2, False, "cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(man, cell, seed):
    ref, control = _records(man, cell, seed)
    numbers = check.compare(control, ref)
    assert not check.judge(numbers, man.limits(cell)), numbers
