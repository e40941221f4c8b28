"""The no-op probes of ``tpu_dist_torch/analysis/noop_probes.py`` and the
step fingerprint they compare: every probe clean at a gloo world of one in
this process; each of six planted changes inside a step changes the
fingerprint while two fresh setups agree; a dead kit is a violation; and
TD111/TD112 at 4 ranks with the remapper fired."""

import contextlib

import pytest
import torch
import torch.distributed as dist
from torch_ranks import elastic_probe_rank, free_port, run_ranks

from tpu_dist_torch.analysis import noop_probes, step_audit
from tpu_dist_torch.comm import collectives, mesh
from tpu_dist_torch.obs import counters
from tpu_dist_torch.ops import fused_sgd


@pytest.fixture(scope="module")
def group():
    mesh.initialize_distributed("cpu", world_size=1, rank=0, master_port=free_port())
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name,probe", noop_probes.PROBES, ids=[n for n, _ in noop_probes.PROBES])
def test_every_probe_is_clean(group, name, probe):
    assert probe("cpu") == []


def _base():
    fn, args = step_audit._dp_setup("cpu")
    return fn, args, step_audit.step_fingerprint(fn, *args)


def test_two_fresh_setups_give_one_fingerprint(group):
    a, b = _base()[2], _base()[2]
    assert a == b
    assert "all-reduce c10d.allreduce_" in a  # the collectives are in it, by kind
    assert "launches fused_sgd.launches +0" in a  # and the kernels' launches (none here)


def _extra_op(fn, state, images, labels, lr):
    out = fn(state, images, labels, lr)
    images.sum()
    return out


def _dtype(fn, state, images, labels, lr):
    return fn(state, images.double(), labels, lr)


def _shape(fn, state, images, labels, lr):
    return fn(state, images[:4], labels[:4], lr)


def _item(fn, state, images, labels, lr):
    out = fn(state, images, labels, lr)
    out[1]["loss"].item()
    return out


def _all_reduce(fn, state, images, labels, lr):
    out = fn(state, images, labels, lr)
    collectives.all_reduce_(torch.zeros(1), kind="other")
    return out


def _launch(fn, state, images, labels, lr):
    out = fn(state, images, labels, lr)
    # on the CPU the wrapper runs its plain twin and counts nothing: one
    # launch is planted as the count the CUDA wrapper adds a launch
    fused_sgd.fused_sgd.launches += 1
    return out


@pytest.mark.parametrize("plant", [_extra_op, _dtype, _shape, _item, _all_reduce, _launch],
                         ids=["op", "dtype", "shape", "item", "all_reduce", "fused_sgd_launch"])
def test_a_planted_change_changes_the_fingerprint(group, plant):
    base = _base()[2]
    fn, args = step_audit._dp_setup("cpu")
    planted = step_audit.step_fingerprint(lambda *a: plant(fn, *a), *args)
    assert planted != base


def _two_reduces(x):
    collectives.all_reduce_(x, kind="grad")
    collectives.all_reduce_(x, kind="metrics")


@contextlib.contextmanager
def _fake_capture(monkeypatch):
    """A CUDA graph's capture as ``StepTrace`` and the counters see one on
    the CPU: the stream reports capturing and the increments are deferred
    (``train/epoch.py::_GraphLoop._capture``). Yields the increments a
    replay adds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    try:
        with counters.deferred() as replay:
            yield replay
    finally:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def test_a_captured_steps_replays_are_booked(group, monkeypatch):
    x = torch.zeros(4)
    with step_audit.StepTrace() as trace:
        _two_reduces(x)  # an eager step
        with _fake_capture(monkeypatch) as replay:
            _two_reduces(x)  # booked as the graph's, runs nothing
        for _ in range(2):
            counters.add_all(replay)  # the epoch's bookkeeping of a replay
    counts = step_audit._counts(trace)
    # 1 eager step + 2 replays, 2 all-reduces each; the capture itself none
    assert counts["collectives"] == {"psum": 6}
    assert "calls all_reduce.grad +3" in trace.fingerprint()


def test_a_replay_of_a_graph_captured_outside_the_trace_raises(group, monkeypatch):
    with _fake_capture(monkeypatch) as replay:
        _two_reduces(torch.zeros(4))
    with pytest.raises(RuntimeError, match="captured before the trace opened"):
        with step_audit.StepTrace():
            counters.add_all(replay)


def _null_span(name, **args):
    return contextlib.nullcontext()


@pytest.mark.parametrize("probe,target,stub", [
    # spans that record nothing
    (noop_probes.telemetry_noop_violations, "tpu_dist_torch.obs.spans.span", _null_span),
    # a flight ring that records nothing
    (noop_probes.flight_recorder_noop_violations,
     "tpu_dist_torch.obs.flight.FlightRecorder.record", lambda self, kind, **fields: False),
    # an archive whose injected regression comes back uncaught
    (noop_probes.archive_gate_noop_violations, "tpu_dist_torch.obs.archive.inject_probe",
     lambda records, **kw: {"bands_probed": 0, "gate_probe": "missed",
                            "improvements_clean": False, "changepoint_probe": "missed"}),
], ids=["TD106", "TD113", "TD124"])
def test_a_dead_kit_is_a_violation(group, monkeypatch, probe, target, stub):
    monkeypatch.setattr(target, stub)
    vs = probe("cpu")
    assert vs and all("did not" in v.message or "VACUOUS" in v.message for v in vs)


def test_elastic_probes_at_4_ranks():
    for shrink, grow, vs in run_ranks(elastic_probe_rank, 4, timeout=120.0):
        # shrink 8 -> 4: padded_len(412, 8) = 416 != 412; grow 2 -> 4: the r1 rows
        assert shrink == (True, True, True)
        assert grow == (True, True, True)
        assert vs == []
