"""The port's trace export (``tpu_dist_torch/obs/spans.py::export_chrome_trace``,
``tpu_dist_torch/obs/summarize.py::export_trace``, ``python -m
tpu_dist_torch.obs export-trace`` and the trainer's ``--trace_file``) held
against the JAX package's (``tpu_dist/obs/spans.py:205-225``,
``tpu_dist/obs/summarize.py:811-861``, ``tpu_dist/train/trainer.py:3189-3235``).

* The recorder's Chrome trace is JAX's JSON for the same events (the
  buffered ones on a shared clock origin and the ones drained before, the
  dropped-event count in ``metadata``).
* A history's trace (the ``spans`` records and the synthesized epoch and
  eval bars, a resumed segment shifted past the first) is JAX's, through
  the function and through both CLIs.
* The same run through both trainers with ``--trace_file`` (the JAX chaos
  tests' configuration with a checkpoint and an eval each epoch) writes a
  trace of the same event names, and the same history record kinds.
"""

import json
import os

import pytest
from torch_ranks import fit_run, free_port

from tests.helpers import TinyMLP
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.obs import __main__ as jax_obs
from tpu_dist.obs import spans as jax_spans
from tpu_dist.obs import summarize as jax_summarize
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.obs import __main__ as obs
from tpu_dist_torch.obs import spans, summarize

jax_trainer.register_model("tiny_mlp_trace",
                           lambda num_classes=10: TinyMLP(num_classes, width=16, in_dim=3072))

RUN = dict(dataset="synthetic", num_classes=10, batch_size=64, epochs=2, steps_per_epoch=3,
           log_every=1, eval_every=1, save_every=1, synthetic_n=256, seed=0, num_workers=1)


@pytest.fixture
def recorders(monkeypatch):
    """Both recorders armed on one clock origin; disarmed after."""
    for mod in (spans, jax_spans):
        mod.enable()
        monkeypatch.setattr(mod, "_T0", 100.0)
    yield
    for mod in (spans, jax_spans):
        mod.disable()
        mod.drain()


def test_the_recorders_trace_is_jaxs(tmp_path, recorders, monkeypatch):
    drained = [{"name": "ckpt/restore_ladder", "ph": "X", "ts": 5.0, "dur": 2.5, "pid": 0,
                "tid": 7, "args": {"file": "ckpt_0.npz"}}]
    for mod in (spans, jax_spans):
        mod.add_event("train/dispatch", 100.25, 0.0125, step=3)
        mod.add_event("eval/validate", 101.5, 0.5, epoch=0)
    paths = [str(tmp_path / f"{n}.json") for n in ("port", "jax")]
    assert spans.export_chrome_trace(paths[0], extra_events=drained) == paths[0]
    jax_spans.export_chrome_trace(paths[1], extra_events=drained)
    ours, theirs = (json.load(open(p)) for p in paths)
    assert ours == theirs and [e["name"] for e in ours["traceEvents"]] == [
        "ckpt/restore_ladder", "train/dispatch", "eval/validate"]
    assert "metadata" not in ours
    # past the cap, events are dropped and counted in the trace
    for mod in (spans, jax_spans):
        monkeypatch.setattr(mod, "MAX_EVENTS", 3)
        for i in range(3):
            mod.add_event("loader/produce", 102.0 + i, 0.001, batch=i)
    assert spans.to_chrome_trace() == jax_spans.to_chrome_trace()
    assert spans.to_chrome_trace()["metadata"] == {"tpu_dist_dropped_events": 2}


def test_a_re_armed_recorder_keeps_its_buffer_and_origin(recorders):
    spans.add_event("a", 100.5, 0.1)
    spans.disable()
    spans.enable(fresh=False)
    spans.add_event("b", 101.0, 0.1)
    assert [(e["name"], e["ts"]) for e in spans.events()] == [("a", 500000.0), ("b", 1000000.0)]
    spans.enable(origin=101.0)
    spans.add_event("c", 101.5, 0.1)
    assert [(e["name"], e["ts"]) for e in spans.events()] == [("c", 500000.0)]


@pytest.fixture(scope="module")
def histories(tmp_path_factory):
    """The same configuration through both trainers with ``--trace_file``
    and ``--log_file``; then a resumed segment on the port's history."""
    d = str(tmp_path_factory.mktemp("trace"))
    out = {}
    for pkg in ("jax", "port"):
        kw = dict(RUN, trace_file=os.path.join(d, f"{pkg}.json"),
                  ckpt_dir=os.path.join(d, f"ck_{pkg}"), log_file=os.path.join(d, f"{pkg}.jsonl"))
        if pkg == "jax":
            jax_trainer.Trainer(JaxConfig(model="tiny_mlp_trace", **kw)).fit()
        else:
            assert fit_run(dict(kw, model="narrow_resnet", device="cpu", port=free_port()))[
                "error"] is None
        with open(kw["trace_file"]) as f:
            trace = json.load(f)
        with open(kw["log_file"]) as f:
            records = [json.loads(line) for line in f]
        out[pkg] = dict(trace=trace, records=records, log=kw["log_file"], kw=kw)
    kw = dict(out["port"]["kw"], epochs=3, resume=True, trace_file=None)
    assert fit_run(dict(kw, model="narrow_resnet", device="cpu", port=free_port()))[
        "error"] is None
    with open(kw["log_file"]) as f:
        out["resumed"] = [json.loads(line) for line in f]
    return out


def test_the_trainers_write_traces_of_the_same_event_names(histories):
    def names(run):
        return {e["name"] for e in run["trace"]["traceEvents"]}

    assert names(histories["port"]) == names(histories["jax"]) == {
        "train/compile+dispatch", "train/dispatch", "train/data_wait", "loader/produce",
        "eval/validate", "ckpt/write"}
    kinds = [[r["kind"] for r in histories[p]["records"]] for p in ("port", "jax")]
    assert kinds[0] == kinds[1] == ["memory"] + ["train_epoch", "spans", "eval", "goodput"] * 2 + [
        "goodput", "goodput", "spans"]
    # the trace holds every span the history's records drained
    drained = [e for r in histories["port"]["records"] if r["kind"] == "spans"
               for e in r["events"]]
    assert drained == histories["port"]["trace"]["traceEvents"]


def test_a_historys_trace_is_jaxs(histories, tmp_path, capsys):
    for records in (histories["port"]["records"], histories["jax"]["records"],
                    histories["resumed"]):
        assert summarize.export_trace(records) == jax_summarize.export_trace(records)
    resumed = summarize.export_trace(histories["resumed"])
    bars = [e for e in resumed["traceEvents"] if e["name"].startswith("train_epoch/")]
    assert [e["name"] for e in bars] == ["train_epoch/0", "train_epoch/1", "train_epoch/2"]
    assert bars[2]["ts"] >= bars[1]["ts"] + bars[1]["dur"]  # the resumed segment comes after
    log = histories["port"]["log"]  # both segments, after the resume
    out = str(tmp_path / "t.json")
    want = summarize.export_trace(histories["resumed"])
    capsys.readouterr()
    for main in (obs.main, jax_obs.main):
        assert main(["export-trace", log, "-o", out]) == 0
        with open(out) as f:
            assert json.load(f) == want
    assert capsys.readouterr().out.splitlines() == [
        f"wrote {len(want['traceEvents'])} event(s) to {out}"] * 2
    assert obs.main(["export-trace", log]) == 0  # default output beside the log
    assert os.path.exists(log + ".trace.json")
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    assert obs.main(["export-trace", empty]) == jax_obs.main(["export-trace", empty]) == 1
    assert obs.main(["export-trace", str(tmp_path / "missing.jsonl")]) == 2
