"""The port's triggered profiler (``tpu_dist_torch/obs/profile.py`` on
``torch.profiler``, and its wiring in the trainer) against the JAX
package's (``tpu_dist/obs/profile.py`` on ``jax.profiler``).

* ``parse_trigger`` and ``parse_steps``: the same results and the same
  errors, word for word, over a table of specs.
* Both ``TriggeredProfiler`` state machines, their capture backends
  stubbed, driven through the same ``arm`` / ``on_step`` / ``close``
  sequences (windows, cooldowns, the cap, a manual range, a close inside
  a window, a backend that fails): the same events and counters.
* A real CPU capture through the port's trainer and the JAX trainer on the
  same run (``--profile_steps 1:3``, and ``--profile_dir`` alone): a
  ``rank0.trace.json.gz``, the ``profile`` records at the same steps with
  the same fields, and a ``profile_analysis`` record whose categories sum
  to its busy seconds. The retrace trigger parses and never arms.
"""

import json
import os

import jax
import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)
from torch_ranks import free_port, narrow_resnet

from tests.helpers import TinyMLP
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.obs import counters as jax_counters
from tpu_dist.obs import profile as jax_profile
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.obs import counters, profile, xprof
from tpu_dist_torch.train import trainer

jax_trainer.register_model("tiny_mlp_profile", lambda num_classes=10: TinyMLP(num_classes,
                                                                             in_dim=3072))
trainer.register_model("narrow_resnet", narrow_resnet)

SPECS = ["off", "", None, "auto", "AUTO", " anomaly ", "anomaly,retrace", "straggler,",
         "anomaly,typo", "bogus"]
STEPS = [None, "", "3:7", "0:1", "7:3", "3", "a:b", "-1:2", "3:3", "1:2:3"]


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_parse_trigger_equals_jax(spec):
    assert _outcome(profile.parse_trigger, spec) == _outcome(jax_profile.parse_trigger, spec)
    assert profile.TRIGGER_KINDS == jax_profile.TRIGGER_KINDS


@pytest.mark.parametrize("spec", STEPS, ids=repr)
def test_parse_steps_equals_jax(spec):
    assert _outcome(profile.parse_steps, spec) == _outcome(jax_profile.parse_steps, spec)


def _stub(monkeypatch, fail_at=None):
    """Stub both packages' capture backends; the ``fail_at``-th start (from
    1) of each raises, as a missing profiler would."""
    calls = {"port": [], "jax": []}

    def starter(key):
        def start(d, **kw):
            calls[key].append(("start", d))
            if fail_at is not None and sum(c[0] == "start" for c in calls[key]) == fail_at:
                raise RuntimeError("profiler backend unavailable")
        return start

    monkeypatch.setattr(profile, "start_trace", starter("port"))
    monkeypatch.setattr(profile, "stop_trace", lambda: calls["port"].append(("stop",)))
    monkeypatch.setattr(jax.profiler, "start_trace", starter("jax"))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls["jax"].append(("stop",)))
    return calls


# each: the profiler's arguments, and the calls: ("arm", reason), ("step", n), ("close",)
SEQUENCES = {
    "window_cooldown_cap": (
        dict(window_steps=2, cooldown_steps=5, max_captures=2),
        [("step", 0), ("arm", "anomaly_loss_spike"), ("step", 1), ("step", 2), ("step", 3),
         ("arm", "straggler"), ("step", 4), ("step", 7), ("step", 8), ("step", 9),
         ("step", 10), ("arm", "anomaly_again"), ("arm", "x"), ("close",)]),
    "manual_once": (
        dict(window_steps=8, manual_range=(3, 5), max_captures=0),
        [("step", s) for s in range(12)]),
    "manual_longer_than_window": (
        dict(window_steps=3, manual_range=(2, 9), max_captures=0),
        [("step", s) for s in range(11)]),
    "manual_then_armed": (
        dict(window_steps=2, cooldown_steps=1, manual_range=(1, 3), max_captures=1),
        [("step", 0), ("step", 1), ("arm", "anomaly_nonfinite_loss"), ("step", 2),
         ("step", 3), ("step", 4), ("step", 5), ("step", 6), ("step", 7)]),
    "close_inside_a_window": (
        dict(window_steps=8, cooldown_steps=0, max_captures=2),
        [("arm", "anomaly"), ("step", 5), ("step", 6), ("step", 7), ("close",), ("close",)]),
    "arm_while_capturing": (
        dict(window_steps=3, cooldown_steps=0, max_captures=3),
        [("arm", "a"), ("step", 0), ("arm", "b"), ("step", 1), ("step", 2), ("step", 3),
         ("step", 4)]),
}


def _drive(prof, calls):
    out = []
    for c in calls:
        if c[0] == "arm":
            out.append(("arm", prof.arm(c[1]), prof.armed, prof.active))
        elif c[0] == "step":
            out.append(("step", prof.on_step(c[1]), prof.armed, prof.active))
        else:
            out.append(("close", prof.close(), prof.armed, prof.active))
    return out


def _profile_counters(snap):
    return {k: v for k, v in snap.items() if k.startswith(("profile.", "xprof."))}


@pytest.mark.parametrize("fail_at", [None, 1, 2], ids=["ok", "first_fails", "second_fails"])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_the_state_machines_give_jaxs_events(name, fail_at, tmp_path, monkeypatch):
    kw, seq = SEQUENCES[name]
    calls = _stub(monkeypatch, fail_at)
    counters.reset()
    jax_counters.reset()
    ours = _drive(profile.TriggeredProfiler(str(tmp_path), analyze=False, **kw), seq)
    theirs = _drive(jax_profile.TriggeredProfiler(str(tmp_path), analyze=False, **kw), seq)
    assert ours == theirs
    assert calls["port"] == calls["jax"]
    assert _profile_counters(counters.snapshot()) == _profile_counters(jax_counters.snapshot())


RUN = dict(dataset="synthetic", num_classes=10, batch_size=16, epochs=2, steps_per_epoch=3,
           synthetic_n=128, log_every=1, eval_every=0, seed=0)
EVENT_KEYS = ("event", "reason", "epoch", "step", "start_step", "stop_step", "steps",
              "window_steps", "aborted")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _runs(tmp_path, **kw):
    """The same run through both trainers; returns their records and
    directories."""
    out = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        cfg = dict(RUN, **kw, log_file=str(d / "h.jsonl"), profile_dir=str(d / "prof"))
        if pkg == "port":
            t = trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu",
                                            port=free_port(), **cfg))
            try:
                t.fit()
            finally:
                t.close()
        else:
            jax_trainer.Trainer(JaxConfig(model="tiny_mlp_profile", **cfg)).fit()
        out[pkg] = (_records(cfg["log_file"]), cfg["profile_dir"])
    return out


def _events(records):
    return [{k: r[k] for k in EVENT_KEYS if k in r} for r in records if r["kind"] == "profile"]


def _analyses(records):
    return [r for r in records if r["kind"] == "profile_analysis"]


def test_a_manual_capture_through_the_trainer(tmp_path):
    runs = _runs(tmp_path, profile_steps="1:3", profile_trigger="retrace")
    (ours, prof), (theirs, _) = runs["port"], runs["jax"]
    assert _events(ours) == _events(theirs) == [
        {"event": "start", "reason": "manual", "epoch": 0, "step": 1, "window_steps": 2},
        # the window closes before global step 3, the next epoch's first
        {"event": "stop", "reason": "manual", "epoch": 1, "start_step": 1, "stop_step": 3,
         "steps": 2}]
    cap = [r["dir"] for r in ours if r["kind"] == "profile"][0]
    assert os.path.isfile(os.path.join(cap, "rank0.trace.json.gz"))
    [pa] = _analyses(ours)
    [jpa] = _analyses(theirs)
    assert (pa["reason"], pa["steps"], pa["epoch"]) == (jpa["reason"], jpa["steps"],
                                                         jpa["epoch"]) == ("manual", 2, 1)
    assert pa["device_busy_s"] > 0 and pa.get("error") is None
    assert sum(pa["categories"].values()) == pytest.approx(pa["device_busy_s"], abs=1e-6)
    assert set(pa) - {"calibration"} >= set(jpa) - {"calibration"}
    # the capture holds the two steps' train_step ranges
    events = xprof.load_trace(os.path.join(cap, "rank0.trace.json.gz"))
    assert sum(e.get("name") == "train_step" and e.get("ph") == "X" for e in events) == 2
    # the retrace trigger parsed and never armed (eager torch does not retrace)
    assert counters.get("profile.armed") == 0 and counters.get("profile.captures") == 1
    assert counters.get("profile.errors") == 0 and counters.get("xprof.analyze_errors") == 0


def test_profile_dir_alone_captures_the_first_epoch(tmp_path):
    runs = _runs(tmp_path, epochs=1)
    (ours, prof), (theirs, _) = runs["port"], runs["jax"]
    assert _events(ours) == _events(theirs) == []
    assert os.path.isfile(os.path.join(prof, "rank0.trace.json.gz"))
    [pa] = _analyses(ours)
    [jpa] = _analyses(theirs)
    assert (pa["reason"], pa["steps"], pa["dir"]) == ("profile_dir", 3, prof)
    assert (jpa["reason"], jpa["steps"]) == ("profile_dir", 3)
    assert sum(pa["categories"].values()) == pytest.approx(pa["device_busy_s"], abs=1e-6)
    assert [r["kind"] for r in ours if r["kind"] in ("profile_analysis", "train_epoch")] == [
        r["kind"] for r in theirs if r["kind"] in ("profile_analysis", "train_epoch")]


def test_a_resumed_run_keeps_the_global_step_grid(tmp_path):
    """A run checkpoints its first epoch and a second process resumes it
    with the same ``--profile_steps 1:5``: the resumed grid starts at
    global step 3 (epoch 1, step 0), not at 0, so the window opens there,
    mid-range, and closes before global step 5, as in the JAX trainer."""
    events = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        for leg, kw in (("first", dict(epochs=1)), ("resumed", dict(epochs=2, resume=True))):
            cfg = dict(RUN, **kw, profile_steps="1:5", ckpt_dir=str(d / "ckpt"), save_every=1,
                       log_file=str(d / f"{leg}.jsonl"), profile_dir=str(d / f"prof_{leg}"))
            if pkg == "port":
                t = trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu",
                                                port=free_port(), **cfg))
                try:
                    t.fit()
                finally:
                    t.close()
            else:
                jax_trainer.Trainer(JaxConfig(model="tiny_mlp_profile", **cfg)).fit()
            events[pkg, leg] = _events(_records(cfg["log_file"]))
    assert events["port", "resumed"] == events["jax", "resumed"] == [
        {"event": "start", "reason": "manual", "epoch": 1, "step": 3, "window_steps": 4},
        {"event": "stop", "reason": "manual", "epoch": 1, "start_step": 3, "stop_step": 5,
         "steps": 2}]
    assert events["port", "first"] == events["jax", "first"]


def test_the_flags_are_refused_as_in_jax(tmp_path):
    for kw in (dict(profile_steps="1:3"), dict(profile_trigger="anomaly"),
               dict(profile_steps="1:3", profile_dir="p", fused_epoch=True,
                    steps_per_epoch=None)):
        errs = []
        for make in (lambda c: trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu",
                                                           port=free_port(), **c)),
                     lambda c: jax_trainer.Trainer(JaxConfig(model="tiny_mlp_profile", **c))):
            with pytest.raises(ValueError) as info:
                make({**RUN, **kw})
            errs.append(str(info.value))
        assert errs[0] == errs[1]
