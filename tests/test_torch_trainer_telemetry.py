"""The port trainer's live telemetry (``heartbeat_file``, ``metrics_file``,
``metrics_port``, ``alert_rules``; ``tpu_dist_torch/train/trainer.py``)
held against the JAX trainer's (``tpu_dist/train/trainer.py:249-259``,
``:1672-1684``, ``:1853``, ``:2802-2860``, ``:2886``).

The same runs (the JAX chaos tests' configuration, 2 epochs of 3 steps)
go through both trainers, every ``Heartbeat.beat`` call recorded: a clean
streaming run with every flag, a run stopped by ``sigterm@epoch=1:step=1``
and a fused run. Held:

* the beats in order (``start``, one a step, ``preempted``; once an epoch
  on the fused path) and the heartbeat file's record keys; the file is
  swept on a clean exit and stays, reading ``preempted``, after a SIGTERM;
  on two gloo ranks each rank beats its own ``per_rank_path`` file;
* the metric names of the last exposition, but for the families only one
  package has (listed by name below, with the reasons);
* the alert rules of one spec: the same rules load, the same ones fire at
  the same epochs and steps (the ``alert`` history records), and their
  ``alert_active`` gauges;
* ``metrics_port``: refused out of range before any model or data work,
  and during a run rank 0 answers an HTTP scrape.
"""

import json
import os
import socket
import sys
import urllib.request

import pytest
from torch_ranks import fit_run, free_port, narrow_resnet, run_ranks

from tests.helpers import TinyMLP
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.obs import alerts as jax_alerts
from tpu_dist.obs import heartbeat as jax_heartbeat
from tpu_dist.resilience import faults as jax_faults
from tpu_dist.resilience import preemption as jax_preemption
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.obs import alerts, export, flight, heartbeat, spans
from tpu_dist_torch.resilience import faults, preemption
from tpu_dist_torch.resilience.preemption import PreemptedError
from tpu_dist_torch.train import trainer

jax_trainer.register_model("tiny_mlp_telemetry",
                           lambda num_classes=10: TinyMLP(num_classes, width=16, in_dim=3072))
trainer.register_model("narrow_resnet", narrow_resnet)

RUN = dict(dataset="synthetic", num_classes=10, batch_size=64, epochs=2, steps_per_epoch=3,
           log_every=1, eval_every=1, save_every=1, synthetic_n=256, seed=0, num_workers=1)
RULES = {"rule": [
    # the step-fetch grain and the epoch grain both see the loss
    {"name": "loss_seen", "metric": "loss", "op": ">", "threshold": -1.0, "sustain": 2,
     "cooldown": 1},
    # a counter's change over an epoch (the delta rules)
    {"name": "steps_moved", "metric": "train.steps", "op": ">", "threshold": 0.0,
     "delta": True},
    {"name": "stall_seen", "metric": "data_stall_frac", "op": ">=", "threshold": 0.0},
    {"name": "never", "metric": "loss", "op": "<", "threshold": -1.0},
]}

# The metric families of the last exposition of the clean run that only
# one package has. The first step's memory waterfall (mem.xla_*): the port's
# allocator measures it around the first step on the card, and the CPU has
# no allocator counters (chip_smoke.py phase 14 (a) checks it there); and
# mem.xla_code_bytes, the compiled program's code, which the port never
# has (no XLA program). The cost model's, the ledger's, the compile, wire
# and loader gauges, the elastic world gauge and the goodput ledger's
# gauges are in both.
JAX_ONLY = {
    "mem_xla_argument_bytes", "mem_xla_output_bytes", "mem_xla_peak_bytes",
    "mem_xla_temp_bytes",
    "mem_xla_code_bytes",
}
# The port's own counts, which the JAX trainer does not keep: its
# collectives by kind (comm/collectives.py) and the eval's real examples.
PORT_ONLY = {
    "comm_all_reduce_bn", "comm_all_reduce_bn_grad", "comm_all_reduce_eval",
    "comm_all_reduce_grad", "comm_all_reduce_metrics", "eval_examples",
}


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, jax_faults):
        mod.clear()
    preemption.clear()
    jax_preemption.clear()
    yield
    for mod in (faults, jax_faults):
        mod.clear()
    preemption.clear()
    jax_preemption.clear()


def _record_beats(monkeypatch, cls, beats):
    inner = cls.beat

    def beat(self, **kw):
        beats.append((os.path.basename(self.path), kw.get("phase", "train"), kw.get("epoch"),
                      kw.get("step")))
        return inner(self, **kw)

    monkeypatch.setattr(cls, "beat", beat)


def _runs(root, make, error_types, hb_cls):
    """The three runs of the module docstring through one package's trainer
    (``make(**cfg)`` builds and fits it); returns, per run, the recorded
    beats, the error raised, and what the run left on disk."""
    rules = os.path.join(root, "rules.json")
    with open(rules, "w") as f:
        json.dump(RULES, f)
    out = {}
    for name, kw in (
            ("clean", dict(metrics_file="m.prom", alert_rules=rules, log_file="h.jsonl",
                           ckpt_dir="ck")),
            ("sigterm", dict(fault_plan="sigterm@epoch=1:step=1", ckpt_dir="ck")),
            ("fused", dict(fused_epoch=True, steps_per_epoch=None, eval_every=0))):
        d = os.path.join(root, name)
        os.makedirs(d)
        kw = {k: (os.path.join(d, v) if k in ("metrics_file", "log_file", "ckpt_dir") else v)
              for k, v in kw.items()}
        beats = []
        mp = pytest.MonkeyPatch()
        _record_beats(mp, hb_cls, beats)
        err = None
        try:
            make(**{**RUN, **kw}, heartbeat_file=os.path.join(d, "hb.json"))
        except error_types as e:
            err = type(e).__name__
        finally:
            mp.undo()
        hb = os.path.join(d, "hb.json")
        rec = None
        if os.path.exists(hb):
            with open(hb) as f:
                rec = json.load(f)
        expo = None
        if "metrics_file" in kw:
            with open(kw["metrics_file"]) as f:
                expo = export.parse(f.read())
        alerts_logged = []
        if "log_file" in kw:
            with open(kw["log_file"]) as f:
                alerts_logged = [json.loads(line) for line in f if '"alert"' in line]
        out[name] = dict(beats=beats, error=err, hb=rec, expo=expo, alerts=alerts_logged)
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    def make(**kw):
        t = jax_trainer.Trainer(JaxConfig(model="tiny_mlp_telemetry", **kw))
        t.fit()

    out = _runs(str(tmp_path_factory.mktemp("jax")), make,
                (jax_preemption.PreemptedError,), jax_heartbeat.Heartbeat)
    jax_faults.clear()
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    def make(**kw):
        t = trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu", port=free_port(),
                                        **kw))
        try:
            t.fit()
        finally:
            t.close()

    out = _runs(str(tmp_path_factory.mktemp("port")), make, (PreemptedError,),
                heartbeat.Heartbeat)
    faults.clear()
    return out


@pytest.mark.parametrize("run", ["clean", "sigterm", "fused"])
def test_the_beats_are_the_jax_trainers(jax_runs, port_runs, run):
    ours, theirs = port_runs[run], jax_runs[run]
    assert ours["error"] == theirs["error"]
    assert ours["beats"] == theirs["beats"]


def test_the_beat_sequences_are_what_the_contract_says(port_runs):
    steps = [("hb.json", "train", e, s) for e in range(2) for s in range(3)]
    assert port_runs["clean"]["beats"] == [("hb.json", "start", 0, None)] + steps
    assert port_runs["sigterm"]["beats"] == (
        [("hb.json", "start", 0, None)] + steps[:5] + [("hb.json", "preempted", 1, None)])
    # the fused path has no step grain: one beat an epoch
    assert port_runs["fused"]["beats"] == [("hb.json", "start", 0, None),
                                           ("hb.json", "fused_epoch", 0, None),
                                           ("hb.json", "fused_epoch", 1, None)]


def test_the_heartbeat_file_is_swept_on_a_clean_exit_and_kept_after_sigterm(
        jax_runs, port_runs):
    for run in ("clean", "fused"):
        assert port_runs[run]["hb"] is None and jax_runs[run]["hb"] is None
    ours, theirs = port_runs["sigterm"]["hb"], jax_runs["sigterm"]["hb"]
    assert set(ours) == set(theirs) == {"counter", "epoch", "step", "phase", "ts", "mono_s",
                                        "pid"}
    assert (ours["phase"], ours["epoch"], ours["counter"]) == (
        theirs["phase"], theirs["epoch"], theirs["counter"]) == ("preempted", 1, 7)
    assert ours["pid"] == os.getpid()


def test_the_exposition_has_the_jax_metric_names(jax_runs, port_runs):
    def names(vals):
        return {k.removeprefix(export.PREFIX) for k in vals}

    ours, theirs = names(port_runs["clean"]["expo"]), names(jax_runs["clean"]["expo"])
    assert ours - theirs == PORT_ONLY
    assert theirs - ours == JAX_ONLY
    for name in ("train_steps", "train_epochs", "heartbeat_beats", "heartbeat_age_s",
                 "train_loss", "train_epoch", "train_images_per_sec", "eval_top1",
                 "ckpt_writes", "alerts_fired", 'alert_active{rule="loss_seen"}',
                 "goodput_goodput_frac", "goodput_productive_s"):
        assert name in ours, name


def test_the_same_alert_rules_load_and_fire_as_in_jax(tmp_path, jax_runs, port_runs):
    spec = tmp_path / "rules.json"
    spec.write_text(json.dumps(RULES))
    for s in (str(spec), "default"):
        assert ([vars(r) for r in alerts.load_rules(s)]
                == [vars(r) for r in jax_alerts.load_rules(s)])

    def fired(run):
        return [(a["rule"], a["epoch"], a.get("step"), a["sustained"]) for a in run["alerts"]]

    ours = fired(port_runs["clean"])
    assert ours == fired(jax_runs["clean"])
    assert {r for r, *_ in ours} == {"loss_seen", "steps_moved", "stall_seen"}
    active = {k for k, v in port_runs["clean"]["expo"].items()
              if k.startswith("tpu_dist_alert_active") and v}
    assert active == {k for k, v in jax_runs["clean"]["expo"].items()
                      if k.startswith("tpu_dist_alert_active") and v}
    assert port_runs["clean"]["expo"]["tpu_dist_alerts_fired"] == len(ours)


@pytest.fixture
def no_work(monkeypatch):
    """The port trainer's first piece of work, the process group, fails the
    test if it is reached."""
    def reached(*a, **k):
        raise AssertionError("the trainer started work before refusing its config")

    monkeypatch.setattr(trainer.mesh, "initialize_distributed", reached)


@pytest.mark.parametrize("port", [-1, 65536])
def test_an_out_of_range_metrics_port_is_refused_before_any_work(no_work, port):
    cfg = dict(RUN, metrics_port=port)
    with pytest.raises(ValueError, match="metrics_port"):
        jax_trainer.Trainer(JaxConfig(model="tiny_mlp_telemetry", **cfg))
    with pytest.raises(ValueError, match="metrics_port"):
        trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu", **cfg))


def test_a_malformed_alert_spec_is_refused_before_any_work(no_work, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"rule": [{"name": "x", "metric": "loss", "op": "!"}]}))
    with pytest.raises(ValueError):
        jax_trainer.Trainer(JaxConfig(model="tiny_mlp_telemetry", **RUN, alert_rules=str(bad)))
    with pytest.raises(ValueError):
        trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu", **RUN,
                                    alert_rules=str(bad)))


def test_rank_0_answers_a_scrape_during_the_run(tmp_path):
    port = free_port()
    t = trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu", port=free_port(),
                                    **{**RUN, "eval_every": 0}, metrics_port=port))
    scraped = []
    inner = t.train_step

    def step(*a):
        if t.state.step == 2:  # two steps done: the exporter has published
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                scraped.append(export.parse(r.read().decode()))
        return inner(*a)

    t.train_step = step
    try:
        t.fit()
    finally:
        t.close()
    assert len(scraped) == 1 and scraped[0]["tpu_dist_loader_batches_consumed"] >= 1
    with pytest.raises(OSError):  # the endpoint stops with the run
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


def test_a_metrics_port_in_use_fails_fit_and_releases_what_it_armed(tmp_path):
    # the exporter cannot bind, after the flight ring and the start beat are
    # armed: fit raises, and the ring's hooks, its terminal record, the
    # faulthandler and the history are released all the same
    crash, log = tmp_path / "crash", tmp_path / "run.jsonl"
    with socket.socket() as busy:
        busy.bind(("", 0))
        busy.listen(1)
        t = trainer.Trainer(TrainConfig(
            model="narrow_resnet", device="cpu", port=free_port(), **{**RUN, "eval_every": 0},
            metrics_port=busy.getsockname()[1], crash_dir=str(crash), log_file=str(log),
            heartbeat_file=str(tmp_path / "hb.json")))
        hook = sys.excepthook  # the process group's, set up by the trainer
        try:
            with pytest.raises(OSError):
                t.fit()
        finally:
            t.close()
    assert sys.excepthook is hook and spans._OPEN_LISTENER is None
    assert t._flight is None and t._exporter is None and t._history is None
    ring = flight.decode(str(crash / flight.RING_NAME))["records"]
    assert [r["kind"] for r in ring[-2:]] == ["fatal", "exit"] and ring[-1]["clean"] is False
    assert heartbeat.read(str(tmp_path / "hb.json"))["phase"] == "start"  # a crash keeps it


def _two_rank_telemetry(rank, world, root, metrics_port):
    cfg = {**RUN, "model": "narrow_resnet", "device": "cpu", "eval_every": 0,
           "heartbeat_file": os.path.join(root, "hb.json"),
           "metrics_file": os.path.join(root, "m.prom"), "metrics_port": metrics_port,
           "fault_plan": "sigterm@epoch=0:step=1"}
    return fit_run(cfg)["error"]


def test_each_rank_beats_and_exports_its_own_file(tmp_path):
    got = run_ranks(_two_rank_telemetry, 2, str(tmp_path), free_port(), timeout=120)
    assert got == ["PreemptedError"] * 2
    for rank in range(2):
        hb = heartbeat.per_rank_path(str(tmp_path / "hb.json"), rank)
        with open(hb) as f:
            rec = json.load(f)
        assert (rec["phase"], rec["epoch"]) == ("preempted", 0)
        with open(heartbeat.per_rank_path(str(tmp_path / "m.prom"), rank)) as f:
            # start, steps 0 and 1, preempted
            assert export.parse(f.read())["tpu_dist_heartbeat_beats"] == 4
