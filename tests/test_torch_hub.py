"""The pod telemetry hub of the port (``tpu_dist_torch/obs/hub.py``: the
aggregator ``TelemetryHub``, ``HubServer``, ``parse_source``; the
``obs hub`` command; ``fleet/scheduler.py::signals_from_hub``) held against
the JAX package's on the same files:

* ``collect`` (the snapshot: every run's sample, the drops and their
  running totals, the fleet gauges, the rollups) and ``federated`` (the
  page) equal JAX's exactly, over runs whose expositions are whole, torn
  mid-write, missing, or lack a gauge the rollups read (the port's trainer
  publishes no ``train.mfu`` yet: a missing gauge is left out, never 0),
  with heartbeats fresh, stale or missing, over several passes (the last
  good parse a torn file serves, the running drop counts);
* ``parse_source`` and its refusals equal JAX's;
* ``signals_from_hub`` types a snapshot as JAX's does;
* ``python -m tpu_dist_torch.obs hub --once`` prints JAX's page byte for
  byte and exits as JAX's does; ``--out`` writes the same file; ``--archive``
  exits 2 naming the ROADMAP item it waits for;
* ``HubServer`` serves the last published page over HTTP.

Every comparison is exact (the same floats parsed from the same text).
"""

import json
import os
import urllib.request

import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.fleet import scheduler as jax_sched
from tpu_dist.obs import __main__ as jax_obs
from tpu_dist.obs import export as jax_export
from tpu_dist.obs import hub as jax_hub
from tpu_dist_torch.fleet import scheduler as sched
from tpu_dist_torch.obs import __main__ as obs
from tpu_dist_torch.obs import export, hub

NOW = 5000.0


def _pod(root, torn: bool = False) -> dict:
    """Four runs' files and the fleet exposition under ``root``: a trainer
    with every rollup gauge, a port-like trainer without ``train.mfu`` or a
    goodput gauge, a serving run firing an ``slo_*`` rule, and a run that
    has published nothing (its heartbeat stale). ``torn`` cuts the first
    trainer's file mid-write."""
    os.makedirs(root, exist_ok=True)
    p = {name: os.path.join(root, f"{name}.prom") for name in ("tr", "port", "svc", "ghost")}
    with open(p["tr"], "w") as f:
        f.write(jax_export.render({"train.data_stall_frac": 0.31, "goodput.goodput_frac": 0.8,
                                   "train.mfu": 0.44, "train.epoch": 3}))
    if torn:
        with open(p["tr"], "w") as f:
            f.write("tpu_dist_train_data_stall_frac 0.9\ntpu_dist_goodput_goo")
    with open(p["port"], "w") as f:
        f.write(export.render({"train.data_stall_frac": 0.05, "train.epoch": 1,
                               "train.steps": 12}))
    with open(p["svc"], "w") as f:
        f.write(jax_export.render({"serve.queue_depth": 7, "serve.availability": 0.9,
                                   "goodput.goodput_frac": 0.6},
                                  {"alert_active": {"slo_p99_latency": 1, "other": 0}}))
    fleet = os.path.join(root, "fleet.prom")
    with open(fleet, "w") as f:
        f.write(jax_export.render({"fleet.total_chips": 11, "fleet.free_chips": 1,
                                   "fleet.pending_chips": 0, "fleet.decisions": 4,
                                   "fleet.preemptions": 2, "fleet.last_decision_id": 3}))
    beats = {"tr": NOW - 2.0, "svc": NOW - 1.0, "ghost": NOW - 600.0}
    for name, ts in beats.items():
        with open(os.path.join(root, f"{name}.hb"), "w") as f:
            json.dump({"ts": ts, "counter": 1}, f)
    return {"files": p, "fleet": fleet, "root": root}


def _sources(mod, pod: dict, with_beats: bool = True) -> list:
    root, p = pod["root"], pod["files"]
    hb = (lambda n: os.path.join(root, f"{n}.hb")) if with_beats else (lambda n: None)
    return [mod.RunSource("tr", metrics_file=p["tr"], heartbeat_file=hb("tr")),
            mod.RunSource("port", metrics_file=p["port"]),
            mod.RunSource("svc", metrics_file=p["svc"], heartbeat_file=hb("svc"), kind="serve"),
            mod.RunSource("ghost", metrics_file=p["ghost"], heartbeat_file=hb("ghost"))]


@pytest.mark.parametrize("fleet", [True, False])
@pytest.mark.parametrize("with_beats", [True, False])
def test_collect_and_the_page_equal_jax_over_passes(tmp_path, fleet, with_beats):
    pod = _pod(str(tmp_path))
    kw = {"fleet_exposition": pod["fleet"] if fleet else None}
    ours = hub.TelemetryHub(_sources(hub, pod, with_beats), **kw)
    theirs = jax_hub.TelemetryHub(_sources(jax_hub, pod, with_beats), **kw)
    for torn in (False, True, False):  # a torn pass serves the last good parse
        _pod(str(tmp_path), torn=torn)
        a, b = ours.collect(now=NOW), theirs.collect(now=NOW)
        assert a == b
        assert ours.federated(a) == theirs.federated(b)
    assert ours.drops_total == theirs.drops_total
    assert ours.drops_total["torn"] == 1 and ours.drops_total["absent"] == 3
    rollup = a["rollup"]
    # the port-like trainer has no goodput gauge: the train mean is the
    # other trainer's alone, never averaged with a 0
    assert rollup["goodput_by_kind"] == {"serve": 0.6, "train": 0.8}
    assert rollup["breach_count"] == 1 and rollup["worst_stall_run"] == "tr"
    assert ("last_decision_id" in rollup) == fleet
    if with_beats:
        assert a["runs"]["ghost"]["dead"] and rollup["runs_dead"] == 1


def test_a_stale_hub_threshold_and_the_write_equal_jax(tmp_path):
    pod = _pod(str(tmp_path / "pod"))
    ours = hub.TelemetryHub(_sources(hub, pod), stale_after_s=1.5)
    theirs = jax_hub.TelemetryHub(_sources(jax_hub, pod), stale_after_s=1.5)
    a, b = ours.collect(now=NOW), theirs.collect(now=NOW)
    assert a == b and a["rollup"]["runs_dead"] == 2  # tr's 2 s beat is stale at 1.5
    ours.write(str(tmp_path / "out" / "ours.prom"), a)
    theirs.write(str(tmp_path / "out" / "theirs.prom"), b)
    assert ((tmp_path / "out" / "ours.prom").read_text()
            == (tmp_path / "out" / "theirs.prom").read_text())
    assert not [n for n in os.listdir(tmp_path / "out") if ".tmp." in n]


def test_labels_are_escaped_as_jax_escapes_them():
    for name, run in (("tpu_dist_x", 'we"ird\\run'), ('tpu_dist_a{rule="y"}', "r")):
        assert hub.TelemetryHub._labeled(name, run) == jax_hub.TelemetryHub._labeled(name, run)


def test_a_hub_refuses_what_jax_refuses(tmp_path):
    for sources in ([], [hub.RunSource("a", port=1), hub.RunSource("a", port=2)]):
        with pytest.raises(ValueError):
            hub.TelemetryHub(sources)
        with pytest.raises(ValueError):
            jax_hub.TelemetryHub([jax_hub.RunSource(**vars(s)) for s in sources])


@pytest.mark.parametrize("spec", [
    "tr=/p/tr.prom", "svc=/p/svc.prom,hb=/p/hb.json,kind=serve", "h=port:9100",
    "both=/p/m.prom,port=9101,hb=/p/hb", "=x.prom", "nothing", "a=x.prom,hb",
    "a=x.prom,color=red", "a=port:x", "a=x.prom,kind=batch", "a="])
def test_parse_source_equals_jax(spec):
    try:
        want = vars(jax_hub.parse_source(spec))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            hub.parse_source(spec)
        assert str(got.value) == str(e)
        return
    assert vars(hub.parse_source(spec)) == want


def test_signals_from_hub_equals_jax(tmp_path):
    pod = _pod(str(tmp_path))
    ours = sched.signals_from_hub(hub.TelemetryHub(_sources(hub, pod)).collect(now=NOW))
    theirs = jax_sched.signals_from_hub(
        jax_hub.TelemetryHub(_sources(jax_hub, pod)).collect(now=NOW))
    assert ours == {run: sched.RunSignals(**vars(sig)) for run, sig in theirs.items()}
    assert ours["svc"].queue_depth == 7 and ours["port"].goodput_frac is None
    assert sched.signals_from_hub({}) == {}


@pytest.mark.parametrize("argv", [
    ["--run", "tr={tr}", "--run", "svc={svc},kind=serve", "--fleet", "{fleet}"],
    ["--run", "ghost={ghost}"],
    ["--run", "tr={tr},hb={root}/tr.hb", "--stale-after", "0.001"],
])
def test_obs_hub_once_prints_the_jax_page(tmp_path, capsys, argv):
    pod = _pod(str(tmp_path))
    fmt = {**pod["files"], "fleet": pod["fleet"], "root": pod["root"]}
    args = ["hub", "--once", *(a.format(**fmt) for a in argv)]
    rc = obs.main(args)
    ours = capsys.readouterr()
    assert rc == jax_obs.main(args)
    theirs = capsys.readouterr()
    assert ours.out == theirs.out and ours.out.endswith("# EOF\n")
    assert rc == (1 if argv[1].startswith("ghost") else 0)


def test_obs_hub_out_and_refusals_exit_as_jax(tmp_path, capsys):
    pod = _pod(str(tmp_path))
    for tag, main in (("ours", obs.main), ("theirs", jax_obs.main)):
        assert main(["hub", "--once", "--run", f"tr={pod['files']['tr']}",
                     "--out", str(tmp_path / f"{tag}.prom")]) == 0
        assert capsys.readouterr().out.startswith("federated 1 run(s) to ")
    assert (tmp_path / "ours.prom").read_text() == (tmp_path / "theirs.prom").read_text()
    for argv in (["hub", "--once"], ["hub", "--once", "--run", "nothing"],
                 ["hub", "--once", "--run", "a=x", "--run", "a=y"]):
        assert obs.main(argv) == jax_obs.main(argv) == 2
    capsys.readouterr()


def test_obs_hub_archive_exits_2_naming_its_item(tmp_path, capsys):
    pod = _pod(str(tmp_path))
    assert obs.main(["hub", "--once", "--run", f"tr={pod['files']['tr']}",
                     "--archive", str(tmp_path / "a.jsonl")]) == 2
    err = capsys.readouterr().err
    assert "hub --archive is not ported" in err and "obs/archive.py" in err
    assert not (tmp_path / "a.jsonl").exists()


def test_hub_server_serves_the_last_published_page(tmp_path):
    pod = _pod(str(tmp_path))
    h = hub.TelemetryHub(_sources(hub, pod))
    with hub.HubServer(0, host="127.0.0.1") as server:
        url = f"http://127.0.0.1:{server.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.read() == b"# EOF\n"  # nothing published yet
        page = h.federated(h.collect(now=NOW))
        server.publish(page)
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.read().decode() == page
