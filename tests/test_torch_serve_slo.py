"""The port's SLO layer held against the JAX package's: the alert rules and
engine (``obs/alerts.py``), the exposition (``obs/export.py``), the
heartbeat (``obs/heartbeat.py``), the histogram plumbing and SLO rules of
``serve/slo.py``, the engine's ``slo_rules``/``history``/``exporter``/
``heartbeat_file``/``quantize`` arguments, and ``python -m
tpu_dist_torch.serve report``.

Host arithmetic and text compare exactly. Logits compare within
``LOGITS_TOL`` of ``tests/test_torch_serve.py``: f32 summation order
differs between XLA and PyTorch; the int8 engines dequantize to the same
f32 weights bit for bit (``tests/test_torch_quantize.py``) and then
differ in the same way only.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_ranks import child_env

from tpu_dist.metrics.history import MetricsHistory as JaxHistory
from tpu_dist.nn import vit as jax_vit
from tpu_dist.obs import alerts as jax_alerts
from tpu_dist.obs import counters as jax_counters
from tpu_dist.obs import export as jax_export
from tpu_dist.obs import heartbeat as jax_heartbeat
from tpu_dist.serve import __main__ as jax_cli
from tpu_dist.serve import engine as jax_engine
from tpu_dist.serve import slo as jax_slo
from tpu_dist.serve.drill import ManualClock
from tpu_dist_torch import bridge
from tpu_dist_torch.metrics.history import MetricsHistory
from tpu_dist_torch.nn import vit
from tpu_dist_torch.obs import alerts, counters, export, heartbeat
from tpu_dist_torch.serve import __main__ as cli
from tpu_dist_torch.serve import slo
from tpu_dist_torch.serve.engine import ServingEngine

SHAPE = (32, 32, 3)
LOGITS_TOL = dict(atol=2e-5, rtol=1e-5)  # f32, other summation order (test_torch_serve.py)


@pytest.fixture(autouse=True)
def _fresh_registries():
    counters.reset()
    jax_counters.reset()
    yield
    counters.reset()
    jax_counters.reset()


def _fields(rule) -> tuple:
    return (rule.name, rule.metric, rule.op, rule.threshold, rule.sustain,
            rule.cooldown, rule.delta, rule.profile)


# -- alert rules and the engine ------------------------------------------------


def test_builtin_libraries_are_the_jax_ones():
    assert {k: _fields(r) for k, r in alerts.BUILTIN_RULES.items()} == {
        k: _fields(r) for k, r in jax_alerts.BUILTIN_RULES.items()}
    assert {k: _fields(r) for k, r in slo.SLO_BUILTINS.items()} == {
        k: _fields(r) for k, r in jax_slo.SLO_BUILTINS.items()}
    assert [_fields(r) for r in slo.load_slo_rules("default")] == [
        _fields(r) for r in jax_slo.load_slo_rules("default")]


BAD_RULES = [
    dict(name="a", metric="m", op="!=", threshold=1.0),
    dict(name="a", metric="m", op=">", threshold="1"),
    dict(name="a", metric="m", op=">", threshold=True),
    dict(name="a", metric="m", op=">", threshold=1.0, sustain=0),
    dict(name="a", metric="m", op=">", threshold=1.0, sustain=1.5),
    dict(name="a", metric="m", op=">", threshold=1.0, cooldown=-1),
    dict(name="", metric="m", op=">", threshold=1.0),
]


@pytest.mark.parametrize("kw", BAD_RULES, ids=range(len(BAD_RULES)))
def test_rule_validation_matches_jax(kw):
    with pytest.raises(ValueError) as ours:
        alerts.AlertRule(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_alerts.AlertRule(**kw)
    assert str(ours.value) == str(theirs.value)


TOML_SPEC = """
# two rules and a builtin override
[[rule]]
name = "p99"
metric = "serve.latency_p99_ms"
op = ">"
threshold = 5
sustain = 2
cooldown = 1

[[rule]]
builtin = "slo_rps_low"
threshold = 50.0

[[rule]]
builtin = "stall_high"
delta = true
profile = false
"""

JSON_SPEC = {"rule": [
    {"name": "q", "metric": "serve.queue_depth", "op": ">=", "threshold": 3},
    {"builtin": "slo_availability_low", "threshold": 0.99, "cooldown": 0},
]}


def test_toml_and_json_specs_load_as_in_jax(tmp_path):
    toml, js = tmp_path / "r.toml", tmp_path / "r.json"
    toml.write_text(TOML_SPEC)
    js.write_text(json.dumps(JSON_SPEC))
    for spec in (str(toml), str(js)):
        assert [_fields(r) for r in slo.load_slo_rules(spec)] == [
            _fields(r) for r in jax_slo.load_slo_rules(spec)]
    # the minimal reader (interpreters without tomllib) parses the same
    assert alerts._parse_toml_minimal(TOML_SPEC, "r.toml") == \
        jax_alerts._parse_toml_minimal(TOML_SPEC, "r.toml")
    assert [_fields(r) for r in alerts.load_rules(str(js), slo.SLO_BUILTINS)] == [
        _fields(r) for r in jax_alerts.load_rules(str(js), jax_slo.SLO_BUILTINS)]


@pytest.mark.parametrize("bad", [
    "[[rule]]\nname = \"x\"\nmetric = \"m\"\nop = \">\"\nthreshold = 1\nfoo = 2\n",
    "[[rule]]\nbuiltin = \"nope\"\n",
    "[[rule]]\nname = \"x\"\nmetric = \"m\"\n",
    "[[rule]]\nname = \"x\"\nmetric = \"m\"\nop = \">\"\nthreshold = 1\n"
    "[[rule]]\nname = \"x\"\nmetric = \"n\"\nop = \">\"\nthreshold = 1\n",
], ids=["unknown_field", "unknown_builtin", "missing_fields", "duplicate"])
def test_malformed_specs_are_refused_as_in_jax(tmp_path, bad):
    path = tmp_path / "r.toml"
    path.write_text(bad)
    with pytest.raises(ValueError) as ours:
        slo.load_slo_rules(str(path))
    with pytest.raises(ValueError) as theirs:
        jax_slo.load_slo_rules(str(path))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError):
        alerts.load_rules("rules.yaml")


def _windows(seed: int, n: int = 60) -> list:
    """Windows with the serve metrics breaching and clearing at random, a
    monotonic counter for the delta rules, and metrics that go missing."""
    rng = np.random.default_rng(seed)
    out, retraces = [], 0.0
    for _ in range(n):
        retraces += float(rng.integers(0, 2))
        w = {
            "serve.latency_p99_ms": float(rng.choice([10.0, 600.0, 900.0])),
            "serve.latency_p50_ms": float(rng.choice([5.0, 150.0])),
            "serve.ttfb_p99_ms": float(rng.choice([1.0, 300.0])),
            "serve.availability": float(rng.choice([1.0, 0.5])),
            "serve.requests_per_s": float(rng.choice([0.5, 100.0])),
            "serve.queue_depth": int(rng.integers(0, 100)),
            "compile.retraces": retraces,
            "data_stall_frac": float(rng.random()),
            "mfu": True,  # a bool is never a measurement
        }
        for k in list(w):
            if rng.random() < 0.2:
                del w[k]
        out.append(w)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_alert_engine_fires_what_jax_fires(seed, tmp_path):
    spec = tmp_path / "r.toml"
    spec.write_text(TOML_SPEC)

    def merged(load):  # the spec's rules replace the builtins of their names
        mine = load(str(spec))
        names = {r.name for r in mine}
        return [r for r in load("default") if r.name not in names] + mine

    rules, jrules = merged(slo.load_slo_rules), merged(jax_slo.load_slo_rules)
    ours, theirs = alerts.AlertEngine(rules), jax_alerts.AlertEngine(jrules)
    ours.seed_deltas({"compile.retraces": 0})
    theirs.seed_deltas({"compile.retraces": 0})
    fired = 0
    for w in _windows(seed):
        a, b = ours.observe(w), theirs.observe(w)
        assert a == b
        assert ours.active() == theirs.active()
        fired += len(a)
    assert fired and ours.fired_total == theirs.fired_total == fired
    with pytest.raises(ValueError):
        alerts.AlertEngine(rules + rules[:1])


# -- histograms ---------------------------------------------------------------


def _hist_pair(values):
    ours, theirs = slo.LatencyHistogram(), jax_slo.LatencyHistogram()
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    return ours, theirs


def test_histogram_merge_serialize_and_openmetrics_match_jax():
    rng = np.random.default_rng(3)
    a, ja = _hist_pair(rng.exponential(0.01, 50))
    b, jb = _hist_pair(list(rng.exponential(1.0, 30)) + [1e9])
    a.merge(b)
    ja.merge(jb)
    assert a.to_dict() == ja.to_dict()
    assert a.to_openmetrics() == ja.to_openmetrics()
    back = slo.LatencyHistogram.from_dict(json.loads(json.dumps(a.to_dict())))
    assert back.to_dict() == a.to_dict()
    empty = slo.LatencyHistogram()
    empty.merge(slo.LatencyHistogram())
    assert empty.to_dict() == jax_slo.LatencyHistogram().to_dict()
    with pytest.raises(ValueError, match="bucket layouts"):
        a.merge(slo.LatencyHistogram(edges=(1.0, 2.0)))
    with pytest.raises(ValueError, match="out of range"):
        slo.LatencyHistogram.from_dict({"edges": 22, "buckets": {"-1": 3}})
    with pytest.raises(ValueError, match="edges"):
        slo.LatencyHistogram.from_dict({"edges": 5})


# -- the exposition -----------------------------------------------------------


def _snapshot():
    a, _ = _hist_pair([0.001, 0.02, 0.5])
    values = {"serve.requests": 12, "serve.latency_p99_ms": 12.8, "train.epoch": 2.0,
              "serve.device": "cuda:0", "flag": True, "3d.odd-name": 1.5}
    labeled = {"alert_active": {"slo_p99_high": 1.0, 'we"ird\\': 0.0}}
    return values, labeled, {"serve.latency_seconds": a.to_openmetrics()}


def test_render_equals_jax_byte_for_byte_and_parses_back():
    values, labeled, hists = _snapshot()
    text = export.render(values, labeled, histograms=hists)
    assert text == jax_export.render(values, labeled, histograms=hists)
    assert export.render(values, labeled, {"alert_active": "run"}) == jax_export.render(
        values, labeled, {"alert_active": "run"})
    parsed = export.parse(text)
    assert parsed == jax_export.parse(text)
    assert parsed[export.metric_name("serve.requests")] == 12
    assert parsed['tpu_dist_serve_latency_seconds_bucket{le="+Inf"}'] == 3
    assert export.active_labels(parsed) == jax_export.active_labels(parsed) == ["slo_p99_high"]
    assert export.key_gauges(parsed) == jax_export.key_gauges(parsed)
    for raw in ("ckpt.bytes_written", "3d.odd-name", "a:b"):
        assert export.metric_name(raw) == jax_export.metric_name(raw)


def test_exporter_serves_http_and_writes_the_textfile(tmp_path):
    values, labeled, hists = _snapshot()
    textfile = str(tmp_path / "m" / "metrics.prom")
    ex = export.MetricsExporter(textfile=textfile, port=0, host="127.0.0.1")
    try:
        assert ex.port and ex.port > 0
        assert export.scrape(port=ex.port) == {}  # the empty exposition: "# EOF"
        assert ex.update(values, labeled, histograms=hists, force=True)
        assert not ex.update(values, labeled, histograms=hists)  # inside the throttle window
        want = export.parse(export.render(values, labeled, histograms=hists))
        assert export.scrape(port=ex.port) == want
        assert export.scrape(textfile=textfile) == want
        assert counters.get("export.scrapes") == 2
    finally:
        ex.close()
    assert export.scrape(port=ex.port, timeout=0.5) is None  # closed
    assert export.scrape(textfile=str(tmp_path / "absent")) is None
    with pytest.raises(ValueError, match="rank-0-only"):
        export.MetricsExporter(port=0, rank=1)


# -- the heartbeat --------------------------------------------------------------


def test_heartbeat_writes_reads_and_sweeps_like_jax(tmp_path):
    base = str(tmp_path / "hb" / "beat")
    for rank in (0, 3):
        assert heartbeat.per_rank_path(base, rank) == jax_heartbeat.per_rank_path(base, rank)
    ours = heartbeat.Heartbeat(heartbeat.per_rank_path(base, 1), min_interval=60.0)
    theirs = jax_heartbeat.Heartbeat(jax_heartbeat.per_rank_path(base + "j", 1),
                                     min_interval=60.0)
    for hb in (ours, theirs):
        assert hb.beat(epoch=1, step=5, phase="serve")
        assert not hb.beat(step=6)  # throttled: counted, not written
        assert hb.beat(step=7, force=True)
    a, b = heartbeat.read(ours.path), jax_heartbeat.read(theirs.path)
    wall = ("ts", "mono_s", "pid")
    assert {k: v for k, v in a.items() if k not in wall} == {
        k: v for k, v in b.items() if k not in wall} == {
        "counter": 3, "epoch": None, "step": 7, "phase": "train"}
    assert 0 <= ours.age() < 60 and counters.get("heartbeat.beats") == 3
    with open(ours.path, "w") as f:
        f.write('{"counter": ')  # a torn read returns the last good beat
    assert heartbeat.read(ours.path) == a and counters.get("heartbeat.torn_reads") == 1
    ours.sweep()
    assert heartbeat.read(ours.path) is None and not os.path.exists(ours.path)


def test_sweep_stale_ranks_matches_jax(tmp_path):
    def lay(d):
        d.mkdir()
        for name in ("beat", "beat.h1", "beat.h2", "beat.h3.tmp", "beat.h7", "beat.hx",
                     "other.h5"):
            (d / name).write_text("x")
        return sorted(p.name for p in d.iterdir())

    a, b = tmp_path / "a", tmp_path / "b"
    assert lay(a) == lay(b)
    assert heartbeat.sweep_stale_ranks(str(a / "beat"), 2) == \
        jax_heartbeat.sweep_stale_ranks(str(b / "beat"), 2) == 3
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    assert heartbeat.sweep_stale_ranks(str(tmp_path / "absent" / "beat"), 1) == 0


# -- the engines, side by side on a manual clock ------------------------------------


@pytest.fixture(scope="module")
def weights():
    params, _ = jax_vit.vit_tiny().init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


ARRIVALS = [0.0, 0.0, 0.004, 0.005, 0.02, 0.021, 0.022, 0.05, 0.05, 0.05, 0.09,
            0.1, 0.11, 0.15, 0.151, 0.2, 0.21, 0.22]
TICKS = (0.0, 0.01, 0.03, 0.06, 0.1, 0.12, 0.16, 0.2, 0.25)
WALL = ("ts", "rel_s", "counters", "run_id")


def _replay(eng, payloads):
    """Ticks of arrivals and one pump each, a window every 2 ticks."""
    eng.warmup(SHAPE)
    eng.record_window()
    done, i = [], 0
    for n, t_tick in enumerate(TICKS):
        eng._clock.advance_to(t_tick)
        while i < len(ARRIVALS) and ARRIVALS[i] <= t_tick:
            eng.submit(payloads[i], id=i)
            i += 1
        done.extend(eng.pump())
        if n % 2 == 1:
            eng.record_window()
    done.extend(eng.drain())
    eng.record_window()
    return {r.id: r.result for r in done}


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in WALL} for r in recs
            if r["kind"] in ("serve", "alert")]


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_slo_history_replay_matches_the_jax_engine(tmp_path, weights, quantize):
    """The same requests on the same manual clock through both engines,
    each with the default SLO rules, a history and (int8) quantized
    weights: the same ``serve`` and ``alert`` records but for wall-clock
    fields, and logits within f32 summation-order tolerance."""
    payloads = np.random.default_rng(9).standard_normal(
        (len(ARRIVALS),) + SHAPE).astype(np.float32)
    step = 0.02  # every clock read costs 20 ms: p50/p99 ceilings breach
    jpath, opath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jh = JaxHistory(jpath)
    theirs = jax_engine.ServingEngine(
        jax_vit.vit_tiny(), jax.tree_util.tree_map(jnp.asarray, weights), {}, max_batch=4,
        quantize=quantize, deadline_s=0.5, slo_rules=jax_slo.load_slo_rules("default"),
        history=jh, clock=ManualClock(auto_step_s=step))
    t_done = _replay(theirs, payloads)
    jh.close()
    oh = MetricsHistory(opath)
    model = bridge.load_jax_vit(vit.vit_tiny(device="cpu"), weights)
    ours = ServingEngine(model, max_batch=4, quantize=quantize, deadline_s=0.5,
                         slo_rules="default", history=oh,
                         clock=ManualClock(auto_step_s=step), device="cpu")
    o_done = _replay(ours, payloads)
    oh.close()
    assert (ours.int8 is not None) == quantize
    assert counters.snapshot()["serve.quantized"] == ("int8" if quantize else "none")

    assert sorted(o_done) == sorted(t_done) == list(range(len(ARRIVALS)))
    for rid, got in o_done.items():
        np.testing.assert_allclose(got, np.asarray(t_done[rid]), **LOGITS_TOL)
    ours_recs, theirs_recs = _records(opath), _records(jpath)
    assert ours_recs == theirs_recs
    kinds = [r["kind"] for r in ours_recs]
    assert kinds.count("serve") == 6 and "alert" in kinds
    assert "slo_p50_high" in {r["rule"] for r in ours_recs if r["kind"] == "alert"}
    assert all("retraces" not in r for r in ours_recs)
    assert counters.get("serve.slo_alerts") == kinds.count("alert")


def test_engine_exporter_and_heartbeat(tmp_path, weights):
    """Each window refreshes the exposition (gauges, the alert states and
    the histogram families); every pump beats rank 2's heartbeat file,
    which ``sweep_heartbeat`` removes."""
    base = str(tmp_path / "hb")
    ex = export.MetricsExporter(port=0, host="127.0.0.1")
    try:
        eng = ServingEngine(bridge.load_jax_vit(vit.vit_tiny(device="cpu"), weights),
                            max_batch=4, slo_rules="default", exporter=ex,
                            heartbeat_file=base, rank=2, device="cpu",
                            clock=ManualClock(auto_step_s=0.2))
        assert eng.pump() == [] and os.path.exists(base + ".h2")  # an idle pump beats
        for p in np.zeros((6,) + SHAPE, np.float32):
            eng.submit(p)
        eng.drain()
        for _ in range(2):  # p50 sustained over 2 windows
            eng.record_window()
        vals = export.scrape(port=ex.port)
        assert vals[export.metric_name("serve.completed")] == 6
        assert vals['tpu_dist_serve_latency_seconds_count'] == 6
        for p in slo.PHASES:
            assert f"tpu_dist_serve_phase_{p}_seconds_count" in vals
        assert "slo_p50_high" in export.active_labels(vals)
        beat = heartbeat.read(base + ".h2")
        assert beat["phase"] == "serve" and beat["step"] == 1  # throttled after the first
        eng.set_shedding(True, "vacate")
        assert eng._shed_reason == "vacate" and not eng.submit(np.zeros(SHAPE)).ok
        eng.set_shedding(False, "ignored")
        assert eng._shed_reason == ""
        eng.sweep_heartbeat()
        assert not os.path.exists(base + ".h2")
    finally:
        ex.close()


# -- the report CLI -------------------------------------------------------------


def _history_with_serve_records(path):
    h = MetricsHistory(path)
    eng = ServingEngine(vit.vit_tiny(device="cpu"), max_batch=2, slo_rules="default",
                        history=h, deadline_s=0.05, device="cpu",
                        clock=ManualClock(auto_step_s=0.03))
    for _ in range(2):
        for p in np.zeros((3,) + SHAPE, np.float32):
            eng.submit(p)
        eng.drain()
        eng.record_window()
    h.log("serve", event="note")  # an event record is not a window
    h.close()
    with open(path, "a") as f:
        f.write('{"kind": "serve", "torn')  # a torn tail is tolerated


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_report_equals_the_jax_cli(tmp_path, capsys, fmt):
    path = str(tmp_path / "h.jsonl")
    _history_with_serve_records(path)
    assert cli.main(["report", path, "--format", fmt]) == 0
    ours = capsys.readouterr()
    assert jax_cli.main(["report", path, "--format", fmt]) == 0
    theirs = capsys.readouterr()
    assert ours.out == theirs.out
    if fmt == "text":
        assert "SLO ALERT" in ours.out
    else:
        report = json.loads(ours.out)
        assert report["n_windows"] == 2 and report["alerts"]


def test_report_exit_codes_equal_the_jax_cli(tmp_path, capsys):
    empty = tmp_path / "e.jsonl"
    empty.write_text(json.dumps({"kind": "train_epoch"}) + "\n")
    for argv, rc in ((["report", str(empty)], 1),
                     (["report", str(tmp_path / "absent.jsonl")], 2)):
        assert cli.main(argv) == jax_cli.main(argv) == rc
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli.main(["report"])
    assert e.value.code == 2


def test_report_runs_as_a_module_and_drill_and_replica_run(tmp_path, capsys):
    path = str(tmp_path / "h.jsonl")
    _history_with_serve_records(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.serve", "report", path],
                          cwd=root, env=child_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("serve report — 2 window(s)")
    work = str(tmp_path / "drill")
    assert cli.main(["drill", "--workdir", work, "--device", "cpu"]) == 0
    assert "serve-drill OK" in capsys.readouterr().out
    status = str(tmp_path / "status.jsonl")
    assert cli.main(["replica", "--ckpt", os.path.join(work, "ckpt"), "--workdir",
                     str(tmp_path / "replica"), "--status_file", status, "--device", "cpu",
                     "--serve_n", "4"]) == 0
    with open(status) as f:
        assert [json.loads(line)["event"] for line in f] == ["ready", "serving", "launches"]
