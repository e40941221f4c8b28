"""The port's serving path (``tpu_dist_torch.serve``) and its host
telemetry (``tpu_dist_torch.obs``), held against the JAX package's.

The engine runs ``vit_tiny`` on the CPU (``device="cpu"``). Replays on
the JAX package's ``ManualClock`` make every latency deterministic, so
the port's histograms must equal the JAX engine's bucket for bucket when
both serve the same request stream.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.nn import vit as jax_vit
from tpu_dist.obs import counters as jax_counters
from tpu_dist.serve import engine as jax_engine
from tpu_dist.serve import slo as jax_slo
from tpu_dist.serve.drill import ManualClock
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit
from tpu_dist_torch.obs import counters, spans
from tpu_dist_torch.serve import slo
from tpu_dist_torch.serve.engine import ServingEngine, batch_buckets, bucket_for

SHAPE = (32, 32, 3)
LOGITS_TOL = dict(atol=2e-5, rtol=1e-5)  # f32, other summation order


@pytest.fixture(autouse=True)
def _fresh_registries():
    counters.reset()
    jax_counters.reset()
    yield
    counters.reset()
    jax_counters.reset()
    spans.disable()


@pytest.fixture(scope="module")
def weights():
    params, _ = jax_vit.vit_tiny().init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _model(weights):
    model = vit.vit_tiny(device="cpu")
    return bridge.load_jax_vit(model, weights)


def _payloads(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n,) + SHAPE).astype(np.float32)


# -- registry, spans, histograms ---------------------------------------------


def test_counters_behave_like_the_jax_registry():
    for reg in (counters, jax_counters):
        reg.inc("a.x")
        reg.inc("a.x", 2.5)
        reg.set_gauge("a.g", "on")
        reg.set_gauge("a.x", "shadowed")  # counters win a name collision
    assert counters.snapshot() == jax_counters.snapshot() == {"a.x": 3.5, "a.g": "on"}
    assert counters.get("a.x") == 3.5 and counters.get("nope", -1) == -1
    counters.reset()
    assert counters.snapshot() == {}


def test_spans_record_only_when_enabled():
    with spans.span("off"):
        pass
    spans.add_event("off", 0.0, 1.0)
    assert spans.events() == []
    spans.enable()
    with spans.span("serve/outer", n=2):
        with spans.span("serve/inner"):
            pass
    spans.add_event("serve/timed", spans._T0 + 0.5, 0.25, bucket=4)
    evts = spans.events()
    assert [e["name"] for e in evts] == ["serve/inner", "serve/outer", "serve/timed"]
    assert evts[1]["args"] == {"n": 2} and evts[1]["ph"] == "X"
    assert evts[2]["ts"] == 500000.0 and evts[2]["dur"] == 250000.0
    json.dumps({"traceEvents": evts})  # a Chrome trace as it stands
    assert len(spans.drain()) == 3 and spans.events() == []
    assert spans.dropped() == 0
    spans.disable()
    assert not spans.enabled()


SAMPLES = [
    (0.0, 5e-5, 1e-4, 2e-4, 0.5),
    (0.001, 0.001, 0.001, 0.1, 1e9),
    tuple(np.random.default_rng(1).exponential(0.01, 200)),
]


@pytest.mark.parametrize("values", SAMPLES, ids=("edges", "overflow", "exponential"))
def test_latency_histogram_matches_jax(values):
    ours, theirs = slo.LatencyHistogram(), jax_slo.LatencyHistogram()
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    assert ours.to_dict() == theirs.to_dict()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert ours.quantile_bound(q) == theirs.quantile_bound(q)
    with pytest.raises(ValueError):
        ours.quantile_bound(1.5)
    with pytest.raises(ValueError):
        slo.LatencyHistogram(edges=(1.0, 0.1))
    assert slo.LatencyHistogram().quantile_bound(0.5) is None


def test_phases_and_edges_are_the_jax_ones():
    assert slo.PHASES == jax_slo.PHASES
    assert slo.DEFAULT_EDGES == jax_slo.DEFAULT_EDGES


@pytest.mark.parametrize("max_batch", (1, 4, 8, 16))
def test_bucket_ladder_matches_jax(max_batch):
    ladder = batch_buckets(max_batch)
    assert ladder == jax_engine.batch_buckets(max_batch)
    for n in range(1, max_batch + 1):
        assert bucket_for(n, ladder) == jax_engine.bucket_for(n, ladder)
    with pytest.raises(ValueError):
        bucket_for(max_batch + 1, ladder)


@pytest.mark.parametrize("max_batch", (0, 6))
def test_bucket_ladder_refuses_non_powers_of_two(max_batch):
    with pytest.raises(ValueError):
        batch_buckets(max_batch)


# -- the engine ----------------------------------------------------------------


def test_engine_buckets_padding_and_results_equal_direct_forward(weights):
    model = _model(weights)
    eng = ServingEngine(model, max_batch=4, device="cpu")
    assert eng.warmup(SHAPE) == 3 and counters.get("serve.forwards") == 3
    payloads = _payloads(15)
    done, i = [], 0
    for n in (1, 2, 3, 4, 4, 1):  # every bucket, a padded one among them
        for _ in range(n):
            eng.submit(payloads[i], id=i)
            i += 1
        batch = eng.pump()
        assert len(batch) == n and all(r.ok for r in batch)
        done.extend(batch)
    assert eng.pump() == []  # an empty queue is a no-op
    assert eng.stats.batches == 6 and eng.stats.padded_slots == 1  # 3 in a bucket of 4
    assert counters.get("serve.forwards") == 3 + 6
    with torch.inference_mode():
        direct = model(torch.from_numpy(payloads)).numpy()
    for r in done:
        assert r.result.shape == (10,)
        np.testing.assert_allclose(r.result, direct[r.id], **LOGITS_TOL)
    assert eng.stats.check_invariants() == []


def test_engine_phase_split_partitions_total(weights):
    eng = ServingEngine(_model(weights), max_batch=4, device="cpu",
                        clock=ManualClock(auto_step_s=0.001))
    eng.warmup(SHAPE)
    for _ in range(3):
        eng.submit(np.zeros(SHAPE, np.float32), arrival_s=0.0)
    for r in eng.pump():
        assert set(r.phase_s) == set(slo.PHASES)
        assert r.total_s == pytest.approx(sum(r.phase_s.values()), abs=1e-9)
        assert 0 <= r.ttfb_s <= r.total_s and r.phase_s["queue_wait"] >= 0
    # a future-dated arrival clamps consistently: the split still partitions
    eng.submit(np.zeros(SHAPE, np.float32), arrival_s=1e9)
    (late,) = eng.pump()
    assert late.phase_s["queue_wait"] == 0.0
    assert late.total_s == pytest.approx(sum(late.phase_s.values()), abs=1e-9)
    assert eng.stats.check_invariants() == []
    phase_sum = sum(h.sum for h in eng.stats.phases.values())
    assert phase_sum <= eng.stats.total.sum + 1e-9


def test_engine_shedding_and_queue_cap(weights):
    eng = ServingEngine(_model(weights), max_batch=2, max_queue=3, device="cpu")
    x = np.zeros(SHAPE, np.float32)
    admitted = [eng.submit(x) for _ in range(3)]
    refused = eng.submit(x)  # the queue is at its cap
    assert not refused.ok and refused.result is None and eng.queue_depth() == 3
    eng.set_shedding(True)
    assert eng.shedding and not eng.submit(x).ok
    assert counters.get("serve.shed") == 2 and eng.stats.shed == 2
    done = eng.drain()  # shedding stops admission, not the drain
    assert len(done) == 3 and all(r.ok for r in done) and eng.queue_depth() == 0
    assert {r.id for r in done} == {r.id for r in admitted}
    eng.set_shedding(False)
    assert eng.submit(x).ok is False and eng.queue_depth() == 1  # admitted, pending
    scalars = eng.record_window()
    assert scalars["serve.shed"] == 2 and scalars["serve.completed"] == 3
    assert scalars["serve.requests"] == 4
    assert counters.snapshot()["serve.completed"] == 3


def test_engine_record_window_publishes_gauges(weights):
    eng = ServingEngine(_model(weights), max_batch=4, device="cpu",
                        clock=ManualClock(auto_step_s=0.01))
    for p in _payloads(5):
        eng.submit(p)
    eng.drain()
    scalars = eng.record_window()
    snap = counters.snapshot()
    for key in ("serve.requests_per_s", "serve.latency_p50_ms", "serve.latency_p99_ms",
                "serve.batch_occupancy"):
        assert snap[key] == scalars[key]
    assert scalars["serve.batch_occupancy"] == pytest.approx((4 / 4 + 1 / 1) / 2)
    assert eng.record_window()["serve.requests_per_s"] == 0.0  # a fresh, empty window


def test_manual_clock_replay_matches_the_jax_engine(weights):
    """The same request stream on the same manual clock through the JAX
    engine and the port's: identical histograms, occupancy and queue
    depths (the engines read the clock at the same points), and logits
    within f32 tolerance."""
    arrivals = [0.0, 0.0, 0.004, 0.005, 0.02, 0.021, 0.022, 0.05, 0.05, 0.05, 0.09]
    payloads = _payloads(len(arrivals), seed=3)

    def replay(eng):
        eng.warmup(SHAPE)
        done, i = [], 0
        for t_tick in (0.0, 0.01, 0.03, 0.06, 0.1):
            eng._clock.advance_to(t_tick)
            while i < len(arrivals) and arrivals[i] <= t_tick:
                eng.submit(payloads[i], id=i)
                i += 1
            done.extend(eng.pump())
        done.extend(eng.drain())
        return eng, {r.id: r for r in done}, eng.record_window()

    jax_model = jax_vit.vit_tiny()
    theirs, t_done, t_scalars = replay(jax_engine.ServingEngine(
        jax_model, jax.tree_util.tree_map(jnp.asarray, weights), {}, max_batch=4,
        clock=ManualClock(auto_step_s=0.0005)))
    ours, o_done, o_scalars = replay(ServingEngine(
        _model(weights), max_batch=4, device="cpu", clock=ManualClock(auto_step_s=0.0005)))

    assert sorted(o_done) == sorted(t_done) == list(range(len(arrivals)))
    for rid, r in o_done.items():
        assert r.phase_s == pytest.approx(t_done[rid].phase_s, abs=1e-12)
        np.testing.assert_allclose(r.result, np.asarray(t_done[rid].result), **LOGITS_TOL)
    assert ours.stats.total.to_dict() == theirs.stats.total.to_dict()
    assert ours.stats.ttfb.to_dict() == theirs.stats.ttfb.to_dict()
    for p in slo.PHASES:
        assert ours.stats.phases[p].counts == theirs.stats.phases[p].counts
    assert ours.stats.queue_depth_max == theirs.stats.queue_depth_max
    assert ours.stats.occupancy_sum == pytest.approx(theirs.stats.occupancy_sum)
    assert o_scalars == t_scalars  # "_fired" included: no rules, 0 in both


def test_engine_without_gpu_needs_device_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(_model(weights))
