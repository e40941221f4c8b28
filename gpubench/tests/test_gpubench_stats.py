"""The window's arithmetic: rates over all the work and all the time,
percentiles over every step, busy and idle time on the device's timeline,
and the reduction of a trace."""

import statistics
import time

import pytest
import torch

from gpubench import stats, trace, window


def test_quantile_is_numpys_linear_interpolation_over_every_value():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.quantile(xs, 0.0) == 1.0
    assert stats.quantile(xs, 1.0) == 5.0
    assert stats.quantile(xs, 0.5) == 3.0
    assert stats.quantile(xs, 0.9) == pytest.approx(4.6)
    # one slow step among 117 moves the p90 not at all, twelve move it
    steps = [256.0] * 117
    assert stats.quantile(steps[:-1] + [900.0], 0.9) == 256.0
    assert stats.quantile(steps[:-12] + [900.0] * 12, 0.9) > 256.0


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(195 * 256 * 3, 11.4) == pytest.approx(13136.84, rel=1e-6)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_busy_idle_and_gaps_on_overlapping_streams():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]  # two streams overlap at 1-2
    assert stats.merge(ivs) == [(0.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.busy(ivs, 0.0, 10.0) == pytest.approx(5.0)
    assert stats.gaps(ivs, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.idle_pct(ivs, 0.0, 10.0) == pytest.approx(50.0)
    assert stats.gaps([], 0.0, 4.0) == [(0.0, 4.0)]


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.0, 10.3]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


class _Sleeper:
    """A program whose calls take a known host time (the CPU window)."""

    steps_per_call = 1
    images_per_call = 8

    def __init__(self, seconds):
        self.seconds, self.calls = seconds, 0

    def call(self, i, steps=None):
        assert i == self.calls
        self.calls += 1
        time.sleep(self.seconds)
        return torch.full((1,), float(i))


def test_the_window_counts_every_call_and_times_each():
    prog = _Sleeper(0.02)
    w = window.measure(prog, 0.2, "cpu")
    assert w["calls"] == prog.calls == len(w["call_ms"]) == len(w["losses"]) == w["steps"]
    assert w["images"] == 8 * w["calls"]
    assert w["losses"] == [float(i) for i in range(w["calls"])]
    assert w["seconds"] >= 0.2
    assert all(c >= 19.0 for c in w["call_ms"])
    assert sum(w["call_ms"]) / 1e3 == pytest.approx(w["seconds"], rel=0.2)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_a_trace_reduces_to_busy_time_ops_and_the_hosts_idle_gaps():
    events = [
        _x(trace.WINDOW, "user_annotation", 100.0, 1000.0),
        _x(trace.WINDOW, "gpu_user_annotation", 100.0, 1000.0),  # a mirror: never counted
        _x("aten::mm", "cpu_op", 100.0, 50.0),
        _x("cudaLaunchKernel", "cuda_runtime", 120.0, 10.0),
        _x("gemm_kernel", "kernel", 200.0, 300.0),
        _x("gemm_kernel", "kernel", 450.0, 100.0),  # overlaps the first on another stream
        _x("cudaStreamSynchronize", "cuda_runtime", 600.0, 500.0),
        _x("Memcpy DtoD", "gpu_memcpy", 700.0, 100.0),
        _x("outside", "kernel", 1200.0, 50.0),
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx(450e-6)  # 200-550 and 700-800
    assert r["device_events"] == 4
    assert r["device_ops"] == [["gemm_kernel", pytest.approx(400e-6)],
                               ["Memcpy DtoD", pytest.approx(100e-6)],
                               ["outside", 0.0]]
    gaps = dict(r["idle_gaps"])
    # 100-200 (the launch's side: the mm is open at 150), 550-700 and 800-1100 (the sync)
    assert gaps["aten::mm"] == pytest.approx(100e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(450e-6)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.reduce([_x("k", "kernel", 0.0, 1.0)])
