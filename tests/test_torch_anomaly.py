"""The port's anomaly detector (``tpu_dist_torch/obs/anomaly.py``) against
the JAX package's (``tpu_dist/obs/anomaly.py``): both fed the same seeded
streams of (loss, grad_norm, nonfinite) observations give equal findings,
observation by observation (the same kinds at the same steps with the same
values, medians and ratios), including streams drawn by hypothesis. The
detector is host arithmetic on Python floats, so equal is exact."""

import math

import numpy as np
import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_dist.obs import anomaly as jax_anomaly
from tpu_dist_torch.obs import anomaly


def _feed(det, stream):
    out = []
    for i, obs in enumerate(stream):
        out.append(det.observe(epoch=i // 10, step=i % 10, **obs))
    return out


def _both(stream, **kw):
    ours = _feed(anomaly.AnomalyDetector(**kw), stream)
    theirs = _feed(jax_anomaly.AnomalyDetector(**kw), stream)
    return ours, theirs


def _seeded_stream(seed, n=200):
    """Losses drifting down with noise, a few spikes and NaNs; grad norms
    with explosions; now and then a non-finite leaf count."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        loss = float(2.3 * math.exp(-i / 150) + 0.05 * rng.standard_normal())
        gn = float(abs(1.0 + 0.2 * rng.standard_normal()))
        r = rng.random()
        if r < 0.03:
            loss *= 5.0
        elif r < 0.05:
            loss = float("nan")
        if rng.random() < 0.04:
            gn *= 30.0
        if rng.random() < 0.02:
            gn = float("inf")
        obs = {"loss": loss, "grad_norm": gn}
        if rng.random() < 0.5:
            obs["nonfinite"] = float(rng.random() < 0.05)
        out.append(obs)
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [{}, {"window": 8}, {"window": 2, "loss_spike": 1.5},
                                {"window": 20, "grad_spike": 3.0, "min_points": 3}],
                         ids=["defaults", "window8", "window2", "window20"])
def test_the_same_seeded_stream_gives_the_same_findings(seed, kw):
    ours, theirs = _both(_seeded_stream(seed), **kw)
    assert ours == theirs
    assert any(ours)  # the stream exercises the detector


def test_the_loss_only_stream_of_the_fused_path():
    stream = [{"loss": v} for v in (2.0, 2.1, 1.9, 2.0, 9.0, 2.0, float("nan"), 2.0, 8.0)]
    ours, theirs = _both(stream, window=4)
    assert ours == theirs
    assert [f["anomaly"] for fs in ours for f in fs] == ["loss_spike", "nonfinite_loss",
                                                        "loss_spike"]


def test_a_degenerate_window_is_refused_alike():
    for mod in (anomaly, jax_anomaly):
        with pytest.raises(ValueError, match="anomaly window must be >= 2, got 1"):
            mod.AnomalyDetector(window=1)


_value = st.one_of(st.floats(min_value=1e-3, max_value=1e3),
                   st.sampled_from([float("nan"), float("inf"), 0.0, 50.0]))
_obs = st.fixed_dictionaries(
    {}, optional={"loss": _value, "grad_norm": _value,
                  "nonfinite": st.sampled_from([0.0, 1.0, 3.0])})


@settings(max_examples=60, deadline=None)
@given(st.lists(_obs, max_size=60), st.integers(min_value=2, max_value=12),
       st.floats(min_value=1.1, max_value=5.0))
def test_hypothesis_streams_give_the_same_findings(stream, window, factor):
    ours, theirs = _both(stream, window=window, loss_spike=factor, grad_spike=factor)
    assert ours == theirs
