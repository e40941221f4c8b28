"""The no-op probes (TD105-TD115, TD120, TD122-TD124) and ``audit_all``:
the port's counterpart of ``tpu_dist/analysis/jaxpr_audit.py:529-2081``.

Every probe holds one host-side kit to the same contract: arming it must
leave the train step (or the serving forward) the same program. JAX
compares ``str(jax.make_jaxpr(step))`` with the kit disarmed and again
armed. The port compares the step fingerprint
(:func:`~tpu_dist_torch.analysis.step_audit.step_fingerprint`: every
dispatched op with its dtypes, shapes and devices, every ``c10d`` op, and
the hand-written kernels' launches) of the first call of a fresh setup
with the kit disarmed and again armed. A fresh setup each time compares
like with like: a second call of one step would differ for reasons that
are no leak (the fused SGD plan cache, a lazy init).

Each probe keeps JAX's function name, its kit and its check that the kit
actually ran: a dead kit makes the comparison vacuous and is itself a
violation, as in JAX. TD106 gains such a check here (the span recorded,
the counter moved, the heartbeat on disk), which JAX's lacks.

* TD105 ``fault_noop_violations``: a composite ``--fault_plan`` installed.
* TD106 ``telemetry_noop_violations``: spans, counters and a heartbeat.
* TD107 ``device_metrics_noop_violations``: flag off under an armed
  anomaly detector; flag on adds no collective and no transfer.
* TD108 ``profile_trigger_noop_violations``: a triggered profiler armed and
  its ``torch.profiler`` window open.
* TD109 ``live_export_noop_violations``: the OpenMetrics exporter (textfile
  and a live ``/metrics`` scraped on localhost) and a fired alert engine.
* TD110 ``xprof_hook_noop_violations``: the auto-analyze hook through its
  life cycle, with a real ``torch.profiler`` window (on the CPU too).
* TD111/TD112 ``elastic_resume_noop_violations``/
  ``elastic_grow_noop_violations``: a ZeRO-1 + int8_ef state saved host-side
  at another data-parallel extent and restored through
  ``elastic/remap.py`` at the ranks that run (``_ElasticMLP``, L = 412,
  4 mod 8, so the flat layouts really change); the remapper must fire when
  the layouts differ.
* TD113 ``flight_recorder_noop_violations``: the flight ring, excepthooks,
  the span listener and a fired SIGUSR1 stack dump.
* TD114 ``serving_slo_noop_violations``: the serve SLO kit around the
  proxy's eval forward.
* TD115 ``memory_ledger_noop_violations``: the memory ledger over a ZeRO-1
  state, the census, the allocator reconciliation, the pre-flight check and
  the out-of-memory parser over CUDA's ``torch.OutOfMemoryError`` text.
* TD120 ``async_ckpt_noop_violations`` (the trace half of JAX's
  ``tests/test_async_sharded_ckpt.py:100``): an ``AsyncShardedCheckpointer``
  armed with a write in flight.
* TD122 ``tenancy_arbitration_noop_violations``, TD123
  ``pod_hub_noop_violations``, TD124 ``archive_gate_noop_violations``.

:func:`audit_all` runs the audit cases, TD104 over their report, then (when
no case is named) every probe. Every probe runs over the default process
group on ``device``; the kits write into temporary directories of their
own.
"""

from __future__ import annotations

import os
import shutil
import signal
import tempfile
from typing import Optional

import numpy as np
import torch

from tpu_dist_torch import resolve_device
from tpu_dist_torch.analysis import step_audit
from tpu_dist_torch.analysis.rules import Violation
from tpu_dist_torch.analysis.step_audit import _AuditMLP, _dp_setup, step_fingerprint
from tpu_dist_torch.comm import collectives


def _fp(device, **step_kwargs) -> str:
    """The fingerprint of a fresh data-parallel setup's first step."""
    fn, args = _dp_setup(device, **step_kwargs)
    return step_fingerprint(fn, *args)


def _serve_fp(device) -> str:
    """The fingerprint of a fresh proxy's eval forward over one batch
    bucket (8 examples), the serving path's forward."""
    dev = resolve_device(device if device is not None else "cuda")
    model = _AuditMLP(dev).eval()
    images = torch.zeros((8, 2, 2, 3), dtype=torch.float32, device=dev)

    def forward(x):
        with torch.no_grad():
            return model(x)

    return step_fingerprint(forward, images)


def _v(rule: str, probe: str, message: str, snippet: str) -> Violation:
    return Violation(rule, f"<step:{probe}>", 0, message, snippet=snippet)


def fault_noop_violations(device=None) -> list:
    """TD105: the step's fingerprint with fault injection off equals the
    one under a fully armed composite ``--fault_plan`` (every injection
    point is host-side)."""
    from tpu_dist_torch.resilience import faults  # noqa: PLC0415

    prev = faults.active()
    faults.clear()
    try:
        base = _fp(device)
        faults.install("ckpt_write@call=1:times=2;ckpt_corrupt@epoch=0:mode=bitflip;"
                       "nan_loss@step=0;sigterm@step=999999;loader_stall@batch=0;"
                       "hang@step=999999:seconds=0.1")
        armed_plan = faults.active() is not None
        armed = _fp(device)
    finally:
        faults.clear()
        if prev is not None:
            faults.install(prev)
    out = []
    if not armed_plan:
        out.append(_v("TD105", "dp_faults_noop", "the TD105 probe installed a fault plan but "
                      "none is active — the armed-vs-off comparison would be vacuous",
                      "fault plan did not arm"))
    if base != armed:
        out.append(_v("TD105", "dp_faults_noop",
                      "the train step CHANGED when a fault plan was armed — a fault-injection "
                      "point leaked into the step; injection must stay host-side "
                      "(resilience/faults.py contract)",
                      "fingerprint(faults_off) != fingerprint(faults_armed)"))
    return out


def telemetry_noop_violations(device=None) -> list:
    """TD106: spans enabled, a counter moving and a heartbeat beating leave
    the step's fingerprint as it was; the kit must have recorded the probe's
    span, moved the counter and written the heartbeat."""
    from tpu_dist_torch.obs import counters, spans  # noqa: PLC0415
    from tpu_dist_torch.obs import heartbeat as heartbeat_lib  # noqa: PLC0415

    was_enabled = spans.enabled()
    spans.disable()
    hb_path = None
    ran = False
    try:
        base = _fp(device)
        # fresh=False when a live recorder was already armed: the audit must
        # not wipe its undrained buffer or shift its clock origin
        spans.enable(fresh=not was_enabled)
        before = counters.get("analysis.td106_probes")
        counters.inc("analysis.td106_probes")
        fd, hb_path = tempfile.mkstemp(suffix=".heartbeat.json")
        os.close(fd)
        hb = heartbeat_lib.Heartbeat(hb_path)
        hb.beat(epoch=0, step=0, force=True)
        with spans.span("td106/trace_probe"):
            armed = _fp(device)
        beat = heartbeat_lib.read(hb_path)
        ran = (any(e.get("name") == "td106/trace_probe" for e in spans.events())
               and counters.get("analysis.td106_probes") == before + 1
               and beat is not None and beat.get("step") == 0)
        hb.sweep()
    finally:
        if was_enabled:
            spans.enable(fresh=False)
        else:
            spans.disable()
            spans.drain()  # discard the probe's own span events
        if hb_path is not None and os.path.exists(hb_path):
            os.remove(hb_path)
    out = []
    if not ran:
        out.append(_v("TD106", "dp_telemetry_noop",
                      "the TD106 probe armed run telemetry but it did not actually run (no "
                      "probe span recorded, the counter did not move, or no heartbeat on "
                      "disk) — the armed-vs-off comparison would be vacuous",
                      "telemetry probe did not fire"))
    if base != armed:
        out.append(_v("TD106", "dp_telemetry_noop",
                      "the train step CHANGED when run telemetry was armed — an "
                      "instrumentation point leaked into the step; spans/counters/heartbeat "
                      "must stay host-side (tpu_dist_torch.obs contract)",
                      "fingerprint(telemetry_off) != fingerprint(telemetry_armed)"))
    return out


def device_metrics_noop_violations(device=None) -> list:
    """TD107: flag off under an armed host health layer (an anomaly
    detector observing, then firing) is the default step's program; flag
    on keeps the pure-DP step's collective and transfer inventory (the
    health scalars ride the reduced gradients and the one metrics fetch)."""
    from tpu_dist_torch.obs.anomaly import AnomalyDetector  # noqa: PLC0415

    fn, args = _dp_setup(device)
    base_counts = step_audit.trace_counts(fn, *args)
    base = _fp(device)
    det = AnomalyDetector(window=4)
    for i in range(6):
        det.observe(epoch=0, step=i, loss=1.0 + 0.01 * i, grad_norm=0.5)
    off = _fp(device, device_metrics=False)
    fired = det.observe(epoch=0, step=99, loss=1e9)  # a firing detector, too
    out = []
    if not fired:
        out.append(_v("TD107", "dp_device_metrics_noop",
                      "the TD107 probe's anomaly detector did not fire on a 1e9 loss spike — "
                      "the armed host health layer is dead", "anomaly detector did not fire"))
    if base != off:
        out.append(_v("TD107", "dp_device_metrics_noop",
                      "the train step with device_metrics=False under an armed host health "
                      "layer differs from the quiet default step — the disabled flag plus the "
                      "host-side machinery must be a no-op (obs/device_stats.py contract)",
                      "fingerprint(device_metrics_off|health armed) != fingerprint(default)"))
    fn_on, args_on = _dp_setup(device, device_metrics=True)
    on_counts = step_audit.trace_counts(fn_on, *args_on)
    if (on_counts["collectives"] != base_counts["collectives"]
            or on_counts["transfers"] != base_counts["transfers"]):
        out.append(_v("TD107", "dp_device_metrics_noop",
                      "arming --device_metrics changed the pure-DP step's collective/transfer "
                      f"inventory (off: {base_counts['collectives']}/"
                      f"{base_counts['transfers']} -> on: {on_counts['collectives']}/"
                      f"{on_counts['transfers']}) — the health scalars must stay local "
                      "arithmetic on the reduced gradients",
                      f"collectives:{on_counts['collectives']}"))
    return out


def profile_trigger_noop_violations(device=None) -> list:
    """TD108: a triggered profiler armed, then its capture window open (a
    real ``torch.profiler`` session), leaves the step's fingerprint as it
    was."""
    from tpu_dist_torch.obs.profile import TriggeredProfiler  # noqa: PLC0415

    base = _fp(device)
    tmp = tempfile.mkdtemp(prefix="td108_profile_")
    try:
        prof = TriggeredProfiler(tmp, window_steps=2, cooldown_steps=0, max_captures=1,
                                 analyze=False, device=device)
        prof.arm("anomaly_loss_spike")
        armed = _fp(device)
        started = prof.on_step(0)  # opens a real capture window
        capturing = _fp(device)
        prof.close()
        capture_ran = bool(started and started.get("event") == "start")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if base != armed or (capture_ran and base != capturing):
        return [_v("TD108", "dp_profile_trigger_noop",
                   "the train step CHANGED when a profiler trigger was armed (or a capture "
                   "window was open) — triggered profiling must stay control-plane only "
                   "(obs/profile.py contract)",
                   "fingerprint(profiler_off) != fingerprint(trigger_armed)")]
    return []


def xprof_hook_noop_violations(device=None) -> list:
    """TD110: a triggered profiler whose auto-analyze hook is on, through
    its whole life cycle (armed, capture open with real device work in the
    window, capture closed and analysed, the cost-model calibration
    published), leaves the step's fingerprint as it was; the hook must
    have run when the window captured."""
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415
    from tpu_dist_torch.obs.profile import TriggeredProfiler  # noqa: PLC0415

    dev = resolve_device(device if device is not None else "cuda")
    base = _fp(device)
    tmp = tempfile.mkdtemp(prefix="td110_xprof_")
    try:
        prof = TriggeredProfiler(tmp, window_steps=2, cooldown_steps=0, max_captures=1,
                                 analyze=True, device=device)
        prof.arm("anomaly_loss_spike")
        armed = _fp(device)
        started = prof.on_step(0)  # opens a real capture window
        # real device work inside the window, so the capture holds a timeline
        (torch.ones(64, device=dev) * 2.0).sum()
        capturing = _fp(device)
        stopped = prof.on_step(2)  # closes the window: the auto-analysis runs
        capture_ran = bool(started and started.get("event") == "start")
        analysis_ran = bool(stopped is not None
                            and ("analysis" in stopped or "analysis_error" in stopped))
        if analysis_ran and stopped.get("analysis") is not None:
            costmodel.publish_calibration(costmodel.calibration(
                {"flops_per_step": 1e9, "bytes_per_step": 1e6}, stopped["analysis"], steps=2,
                n_devices=1, peak=1e12))
        analyzed = _fp(device)
        prof.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = []
    if capture_ran and not analysis_ran:
        out.append(_v("TD110", "dp_xprof_hook_noop",
                      "the TD110 probe captured a real profiler window but the auto-analyze "
                      "hook produced neither an analysis nor an analysis_error on the stop "
                      "event — the armed-vs-off comparison would be vacuous",
                      "auto-analyze hook did not fire"))
    if base != armed or (capture_ran and (base != capturing or base != analyzed)):
        out.append(_v("TD110", "dp_xprof_hook_noop",
                      "the train step CHANGED across the auto-analyze hook's life cycle "
                      "(armed / capture open / capture closed and analysed + calibration "
                      "published) — capture read-back must stay host-side file crunching "
                      "(obs/xprof.py + obs/profile.py contract)",
                      "fingerprint(no_profiler) != fingerprint(xprof_hook_armed)"))
    return out


def flight_recorder_noop_violations(device=None) -> list:
    """TD113: the full forensic kit as ``fit()`` arms it (a flight ring
    writing records, the excepthooks wrapped, the span-open listener
    tapping the ring, faulthandler armed with a SIGUSR1 all-threads dump
    registered and fired) leaves the step's fingerprint as it was; the ring
    must decode its records and the dump parse."""
    from tpu_dist_torch.obs import flight as flight_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import spans  # noqa: PLC0415

    base = _fp(device)
    tmp = tempfile.mkdtemp(prefix="td113_flight_")
    rec = handle = None
    ring_ok = dump_ok = False
    try:
        rec = flight_lib.FlightRecorder(os.path.join(tmp, flight_lib.RING_NAME),
                                        run_id="td113", rank=0)
        rec.install_excepthooks()
        spans.set_open_listener(rec.span_open)
        rec.record("open", world=1)
        stacks_path = os.path.join(tmp, flight_lib.STACKS_NAME)
        handle = flight_lib.arm_faulthandler(stacks_path)
        dumped = False
        if handle is not None and handle.registered:
            os.kill(os.getpid(), signal.SIGUSR1)  # a real on-demand dump
            dumped = True
        rec.step(0, 0)
        with spans.span("td113/trace_probe"):
            armed = _fp(device)
        rec.step(0, 1)
        decoded = flight_lib.decode(rec.path)
        ring_ok = len(decoded["records"]) >= 3 and not decoded["torn_slots"]
        dump_ok = True
        if dumped:
            parsed = flight_lib.read_stack_dump(stacks_path)
            dump_ok = bool(parsed and parsed.get("current"))
    finally:
        spans.clear_open_listener()
        if rec is not None:
            rec.uninstall_excepthooks()
            rec.close()
        if handle is not None:
            flight_lib.disarm_faulthandler(handle)
        shutil.rmtree(tmp, ignore_errors=True)
    out = []
    if not ring_ok or not dump_ok:
        out.append(_v("TD113", "dp_flight_recorder_noop",
                      "the TD113 probe armed the forensic kit but it did not actually run ("
                      + ("the ring failed to decode its own records" if not ring_ok
                         else "the SIGUSR1 dump produced no parseable traceback")
                      + ") — the armed-vs-off comparison would be vacuous (obs/flight.py "
                      "contract)", "flight probe did not fire"))
    if base != armed:
        out.append(_v("TD113", "dp_flight_recorder_noop",
                      "the train step CHANGED when crash forensics was armed (flight ring "
                      "writing, excepthooks wrapped, span listener tapped, faulthandler + "
                      "SIGUSR1 dump live) — forensics must stay host-side file I/O on the "
                      "step boundary (obs/flight.py contract)",
                      "fingerprint(forensics_off) != fingerprint(forensics_armed)"))
    return out


def live_export_noop_violations(device=None) -> list:
    """TD109: the live exporter (a textfile and an HTTP ``/metrics``
    endpoint scraped on localhost) and an alert engine driven to a fired
    rule leave the step's fingerprint as it was."""
    import urllib.request  # noqa: PLC0415

    from tpu_dist_torch.obs import alerts as alerts_lib  # noqa: PLC0415
    from tpu_dist_torch.obs.export import MetricsExporter  # noqa: PLC0415

    base = _fp(device)
    tmp = tempfile.mkdtemp(prefix="td109_export_")
    exporter = None
    try:
        engine = alerts_lib.AlertEngine(alerts_lib.load_rules("default"))
        fired: list = []
        for _ in range(3):  # sustain the stall breach until the rule fires
            fired.extend(engine.observe({"data_stall_frac": 0.9, "mfu": 0.8}))
        textfile = os.path.join(tmp, "metrics.prom")
        try:
            exporter = MetricsExporter(textfile=textfile, port=0, rank=0)
        except OSError:  # no socket here: the textfile half still arms
            exporter = MetricsExporter(textfile=textfile, rank=0)
        exporter.update({"train.data_stall_frac": 0.9, "train.steps": 42},
                        {"alert_active": engine.active()}, force=True)
        if exporter.port:
            with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics",
                                        timeout=5) as resp:
                resp.read()
        armed = _fp(device)
        probe_ok = bool(fired) and bool(engine.active().get("stall_high"))
    finally:
        if exporter is not None:
            exporter.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out = []
    if not probe_ok:
        out.append(_v("TD109", "dp_live_export_noop",
                      "the TD109 probe could not put the alert engine into its fired state "
                      "(the built-in stall_high rule did not fire on a sustained breach) — the "
                      "armed-vs-off comparison would be vacuous", "alert probe did not fire"))
    if base != armed:
        out.append(_v("TD109", "dp_live_export_noop",
                      "the train step CHANGED when the live exporter + alert engine were armed "
                      "(exposition published, HTTP endpoint scraped, rules fired) — live "
                      "telemetry must stay host-side (obs/export.py + obs/alerts.py contract)",
                      "fingerprint(live_off) != fingerprint(live_armed)"))
    return out


class _ElasticMLP(_AuditMLP):
    # classes=12 -> L = 12*16 + 16 + 16*12 + 12 = 412 == 4 (mod 8):
    # padded_len(412, 8) = 416 != 412 = padded_len(412, 4), so an extent
    # change really reshapes the flat layouts
    classes = 12


def _elastic_setup(device, n_old: int) -> tuple:
    """A fresh ZeRO-1 + int8_ef step of :class:`_ElasticMLP` at this world,
    and the flat checkpoint of an ``n_old``-rank world (host numpy, every
    rank its own copy): this world's leaves with the extent-dependent ones
    (the flat momentum, the r1 residual rows) laid out for ``n_old``."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm.quantize import padded_len  # noqa: PLC0415
    from tpu_dist_torch.elastic.remap import params_len  # noqa: PLC0415
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    dev = resolve_device(device if device is not None else "cuda")
    model = _ElasticMLP(dev)
    opt = SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    state = TrainState.create(model, opt)
    state.layout = step_lib.flat_layout(model)
    state.opt_state = step_lib.init_sharded_opt_state(model, opt, layout=state.layout)
    state.ef = step_lib.init_ef_state(model, zero1=True, layout=state.layout)
    step = step_lib.make_train_step(opt, sync_bn=False, preempt_flag=False,
                                    shard_weight_update=True, grad_compression="int8_ef")
    L = params_len(model)
    flat = bridge.train_state_to_flat(state)  # every rank gathers its own copy
    mom = np.zeros((padded_len(L, n_old),), np.float32)
    mom[:L] = np.arange(L, dtype=np.float32) * 1e-3
    r1 = step_lib.ef_state_host_zeros(model, n_old, zero1=True)["r1"]
    flat["['opt_state']"] = mom
    flat["['ef']['r1']"] = (np.arange(r1.size) * 1e-6).astype(np.float32)
    images, labels = step_audit.proxy_batch(dev)
    return step, state, (images, labels % _ElasticMLP.classes, 0.1), flat, L


def _elastic_noop_probe(device=None, *, grow: bool) -> tuple:
    """TD111/TD112's machinery: the old world's ZeRO-1 + error-feedback
    checkpoint, written host-side at ``n_old`` ranks, is restored through
    the elastic remapper onto a fresh state at this world's ``n_new``
    ranks; the first step of the restored state is fingerprinted against
    a fresh start's. ``grow=False`` (TD111): ``n_old = 2 n_new``;
    ``grow=True`` (TD112): ``n_old = n_new // 2`` (at least 1). Returns
    ``(layouts_differ, remapper_fired, identical)``."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.ckpt import checkpoint as ckpt_lib  # noqa: PLC0415
    from tpu_dist_torch.comm.quantize import padded_len  # noqa: PLC0415
    from tpu_dist_torch.elastic.remap import Remapper, elastic_stamp  # noqa: PLC0415

    n_new = collectives.world_size()
    n_old = max(1, n_new // 2) if grow else 2 * n_new
    step, state, batch, flat_old, L = _elastic_setup(device, n_old)
    base = step_fingerprint(step, state, *batch)
    tmp = tempfile.mkdtemp(prefix="td112_grow_" if grow else "td111_elastic_")
    try:
        # the old world's checkpoint, one file a rank (no rank waits on another)
        path = ckpt_lib._write_npz(tmp, "ckpt_0.npz", flat_old, {
            "epoch": 0, "step": 0, "elastic": elastic_stamp(n_old, n_old, L)})
        step2, state2, batch2, _, _ = _elastic_setup(device, n_old)
        remapper = Remapper(L, n_new, n_old=n_old)
        restored = ckpt_lib.restore(path, template=bridge.restore_template(state2),
                                    remap=remapper)
        state2 = bridge.load_train_state(state2, restored)
        resumed = step_fingerprint(step2, state2, *batch2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    layouts_differ = padded_len(L, n_old) != padded_len(L, n_new) or n_old != n_new
    return layouts_differ, bool(remapper.used), base == resumed


def _elastic_violations(rule: str, probe: str, grow: bool, device) -> list:
    layouts_differ, fired, identical = _elastic_noop_probe(device, grow=grow)
    what = "a smaller-world checkpoint onto more ranks" if grow else (
        "a checkpoint across different data-parallel extents")
    out = []
    if layouts_differ and not fired:
        out.append(_v(rule, probe,
                      f"the {rule} probe restored {what} but the elastic remapper never fired "
                      "— the armed-vs-fresh comparison would be vacuous; the restore path "
                      "stopped routing shape mismatches through the remap hook",
                      "elastic remapper did not fire"))
    if not identical:
        out.append(_v(rule, probe,
                      f"the train step of an elastic-{'grown' if grow else 'resumed'} state "
                      "differs from a fresh start's at the same world size — the checkpoint "
                      "remap leaked into the step (shape/dtype drift in the re-laid ZeRO-1/EF "
                      "flat layouts; elastic/remap.py contract)",
                      f"fingerprint(fresh_start) != fingerprint({probe})"))
    return out


def elastic_resume_noop_violations(device=None) -> list:
    """TD111: a state restored from a checkpoint of a larger data-parallel
    extent (remapped) runs the step a fresh start at this world runs."""
    return _elastic_violations("TD111", "dp_elastic_resume_noop", False, device)


def elastic_grow_noop_violations(device=None) -> list:
    """TD112: the grow mirror of TD111: a checkpoint of a smaller extent
    remapped up onto this world."""
    return _elastic_violations("TD112", "dp_elastic_grow_noop", True, device)


def _breached_serve_windows(stats, engine, windows: int = 3, depth: int = 2) -> tuple:
    """Drive ``stats`` through ``windows`` windows of 4 requests of 600 ms
    (past the 500 ms p99 ceiling and the 50 ms probe deadline), feeding
    ``engine``; returns ``(fired, last window)``."""
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415

    fired: list = []
    window: dict = {}
    for _ in range(windows):  # sustain=2 rules genuinely sustain
        for _ in range(4):
            stats.on_batch(3, 4)
            stats.on_request_done(0.6, 0.45, {p: 0.1 for p in slo_lib.PHASES})
        stats.set_queue_depth(depth)
        window = stats.scalars(window_s=1.0, completed_in_window=4)
        fired.extend(engine.observe(window))
    return fired, window


def serving_slo_noop_violations(device=None) -> list:
    """TD114: the serve telemetry/SLO kit (latency histograms observing,
    gauges published, the SLO engine fired, the histogram exposition
    rendered and parsed back, a span open) leaves the serving forward's
    fingerprint as it was."""
    from tpu_dist_torch.obs import counters as counters_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import export as export_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import spans  # noqa: PLC0415
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415

    base = _serve_fp(device)
    stats = slo_lib.ServeStats(deadline_s=0.05)
    engine = slo_lib.make_slo_engine(slo_lib.load_slo_rules("default"))
    fired: list = []
    for _ in range(3):
        f, window = _breached_serve_windows(stats, engine, windows=1)
        stats.publish(window)
        fired.extend(f)
    exposition = export_lib.render(counters_lib.snapshot(), {"alert_active": engine.active()},
                                   histograms=stats.histogram_families())
    parsed = export_lib.parse(exposition)
    count_key = export_lib.metric_name("serve.latency_seconds") + "_count"
    with spans.span("td114/trace_probe"):
        armed = _serve_fp(device)
    out = []
    ran = (stats.total.count == 12 and not stats.check_invariants() and fired
           and parsed.get(count_key) == 12)
    if not ran:
        out.append(_v("TD114", "serving_slo_noop",
                      "the TD114 probe armed the serve SLO kit but it did not actually run "
                      "(histograms empty, invariants broken, no rule fired, or the exposition "
                      "failed to round-trip) — the armed-vs-off comparison would be vacuous",
                      "serve slo probe did not fire"))
    if base != armed:
        out.append(_v("TD114", "serving_slo_noop",
                      "the serving forward CHANGED when the serve telemetry/SLO machinery was "
                      "armed — serving observability must stay host-side arithmetic around "
                      "the unmodified forward (serve contract)",
                      "fingerprint(bare_inference) != fingerprint(slo_armed)"))
    return out


#: A canned CUDA ``torch.OutOfMemoryError`` text the TD115 probe parses:
#: arming the out-of-memory parser is part of the memory kit under audit.
_TD115_OOM_TEXT = (
    "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.50 GiB. GPU 0 has a "
    "total capacity of 79.18 GiB of which 1.50 GiB is free. Of the allocated memory "
    "76.25 GiB is allocated by PyTorch, and 20.00 MiB is reserved by PyTorch but "
    "unallocated.")


def memory_ledger_noop_violations(device=None) -> list:
    """TD115: the memory kit as the trainer arms it (the static ledger over
    a ZeRO-1 state, the live-tensor census, the allocator's statistics and
    their reconciliation, the ``mem.*`` gauges, the pre-flight feasibility
    check, the out-of-memory parser) leaves the step's fingerprint as it
    was; the ledger must be whole and its identity exact."""
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415
    from tpu_dist_torch.obs import memory as memory_lib  # noqa: PLC0415

    dev = resolve_device(device if device is not None else "cuda")
    fn, args = _dp_setup(device, shard_weight_update=True)
    state = args[0]
    base = step_fingerprint(fn, *args)
    led = memory_lib.static_ledger(**memory_lib.state_sections(state))
    census = memory_lib.live_census(dev)
    rec = memory_lib.reconcile(census, costmodel.device_memory_stats(dev))
    memory_lib.publish_ledger({"static": led, "census": census, "reconciliation": rec})
    feas = memory_lib.feasibility(led["bytes_per_device"], budget_bytes=16 * 1024 ** 3,
                                  headroom=0.9)
    oom = memory_lib.parse_resource_exhausted(_TD115_OOM_TEXT)
    armed = _fp(device, shard_weight_update=True)
    n = collectives.world_size()
    ran = (led["bytes_per_device"] > 0
           and led["sections"]["opt_state"]["bytes_per_device"] > 0
           and (n == 1 or led["sections"]["opt_state"]["sharded_leaves"] > 0)
           and census["n_arrays"] > 0
           and rec["attributed_bytes"] + rec["unattributed_bytes"] == rec["bytes_in_use"]
           and feas["fits"]
           and oom is not None
           and oom.get("requested_bytes") == int(2.5 * 1024 ** 3)
           and oom.get("used_bytes") == int(76.25 * 1024 ** 3)
           and oom.get("limit_bytes") == int(79.18 * 1024 ** 3))
    out = []
    if not ran:
        out.append(_v("TD115", "dp_memory_ledger_noop",
                      "the TD115 probe armed the memory ledger kit but it did not actually "
                      "run (empty ledger, no sharded-extent accounting, broken reconciliation "
                      "identity, or the OOM parser returned garbage) — the armed-vs-off "
                      "comparison would be vacuous (obs/memory.py contract)",
                      "memory ledger probe did not fire"))
    if base != armed:
        out.append(_v("TD115", "dp_memory_ledger_noop",
                      "the train step CHANGED when the memory ledger was armed — memory "
                      "observability must stay host-side metadata arithmetic (obs/memory.py "
                      "contract)", "fingerprint(ledger_off) != fingerprint(ledger_armed)"))
    return out


def _shared_tmpdir(prefix: str) -> str:
    """A temporary directory rank 0 makes and every rank of the default
    group is told (a broadcast outside any step)."""
    import torch.distributed as dist  # noqa: PLC0415

    path = [tempfile.mkdtemp(prefix=prefix) if collectives.rank() == 0 else None]
    if collectives.world_size() > 1:
        dist.broadcast_object_list(path, src=0)
    return path[0]


def async_ckpt_noop_violations(device=None) -> list:
    """TD120's trace half: an ``AsyncShardedCheckpointer`` armed with a
    write in flight (its worker held behind a gate until the fingerprint is
    taken) leaves the step's fingerprint as it was; the write must then
    commit a manifest that verifies."""
    import threading  # noqa: PLC0415

    from tpu_dist_torch.ckpt import checkpoint as ckpt_lib  # noqa: PLC0415

    fn, args = _dp_setup(device)
    base = step_fingerprint(fn, *args)
    tmp = _shared_tmpdir("td120_async_")
    writer = ckpt_lib.AsyncShardedCheckpointer(commit_timeout_s=60.0)
    gate = threading.Event()
    ok = False
    try:
        writer._pool.submit(gate.wait, 60.0)  # the write below queues behind it
        mpath = writer.save(tmp, args[0], 0)
        in_flight = writer.in_flight > 0
        armed = _fp(device)
        gate.set()
        closed = writer.close(timeout=60.0)
        collectives.barrier()  # every rank's shards are on disk
        if collectives.rank() == 0:
            ckpt_lib.verify_sharded(mpath, deep=True)
        ok = in_flight and closed
    finally:
        gate.set()
        collectives.barrier()
        if collectives.rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
    out = []
    if not ok:
        out.append(_v("TD120", "async_ckpt_noop",
                      "the TD120 probe armed the async sharded writer but no write was in "
                      "flight when the step ran, or it never committed — the armed-vs-off "
                      "comparison would be vacuous (ckpt/checkpoint.py)",
                      "async writer probe did not fire"))
    if base != armed:
        out.append(_v("TD120", "async_ckpt_noop",
                      "the train step CHANGED while an async sharded checkpoint was being "
                      "written — the snapshot must stay a host copy at the step boundary "
                      "(ckpt/checkpoint.py)",
                      "fingerprint(sync) != fingerprint(async_writer_armed)"))
    return out


def tenancy_arbitration_noop_violations(device=None) -> list:
    """TD122: the multi-tenancy kit (a breached serve exposition scraped
    through ``read_signals``, a kind-aware fleet scheduler driven to a
    fired donate -> grant preemption, the cooperative SIGTERM flag raised,
    a serving engine shedding load, the chip-second audit) leaves the train
    step and the serving forward as they were."""
    import signal as signal_lib  # noqa: PLC0415

    from tpu_dist_torch.fleet import scheduler as fleet_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import export as export_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import heartbeat as heartbeat_lib  # noqa: PLC0415
    from tpu_dist_torch.resilience import preemption  # noqa: PLC0415
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415
    from tpu_dist_torch.serve.engine import ServingEngine  # noqa: PLC0415

    base_train = _fp(device, shard_weight_update=True)
    base_serve = _serve_fp(device)

    stats = slo_lib.ServeStats(deadline_s=0.05)
    slo_engine = slo_lib.make_slo_engine(slo_lib.load_slo_rules("default"))
    fired, window = _breached_serve_windows(stats, slo_engine, depth=6)
    with tempfile.TemporaryDirectory(prefix="td122_") as td:
        prom = os.path.join(td, "metrics.prom")
        with open(prom, "w") as f:
            f.write(export_lib.render(window, {"alert_active": slo_engine.active()},
                                      histograms=stats.histogram_families()))
        hb_path = os.path.join(td, "hb.json")
        heartbeat_lib.Heartbeat(hb_path).beat(force=True)
        sig = fleet_lib.read_signals("svc", prom, heartbeat_file=hb_path)

    sched = fleet_lib.FleetScheduler(
        [fleet_lib.RunSpec("trainer", 8, min_procs=2, kind="train"),
         fleet_lib.RunSpec("svc", 4, min_procs=1, kind="serve")],
        allocations={"trainer": 8, "svc": 2})
    signals = {"trainer": fleet_lib.RunSignals(run="trainer", data_stall_frac=0.02,
                                               goodput_frac=0.9, alive=True),
               "svc": sig}
    decisions: list = []
    tenancy: list = []
    for t in range(1, 5):
        decisions.extend(sched.step(t, signals))
        tenancy.append(sched.tenancy_record(t))
    audit = fleet_lib.audit_chip_seconds(tenancy)

    token = preemption.install()
    engine = ServingEngine(_AuditMLP(device), max_batch=4, max_queue=2, device=device)
    try:
        if signal_lib.getsignal(signal_lib.SIGTERM) is preemption._handler:
            signal_lib.raise_signal(signal_lib.SIGTERM)
        else:  # driven off the main thread: no handler installed
            preemption._handler(signal_lib.SIGTERM, None)
        flag_fired = preemption.requested()
        engine.set_shedding(True, "vacate (TD122 probe)")
        refused = engine.submit(np.zeros((2, 2, 3), np.float32))
        shed_ok = not refused.ok and engine.stats.shed == 1 and engine.queue_depth() == 0
        # re-fingerprint with the whole kit up: flag raised, shedding on
        armed_train = _fp(device, shard_weight_update=True)
        armed_serve = _serve_fp(device)
    finally:
        engine.set_shedding(False)
        preemption.clear()
        preemption.restore(token)

    ran = (sig.queue_depth == 6.0 and sig.alive is True
           and any(a.startswith("slo_") for a in sig.active_alerts)
           and fired and any(d.get("preempt") for d in decisions)
           and sched.preemptions >= 2 and sched.alloc == {"trainer": 4, "svc": 4}
           and flag_fired and shed_ok and audit["conserved"])
    out = []
    if not ran:
        out.append(_v("TD122", "tenancy_arbitration_noop",
                      "the TD122 probe armed the tenancy arbitration kit but it did not "
                      "actually run (serve gauges failed to scrape, no slo_* alert fired, the "
                      "preemption never fired or the chips never landed, the SIGTERM flag was "
                      "not observed, no request was shed, or the chip-second books failed to "
                      "balance) — the armed-vs-off comparison would be vacuous",
                      "tenancy arbitration probe did not fire"))
    if base_train != armed_train:
        out.append(_v("TD122", "tenancy_arbitration_noop",
                      "the train step CHANGED when the multi-tenant arbitration kit was armed "
                      "— co-scheduling must stay host-side control-plane arithmetic "
                      "(fleet/scheduler.py contract)",
                      "fingerprint(train, tenancy_off) != fingerprint(train, tenancy_armed)"))
    if base_serve != armed_serve:
        out.append(_v("TD122", "tenancy_arbitration_noop",
                      "the serving forward CHANGED when the multi-tenant arbitration kit was "
                      "armed — a replica under an active vacate must serve the same program "
                      "(serve/engine.py contract)",
                      "fingerprint(serve, tenancy_off) != fingerprint(serve, tenancy_armed)"))
    return out


def pod_hub_noop_violations(device=None) -> list:
    """TD123: the pod telemetry plane (two run expositions federated by one
    ``TelemetryHub`` pass, the arbiter fed from its snapshot and driven to a
    donate -> grant pair under one ``decision_id``, the id carried through
    the allocation file, a relaunch environment and a resume record, and
    the goodput ledger charging the gap to ``preempt_for_serve_s`` with an
    exact partition) leaves the train step and the serving forward as they
    were."""
    from tpu_dist_torch.elastic import supervisor as supervisor_lib  # noqa: PLC0415
    from tpu_dist_torch.fleet import capacity as capacity_lib  # noqa: PLC0415
    from tpu_dist_torch.fleet import scheduler as fleet_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import export as export_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import goodput as goodput_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import heartbeat as heartbeat_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import hub as hub_lib  # noqa: PLC0415
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415

    base_train = _fp(device, shard_weight_update=True)
    base_serve = _serve_fp(device)

    with tempfile.TemporaryDirectory(prefix="td123_") as td:
        train_prom = os.path.join(td, "trainer.prom")
        with open(train_prom, "w") as f:
            f.write(export_lib.render({"train.data_stall_frac": 0.02,
                                       "goodput.goodput_frac": 0.9}))
        train_hb = os.path.join(td, "trainer.hb")
        heartbeat_lib.Heartbeat(train_hb).beat(force=True)
        stats = slo_lib.ServeStats(deadline_s=0.05)
        slo_engine = slo_lib.make_slo_engine(slo_lib.load_slo_rules("default"))
        _, window = _breached_serve_windows(stats, slo_engine, depth=6)
        svc_prom = os.path.join(td, "svc.prom")
        with open(svc_prom, "w") as f:
            f.write(export_lib.render(window, {"alert_active": slo_engine.active()},
                                      histograms=stats.histogram_families()))
        svc_hb = os.path.join(td, "svc.hb")
        heartbeat_lib.Heartbeat(svc_hb).beat(force=True)

        fleet_prom = os.path.join(td, "fleet.prom")
        sched = fleet_lib.FleetScheduler(
            [fleet_lib.RunSpec("trainer", 8, min_procs=2, kind="train"),
             fleet_lib.RunSpec("svc", 4, min_procs=1, kind="serve")],
            allocations={"trainer": 8, "svc": 2}, fleet_dir=td)
        hub = hub_lib.TelemetryHub(
            [hub_lib.RunSource("trainer", metrics_file=train_prom, heartbeat_file=train_hb,
                               kind="train"),
             hub_lib.RunSource("svc", metrics_file=svc_prom, heartbeat_file=svc_hb,
                               kind="serve")],
            fleet_exposition=fleet_prom)
        decisions: list = []
        for t in range(1, 5):
            sched.write_exposition(fleet_prom)
            decisions.extend(sched.step(t, fleet_lib.signals_from_hub(hub.collect())))
        sched.write_exposition(fleet_prom)
        snap = hub.collect()  # scraped mid-audit, post-preemption state
        federated = hub.federated(snap)

        donate = next((d for d in decisions if d.get("action") == "donate"), {})
        grant = next((d for d in decisions if d.get("action") == "grant" and d.get("chained")),
                     {})
        did = donate.get("decision_id")
        alloc_meta = capacity_lib.read_allocation_meta(sched.allocation_path("trainer"))
        env: dict = {}
        supervisor_lib.stamp_decision_env(env, sched.allocation_path("trainer"))
        env_id = env.get(supervisor_lib.DECISION_ID_ENV)
        env_cause = env.get(supervisor_lib.DECISION_CAUSE_ENV)
        resume_rec = {"kind": "resume", "run_id": "b", "ts": 130.0, "rel_s": 10.0, "dp": 4,
                      "prev_dp": 8, "resharded": True,
                      "decision_id": int(env_id) if env_id else None,
                      "decision_cause": env_cause}
        ledger = goodput_lib.run_ledger([
            {"kind": "goodput", "run_id": "a", "ts": 100.0, "final": True,
             "productive_s": 50.0, "data_stall_s": 10.0, "elapsed_s": 60.0},
            resume_rec,
            {"kind": "goodput", "run_id": "b", "ts": 150.0, "final": True,
             "productive_s": 20.0, "elapsed_s": 20.0},
        ]) or {}
        armed_train = _fp(device, shard_weight_update=True)
        armed_serve = _serve_fp(device)

    rollup = snap.get("rollup") or {}
    partition_gap = abs(sum(ledger.get(f"{b}_s", 0.0) for b in goodput_lib.ALL_BUCKETS)
                        - ledger.get("elapsed_s", -1.0))
    ran = (rollup.get("runs_aggregated") == 2  # vacuity guard: zero is a trip
           and rollup.get("breach_count") == 1
           and rollup.get("total_chips") == 10.0  # 8 + 2 initial allocations
           and isinstance(rollup.get("last_decision_id"), float)
           and int(rollup["last_decision_id"]) >= 1
           and federated.endswith("# EOF\n")
           and 'run="svc"' in federated
           and "tpu_dist_pod_runs_aggregated 2" in federated
           and isinstance(did, int)
           and grant.get("decision_id") == did
           and donate.get("cause") == "serve_breach"
           and alloc_meta.get("decision_id") == did
           and env_id == str(did)
           and resume_rec["decision_id"] == did
           and ledger.get("preempt_for_serve_s") == 20.0
           and partition_gap < 1e-6)
    out = []
    if not ran:
        out.append(_v("TD123", "pod_hub_noop",
                      "the TD123 probe armed the pod telemetry plane but it did not actually "
                      "run (fewer than two runs aggregated, the federated page failed to "
                      "round-trip, the donate->grant pair never fired or split across two "
                      "decision ids, the id failed to propagate, or the goodput partition "
                      "broke) — the armed-vs-off comparison would be vacuous",
                      "pod telemetry plane probe did not fire"))
    if base_train != armed_train:
        out.append(_v("TD123", "pod_hub_noop",
                      "the train step CHANGED when the pod telemetry plane was armed — "
                      "federation and causal tracing must stay host-side file arithmetic "
                      "(obs/hub.py contract)",
                      "fingerprint(train, hub_off) != fingerprint(train, hub_armed)"))
    if base_serve != armed_serve:
        out.append(_v("TD123", "pod_hub_noop",
                      "the serving forward CHANGED when the pod telemetry plane was armed "
                      "(obs/hub.py contract)",
                      "fingerprint(serve, hub_off) != fingerprint(serve, hub_armed)"))
    return out


def archive_gate_noop_violations(device=None) -> list:
    """TD124: the longitudinal archive kit (a synthetic bench history with
    one stale re-emission ingested twice, idempotent by fingerprint, the
    stale copy kept out of the band, the injected-regression probe caught)
    leaves the train step as it was; a probe that misses any leg is itself
    a violation."""
    import json as json_lib  # noqa: PLC0415

    from tpu_dist_torch.obs import archive as archive_lib  # noqa: PLC0415

    base = _fp(device)
    out = []
    with tempfile.TemporaryDirectory(prefix="td124_") as td:
        bench_path = os.path.join(td, "bench.jsonl")
        recs = [{"metric": "synthetic_train_throughput",
                 "value": 100.0 + [0.4, -0.3, 0.1, -0.2, 0.3, 0.0][i], "unit": "images/sec",
                 "capture": {"host": "td124", "bench_run_id": f"run{i:02d}",
                             "mono_s": float(i)}} for i in range(6)]
        # the stale re-emission of the newest capture (a last-good fallback)
        recs.append(dict(recs[-1], stale=True, note="re-emitted last good"))
        with open(bench_path, "w") as f:
            for r in recs:
                f.write(json_lib.dumps(r) + "\n")
        arch = os.path.join(td, "archive.jsonl")
        rep1 = archive_lib.ingest_paths([bench_path], arch)
        rep2 = archive_lib.ingest_paths([bench_path], arch)
        records, _ = archive_lib.load_archive(arch)
        band = archive_lib.band_for(records, "synthetic_train_throughput", "value")
        probe = archive_lib.inject_probe(records)
        ran = (rep1["appended"] == 7 and rep1["stale_appended"] == 1
               and rep2["appended"] == 0 and rep2["deduped"] == 7
               and band is not None and band["n"] == 6
               and probe["bands_probed"] >= 1 and not archive_lib.probe_is_dead(probe))
        if not ran:
            out.append(_v("TD124", "archive_gate_noop",
                          "the archive-gate probe is VACUOUS or the detector is dead: ingest "
                          f"appended {rep1['appended']}/{rep1['stale_appended']}-stale then "
                          f"{rep2['appended']} on re-ingest (want 7/1 then 0), band n="
                          f"{band['n'] if band else None} (want 6, stale excluded), "
                          f"inject-regression probe gate={probe['gate_probe']} "
                          f"improvements_clean={probe['improvements_clean']} changepoint="
                          f"{probe['changepoint_probe']} (want caught/True/localized) — a gate "
                          "that cannot catch its own injected regression passes every real "
                          "one (obs/archive.py)", "inject_probe(archive) came back dead"))
        armed = _fp(device)
    if base != armed:
        out.append(_v("TD124", "archive_gate_noop",
                      "the train step CHANGED when the longitudinal archive kit was armed — "
                      "the archive must stay host-side file arithmetic (obs/archive.py)",
                      "fingerprint(train, archive_off) != fingerprint(train, archive_armed)"))
    return out


#: Every probe in ``audit_all``'s order, by its report name.
PROBES = (
    ("dp_faults_noop", fault_noop_violations),
    ("dp_telemetry_noop", telemetry_noop_violations),
    ("dp_device_metrics_noop", device_metrics_noop_violations),
    ("dp_profile_trigger_noop", profile_trigger_noop_violations),
    ("dp_live_export_noop", live_export_noop_violations),
    ("dp_xprof_hook_noop", xprof_hook_noop_violations),
    ("dp_elastic_resume_noop", elastic_resume_noop_violations),
    ("dp_elastic_grow_noop", elastic_grow_noop_violations),
    ("dp_flight_recorder_noop", flight_recorder_noop_violations),
    ("serving_slo_noop", serving_slo_noop_violations),
    ("dp_memory_ledger_noop", memory_ledger_noop_violations),
    ("async_ckpt_noop", async_ckpt_noop_violations),
    ("tenancy_arbitration_noop", tenancy_arbitration_noop_violations),
    ("pod_hub_noop", pod_hub_noop_violations),
    ("archive_gate_noop", archive_gate_noop_violations),
)


def audit_all(device=None, names: Optional[list] = None) -> tuple:
    """Run every (or the named) audit case, then TD104 over the report; a
    full run (``names`` None) then runs every probe. Returns ``(report,
    violations)``: the report maps a case to its counts and a probe to
    ``{"identical": bool}``."""
    report: dict = {}
    violations: list = []
    for name in names if names is not None else step_audit.registered_cases():
        counts, vs = step_audit.audit_case(name, device)
        report[name] = counts
        violations.extend(vs)
    violations.extend(step_audit.wire_ratio_violations(report))
    if names is None:
        for name, probe in PROBES:
            vs = probe(device)
            report[name] = {"identical": not vs}
            violations.extend(vs)
    return report, violations
