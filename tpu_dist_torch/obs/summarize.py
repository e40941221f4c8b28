"""Reading a run's JSONL history: the port's copy of the loader and the
summary of ``tpu_dist/obs/summarize.py`` (``load_records``,
``summarize``, ``SUPPORTED_SCHEMA``, ``KNOWN_KINDS``). The summary is the
report the compare gate (``obs/compare.py``) reads; it equals the JAX
package's on histories of either package. The text rendering
(``format_text``) and the trace export (``export_trace``) are not ported
(ROADMAP Queue A 6, telemetry): ``python -m tpu_dist.obs summarize``
reads the port's files as they are. Host file crunching only.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from tpu_dist_torch.obs import counters as counters_lib
from tpu_dist_torch.obs import goodput as goodput_lib
from tpu_dist_torch.obs import memory as memory_lib

#: Newest history schema the JAX package's reader fully understands
#: (``metrics/history.py::SCHEMA_VERSION``); every schema bump is additive.
SUPPORTED_SCHEMA = 15

#: Record kinds the JAX package's summary folds in; others are skipped
#: with a count there.
KNOWN_KINDS = frozenset((
    "train_epoch", "eval", "straggler", "anomaly", "device_stats",
    "auto_recover", "spans", "goodput", "profile", "alert",
    "profile_analysis", "resume", "fleet", "postmortem", "serve",
    "memory", "plan", "tune", "tenancy",
))


def load_records(path: str) -> Tuple[List[dict], int]:
    """Parse the JSONL; returns ``(records, n_bad_lines)``. A torn line (a
    writer killed mid-line) or a line that is not an object is counted,
    not fatal."""
    records: List[dict] = []
    bad = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                bad += 1
    return records, bad


def _tenancy_audit(snapshots: List[dict]) -> dict:
    """The exact chip-second conservation audit over the ``tenancy``
    snapshots (``fleet/scheduler.py`` owns the arithmetic; imported
    lazily, as the JAX package does: obs does not import fleet at module
    load)."""
    from tpu_dist_torch.fleet.scheduler import audit_chip_seconds  # noqa: PLC0415

    return audit_chip_seconds([{**s, "kind": "tenancy"} for s in snapshots])


def summarize(records: List[dict], bad_lines: int = 0) -> dict:
    """The per-epoch report: throughput, step-time percentiles, data-stall
    fraction, MFU, counter deltas (vs the previous epoch's snapshot), eval,
    device-stats, anomaly, and straggler results merged in by epoch."""
    epochs: List[dict] = []
    evals = {}
    stragglers = []
    anomalies: List[dict] = []
    alerts: List[dict] = []
    profiles: List[dict] = []
    profile_analyses: List[dict] = []
    goodput_epochs: List[dict] = []
    resumes: List[dict] = []  # segment boundaries (world size, reshard)
    world_sizes: List[int] = []  # distinct dp extents, in order of appearance
    fleet_decisions: List[dict] = []  # scheduler chip moves (schema v8)
    postmortems: List[dict] = []  # crash bundles (schema v9)
    serve_windows: List[dict] = []  # serving SLO windows (schema v10)
    serve_events: List[dict] = []   # serving events (mid-serve retraces)
    memory_records: List[dict] = []  # HBM-ledger snapshots (schema v11)
    oom_events: List[dict] = []      # parsed RESOURCE_EXHAUSTED crashes
    plan_records: List[dict] = []    # --auto_shard plan / TD119 drift (v12)
    tune_records: List[dict] = []    # --tune_report knob application (v13)
    tenancy_snapshots: List[dict] = []  # per-tick chip accounting (v14)
    dstats: dict = {}  # epoch -> per-epoch device_stats aggregate
    recoveries = 0
    prev_counters: Optional[dict] = None
    prev_run_id = None
    final_counters: Optional[dict] = None
    run_id = None
    schema = None
    skipped_kinds: dict = {}       # unknown kind -> count (never silent)
    newer_schema_records = 0       # records stamped past SUPPORTED_SCHEMA
    for rec in records:
        kind = rec.get("kind")
        run_id = rec.get("run_id", run_id)
        sv = rec.get("schema_version")
        if isinstance(sv, int) and sv > SUPPORTED_SCHEMA:
            newer_schema_records += 1
        schema = sv if sv is not None else schema
        if kind not in KNOWN_KINDS:
            # a future schema's kind (or a foreign line): skip WITH a
            # count — the v3 kind set must not be a parsing assumption
            skipped_kinds[str(kind)] = skipped_kinds.get(str(kind), 0) + 1
            continue
        rid = rec.get("run_id")
        if rid is not None and rid != prev_run_id:
            # resume boundary (same --log_file, fresh process + counter
            # registry): deltas across it would go negative/meaningless
            prev_counters = None
            prev_run_id = rid
        if kind == "eval":
            evals[rec.get("epoch")] = rec
        elif kind == "straggler":
            stragglers.append(
                {k: rec.get(k) for k in ("epoch", "skew", "worst_rank", "max_s", "median_s")}
            )
        elif kind == "alert":
            alerts.append({
                k: rec.get(k)
                for k in ("epoch", "step", "rule", "metric", "value",
                          "threshold", "op", "sustained")
                if rec.get(k) is not None
            })
        elif kind == "anomaly":
            anomalies.append({
                k: rec.get(k)
                for k in ("epoch", "step", "anomaly", "value", "median", "ratio")
            })
        elif kind == "device_stats":
            # per-epoch rollup of the per-step scalars: last value tracks
            # where the run ended up, max grad_norm catches the spike the
            # last sample may have missed
            d = dstats.setdefault(rec.get("epoch"), {"samples": 0})
            d["samples"] += 1
            g = rec.get("grad_norm")
            if isinstance(g, (int, float)):
                d["grad_norm_last"] = g
                d["grad_norm_max"] = max(d.get("grad_norm_max", g), g)
            for key in ("update_ratio", "param_norm"):
                v = rec.get(key)
                if isinstance(v, (int, float)):
                    d[f"{key}_last"] = v
        elif kind == "auto_recover":
            recoveries += 1
        elif kind == "resume":
            # segment boundary (schema v7): the host set is NOT fixed —
            # an elastic relaunch changes the world size mid-log, and the
            # report must say so instead of silently merging segments
            resumes.append({
                k: rec.get(k)
                for k in ("epoch", "world", "dp", "prev_dp", "prev_procs",
                          "resharded", "restarts", "mid_epoch_step",
                          "examples_offset", "decision_id",
                          "decision_cause")
                if rec.get(k) is not None
            })
            # the FIRST segment logs no resume record (fresh starts
            # don't), so seed the world-size history from the resumed
            # checkpoint's stamped previous extent — otherwise the
            # canonical single shrink would read as one world size and
            # the change banner would never render
            prev_dp = rec.get("prev_dp")
            if not world_sizes and isinstance(prev_dp, int):
                world_sizes.append(prev_dp)
            dp = rec.get("dp")
            if isinstance(dp, int) and (
                not world_sizes or world_sizes[-1] != dp
            ):
                world_sizes.append(dp)
        elif kind == "fleet":
            # a fleet-scheduler decision (schema v8): auditable chip move
            # between runs sharing the pod — keep the justification AND
            # the allocations so the report replays the arbitration
            fleet_decisions.append({
                k: rec.get(k)
                for k in ("tick", "action", "donor", "recipient", "for_run",
                          "chips", "alloc_before", "alloc_after",
                          "pending_after", "reason", "inputs",
                          "decision_id", "cause", "chained", "preempt")
                if rec.get(k) is not None
            })
        elif kind == "tenancy":
            # a per-tick chip-accounting snapshot (schema v14,
            # fleet/scheduler.py): every run's allocation + the free and
            # pending pools — the raw material of the exact chip-second
            # conservation audit
            tenancy_snapshots.append({
                k: rec.get(k)
                for k in ("tick", "alloc", "free", "pending",
                          "total_chips", "run_kinds", "decision_id")
                if rec.get(k) is not None
            })
        elif kind == "postmortem":
            # a crash bundle (schema v9): the watchdog/CLI assembler's
            # after-the-fact record of how the run DIED — verdicts per
            # rank, stuck frames, where each flight ring stopped
            postmortems.append({
                k: rec.get(k)
                for k in ("bundle", "n_ranks", "verdicts", "stuck_frames",
                          "fatal", "last_steps")
                if rec.get(k) is not None
            })
        elif kind == "serve":
            # a serving SLO window (schema v10, serve/engine.py): latency
            # percentile bounds, request rate, availability, batching
            # efficiency — or a mid-serve event (retrace) stamped by the
            # engine's pump
            if rec.get("event"):
                serve_events.append({
                    k: rec.get(k)
                    for k in ("event", "bucket", "n_real")
                    if rec.get(k) is not None
                })
            else:
                serve_windows.append({
                    k: rec.get(k)
                    for k in ("window_s", "requests", "completed",
                              "requests_per_s", "latency_p50_ms",
                              "latency_p95_ms", "latency_p99_ms",
                              "ttfb_p50_ms", "ttfb_p99_ms",
                              "availability", "batch_occupancy",
                              "batches", "queue_depth",
                              "queue_depth_max", "retraces", "phase_s")
                    if rec.get(k) is not None
                })
        elif kind == "memory":
            # an HBM-ledger snapshot (schema v11, obs/memory.py): the
            # first-dispatch static/census/allocator reconciliation, or
            # an event:"oom" crash record with the parsed allocation
            # report + the ledger that was live at the time
            if rec.get("event") == "oom":
                oom_events.append({
                    k: rec.get(k) for k in ("epoch", "oom", "ledger")
                    if rec.get(k) is not None
                })
            else:
                memory_records.append({
                    k: rec.get(k)
                    for k in ("epoch", "static", "xla", "census",
                              "reconciliation", "allocator", "feasibility")
                    if rec.get(k) is not None
                })
        elif kind == "plan":
            # an --auto_shard plan (schema v12, analysis/planner.py):
            # the chosen family + its priced step time at fit() start,
            # and — after a profiled run — the TD119 predicted-vs-
            # achieved drift record
            plan_records.append({
                k: rec.get(k)
                for k in ("epoch", "family", "mode", "applied",
                          "predicted_step_s", "achieved_step_s",
                          "planner_error_frac", "gauge_source",
                          "n_candidates", "n_refused")
                if rec.get(k) is not None
            })
        elif kind == "tune":
            # a --tune_report application (schema v13, analysis/overlap.py):
            # which schedule knobs the run trains with, which the user
            # kept, and the tuner objective they were chosen under
            tune_records.append({
                k: rec.get(k)
                for k in ("epoch", "family", "report", "objective",
                          "applied", "user_overrides")
                if rec.get(k) is not None
            })
        elif kind == "profile":
            profiles.append({
                k: rec.get(k)
                for k in ("epoch", "event", "reason", "start_step",
                          "stop_step", "steps", "dir", "error")
                if rec.get(k) is not None
            })
        elif kind == "profile_analysis":
            # the capture read back (obs/xprof.py, schema v6): category
            # attribution + overlap + calibration per capture
            profile_analyses.append({
                k: rec.get(k)
                for k in ("epoch", "reason", "dir", "steps",
                          "device_busy_s", "categories", "collectives",
                          "collective_frac", "overlap_frac",
                          "infeed_stall_s", "top_ops", "calibration",
                          "dropped", "error")
                if rec.get(k) is not None
            })
        elif kind == "goodput" and not rec.get("final"):
            goodput_epochs.append({
                "epoch": rec.get("epoch"),
                **({"tail": True} if rec.get("tail") else {}),
                **{
                    k: rec.get(k)
                    for k in (
                        [f"{b}_s" for b in goodput_lib.ALL_BUCKETS]
                        + ["window_s"]
                    )
                    if isinstance(rec.get(k), (int, float))
                },
            })
        if isinstance(rec.get("counters"), dict):
            final_counters = rec["counters"]
        if kind != "train_epoch":
            continue
        cur_counters = rec.get("counters") if isinstance(rec.get("counters"), dict) else None
        row = {
            "epoch": rec.get("epoch"),
            "images_per_sec": rec.get("images_per_sec"),
            "epoch_time_s": rec.get("epoch_time"),
            "step_time_p50_s": rec.get("step_time_p50"),
            "step_time_p95_s": rec.get("step_time_p95"),
            "step_time_p99_s": rec.get("step_time_p99"),
            "data_stall_frac": rec.get("data_stall_frac"),
            "loss": rec.get("loss"),
            "mfu": rec.get("mfu"),
        }
        if cur_counters is not None:
            deltas = counters_lib.delta(prev_counters, cur_counters)
            row["counter_deltas"] = deltas
            # mid-run retraces are a first-class health signal, not just a
            # counter line: surface the per-epoch delta explicitly
            if deltas.get("compile.retraces"):
                row["retraces"] = deltas["compile.retraces"]
            prev_counters = cur_counters
        epochs.append(row)
    attached = set()
    for row in epochs:
        ev = evals.get(row["epoch"])
        if ev is not None:
            row["val_top1"] = ev.get("top1")
        ds = dstats.get(row["epoch"])
        if ds is not None:
            row["device_stats"] = ds
            attached.add(row["epoch"])
    # device_stats of epochs with NO train_epoch record — the run died
    # mid-epoch (exactly the torn-tail case this report tolerates), and
    # the health data explaining the crash must not vanish with it
    partial = [
        {"epoch": e, **d}
        for e, d in sorted(dstats.items(), key=lambda kv: (kv[0] is None, kv[0]))
        if e not in attached
    ]
    times = [r["epoch_time_s"] for r in epochs if r.get("epoch_time_s")]
    ips = [r["images_per_sec"] for r in epochs if r.get("images_per_sec")]
    mfus = [r["mfu"] for r in epochs if isinstance(r.get("mfu"), (int, float))]
    # the single gating scalar of the memory layer: the worst observed
    # peak HBM — ledger snapshots first (allocator peak > xla estimate >
    # census), the epoch-grain mem.* gauge series as the running floor
    peak_hbm: Optional[int] = None
    for mr in memory_records:
        p = memory_lib.record_peak_hbm(mr)
        if p is not None:
            peak_hbm = max(peak_hbm or 0, p)
    for rec in records:
        cnt = rec.get("counters")
        if isinstance(cnt, dict):
            v = cnt.get("mem.peak_bytes_in_use")
            if isinstance(v, (int, float)) and v > 0:
                peak_hbm = max(peak_hbm or 0, int(v))
    out = {
        "run_id": run_id,
        "schema_version": schema,
        "n_records": len(records),
        "bad_lines": bad_lines,
        "skipped_kinds": skipped_kinds,
        "newer_schema_records": newer_schema_records,
        "epochs": epochs,
        "partial_epoch_device_stats": partial,
        "resumes": resumes,
        "world_sizes": world_sizes,
        "fleet_decisions": fleet_decisions,
        "postmortems": postmortems,
        "serve_windows": serve_windows,
        "serve_events": serve_events,
        "memory_records": memory_records,
        "oom_events": oom_events,
        "memory": (
            {"peak_hbm_bytes": peak_hbm, "oom_events": len(oom_events)}
            if (peak_hbm is not None or oom_events or memory_records)
            else None
        ),
        "plan_records": plan_records,
        "plan": (
            # the gating view of the planner layer: the last plan record
            # wins (the post-profile TD119 drift record supersedes the
            # fit()-start announcement, which carries no achieved time)
            {
                k: plan_records[-1].get(k)
                for k in ("family", "mode", "applied", "predicted_step_s",
                          "achieved_step_s", "planner_error_frac",
                          "gauge_source")
                if plan_records[-1].get(k) is not None
            }
            if plan_records else None
        ),
        "tenancy_snapshots": tenancy_snapshots,
        "tenancy": (
            # the gating view of the multi-tenant pod: the exact
            # chip-second conservation audit over every snapshot seen
            _tenancy_audit(tenancy_snapshots)
            if tenancy_snapshots else None
        ),
        "tune_records": tune_records,
        "tune": (
            # the gating view of the tuner layer: the last application
            # wins (a resume re-applies and re-announces)
            {
                k: tune_records[-1].get(k)
                for k in ("family", "objective", "applied",
                          "user_overrides")
                if tune_records[-1].get(k) is not None
            }
            if tune_records else None
        ),
        "stragglers": stragglers,
        "anomalies": anomalies,
        "alerts": alerts,
        "profiles": profiles,
        "profile_analyses": profile_analyses,
        "goodput_epochs": goodput_epochs,
        # run-level goodput ledger: resumed segments folded, restart gaps
        # attributed to preempt_s (None on a goodput-less / pre-v4 log)
        "goodput": goodput_lib.run_ledger(records),
        "auto_recoveries": recoveries,
        "totals": {
            "n_epochs": len(epochs),
            "total_train_time_s": round(sum(times), 3) if times else 0.0,
            "images_per_sec_mean": round(sum(ips) / len(ips), 1) if ips else None,
            "mfu_mean": round(sum(mfus) / len(mfus), 4) if mfus else None,
            "counters": final_counters or {},
        },
    }
    return out


