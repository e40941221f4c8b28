"""Reading a run's JSONL history: the port's copy of the loader, the
summary and its text rendering in ``tpu_dist/obs/summarize.py``
(``load_records``, ``summarize``, ``format_text``, ``capture_stamp``,
``SUPPORTED_SCHEMA``, ``KNOWN_KINDS``). The summary is the report the
compare gate (``obs/compare.py``) reads and ``python -m
tpu_dist_torch.obs summarize`` renders; both equal the JAX package's on
histories of either package, and a record kind of a subsystem the port
does not have yet renders as the JAX package renders its absence.
:func:`export_trace` turns a history into a Chrome trace, ``python -m
tpu_dist_torch.obs export-trace``. Host file crunching only.
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


def capture_stamp(path: str) -> dict:
    """The history log's capture identity — the history-side analogue of
    the bench capture fingerprint: a content hash of the log
    itself, so two ingests of the same physical log dedupe and a
    re-emitted copy is recognizable as the SAME capture rather than a
    fresh run. Content-based on purpose: re-summarizing the identical
    log on another host must produce the identical fingerprint."""
    import hashlib  # noqa: PLC0415
    import os  # noqa: PLC0415

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return {
        "fingerprint": h.hexdigest()[:16],
        "source_log": os.path.abspath(path),
    }


def stamp_capture(report: dict, path: str) -> dict:
    """Stamp :func:`capture_stamp` into a summarize report's header
    (``obs summarize --format json`` does this; archive ingest reads
    it back for dedupe). Returns the report for chaining."""
    stamp = capture_stamp(path)
    report["source_log"] = stamp["source_log"]
    report["capture"] = {
        "fingerprint": stamp["fingerprint"],
        "run_id": report.get("run_id"),
    }
    return report


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


def _fmt(v, spec: str, width: int) -> str:
    return (format(v, spec) if v is not None else "-").rjust(width)


def format_text(report: dict) -> str:
    """Human-readable rendering of :func:`summarize`'s report."""
    lines = []
    rid = report.get("run_id")
    lines.append(
        f"run {rid or '<no run_id>'} — {report['totals']['n_epochs']} epoch(s), "
        f"{report['n_records']} record(s)"
        + (f", {report['bad_lines']} unparsable line(s)" if report["bad_lines"] else "")
    )
    skipped = report.get("skipped_kinds") or {}
    if skipped:
        body = ", ".join(f"{k}×{v}" for k, v in sorted(skipped.items()))
        lines.append(
            f"skipped {sum(skipped.values())} record(s) of unknown kind(s): "
            f"{body}"
        )
    if report.get("newer_schema_records"):
        lines.append(
            f"NOTE: {report['newer_schema_records']} record(s) carry a "
            f"schema version newer than this reader supports "
            f"({SUPPORTED_SCHEMA}) — known kinds are summarized, the rest "
            "skipped above"
        )
    ws = report.get("world_sizes") or []
    if len(ws) > 1:
        lines.append(
            "world size changed mid-run (elastic): dp "
            + " -> ".join(str(w) for w in ws)
            + " — epoch rows below span DIFFERENT host/device sets"
        )
    for rs in report.get("resumes", []):
        pos = (
            f" at step {rs['mid_epoch_step']}" if rs.get("mid_epoch_step")
            else f" at example offset {rs['examples_offset']}"
            if rs.get("examples_offset") else ""
        )
        # world-size INCREASE (scale-up / fleet receipt) labeled
        # distinctly from the preemption-shrink reshard — one shared
        # classifier: goodput.resume_direction
        direction = goodput_lib.resume_direction(rs)
        lines.append(
            f"segment: resumed epoch {rs.get('epoch')}{pos} on "
            f"{rs.get('world')} process(es), dp={rs.get('dp')}"
            + (
                f" ({'GROWN' if direction == 'grown' else 'RESHARDED'}"
                f" from dp={rs.get('prev_dp')})"
                if direction else ""
            )
            + (
                f" — elastic restart #{rs['restarts']}"
                if rs.get("restarts") else ""
            )
            + (
                # causal tracing (schema v15): a fleet-initiated resize
                # names its arbitration; a chip-loss one carries none
                f" [decision #{rs['decision_id']}"
                + (f": {rs['decision_cause']}" if rs.get("decision_cause")
                   else "")
                + "]"
                if rs.get("decision_id") is not None else ""
            )
        )
    for fd in report.get("fleet_decisions", []):
        lines.append(
            f"fleet: tick {fd.get('tick')}: "
            + goodput_lib.fleet_move_phrase(fd)
            + (f" — {fd['reason']}" if fd.get("reason") else "")
            + (
                " [alloc "
                + ", ".join(
                    f"{r}:{fd['alloc_before'][r]}->{fd['alloc_after'][r]}"
                    for r in sorted(fd["alloc_before"])
                )
                + "]"
                if fd.get("alloc_before") and fd.get("alloc_after") else ""
            )
        )
    ten = report.get("tenancy")
    if ten:
        lines.append(
            f"tenancy: {ten['n_ticks']} tick(s) × {ten['total_chips']} "
            "chip(s) — "
            + (
                "chip-seconds conserved exactly"
                if ten.get("conserved")
                else "CHIP-SECOND CONSERVATION VIOLATED"
            )
            + " ["
            + ", ".join(
                f"{r}:{v:g}" for r, v in (ten.get("per_run") or {}).items()
            )
            + f", free:{ten.get('free_chip_s', 0):g}"
            + f", pending:{ten.get('pending_chip_s', 0):g}]"
        )
    hdr = (
        f"{'epoch':>5} {'img/s':>9} {'epoch_s':>8} {'p50_ms':>8} "
        f"{'p95_ms':>8} {'p99_ms':>8} {'stall%':>7} {'mfu':>6} "
        f"{'loss':>9} {'val_top1':>9}"
    )
    lines.append(hdr)
    for r in report["epochs"]:
        ms = lambda v: v * 1e3 if v is not None else None  # noqa: E731
        lines.append(
            f"{_fmt(r['epoch'], 'd', 5)} {_fmt(r['images_per_sec'], '.1f', 9)} "
            f"{_fmt(r['epoch_time_s'], '.2f', 8)} {_fmt(ms(r['step_time_p50_s']), '.1f', 8)} "
            f"{_fmt(ms(r['step_time_p95_s']), '.1f', 8)} {_fmt(ms(r['step_time_p99_s']), '.1f', 8)} "
            f"{_fmt(r['data_stall_frac'] * 100 if r['data_stall_frac'] is not None else None, '.1f', 7)} "
            f"{_fmt(r.get('mfu'), '.3f', 6)} "
            f"{_fmt(r['loss'], '.4f', 9)} {_fmt(r.get('val_top1'), '.2f', 9)}"
        )
        ds = r.get("device_stats")
        if ds:
            lines.append(
                "      device: grad_norm last "
                f"{_fmt(ds.get('grad_norm_last'), '.4g', 0).strip()} / max "
                f"{_fmt(ds.get('grad_norm_max'), '.4g', 0).strip()}, "
                "update_ratio "
                f"{_fmt(ds.get('update_ratio_last'), '.3g', 0).strip()} "
                f"({ds['samples']} sample(s))"
            )
        if r.get("retraces"):
            lines.append(
                f"      WARNING: {r['retraces']:g} mid-run retrace(s) — the "
                "train step recompiled after step 0 (shape/dtype drift)"
            )
        deltas = r.get("counter_deltas") or {}
        if deltas:
            body = ", ".join(f"{k}+{v:g}" for k, v in sorted(deltas.items()))
            lines.append(f"      counters: {body}")
    for ds in report.get("partial_epoch_device_stats", []):
        lines.append(
            f"partial epoch {ds.get('epoch')} (no epoch summary — run died "
            "mid-epoch): grad_norm last "
            f"{_fmt(ds.get('grad_norm_last'), '.4g', 0).strip()} / max "
            f"{_fmt(ds.get('grad_norm_max'), '.4g', 0).strip()}, "
            "update_ratio "
            f"{_fmt(ds.get('update_ratio_last'), '.3g', 0).strip()} "
            f"({ds.get('samples')} sample(s))"
        )
    for pm in report.get("postmortems", []):
        # per-rank lines through the ONE shared formatter (obs/
        # postmortem.py — jax-free): summarize/tail/pod can never drift
        from tpu_dist_torch.obs.postmortem import rank_summary, sorted_ranks  # noqa: PLC0415

        lines.append(
            f"POSTMORTEM: crash bundle over {pm.get('n_ranks')} rank(s)"
            + (f" — {pm['bundle']}" if pm.get("bundle") else "")
        )
        for rank in sorted_ranks(pm.get("verdicts") or {}):
            lines.append(f"  rank {rank}: {rank_summary(pm, rank)}")
    for a in report.get("alerts", []):
        lines.append(
            f"alert: {a.get('rule')} fired at epoch {a.get('epoch')}"
            + (f" step {a.get('step')}" if a.get("step") is not None else "")
            + f" — {a.get('metric')} {a.get('value')} {a.get('op')} "
            f"threshold {a.get('threshold')} "
            f"(sustained {a.get('sustained')} window(s))"
        )
    for a in report.get("anomalies", []):
        lines.append(
            f"anomaly: epoch {a.get('epoch')} step {a.get('step')} "
            f"{a.get('anomaly')} value {a.get('value')}"
            + (
                f" ({a.get('ratio')}x rolling median {a.get('median')})"
                if a.get("ratio") is not None
                else ""
            )
        )
    for s in report["stragglers"]:
        lines.append(
            f"straggler: epoch {s.get('epoch')} process {s.get('worst_rank')} "
            f"at {s.get('skew')}x median ({s.get('max_s')}s vs {s.get('median_s')}s)"
        )
    for pr in report.get("profiles", []):
        if pr.get("event") == "stop":
            lines.append(
                f"profile: captured {pr.get('steps')} step(s) from global "
                f"step {pr.get('start_step')} ({pr.get('reason')}) → "
                f"{pr.get('dir')}"
            )
        elif pr.get("event") == "error":
            lines.append(
                f"profile: capture FAILED ({pr.get('reason')}): "
                f"{pr.get('error')}"
            )
    pas = report.get("profile_analyses") or []
    if pas:
        from tpu_dist_torch.obs import xprof as xprof_lib  # noqa: PLC0415

        lines.append("capture attribution (device seconds, obs/xprof.py):")
        cats = list(xprof_lib.CATEGORIES)
        lines.append(
            f"{'epoch':>5} {'reason':>16} {'busy_s':>9} "
            + " ".join(f"{c[:10]:>10}" for c in cats)
            + f" {'overlap':>8} {'infeed_s':>9}"
        )
        for pa in pas:
            if pa.get("error"):
                lines.append(
                    f"  epoch {pa.get('epoch')} ({pa.get('reason')}): "
                    f"analysis FAILED: {pa['error']}"
                )
                continue
            pc = pa.get("categories") or {}
            lines.append(
                f"{_fmt(pa.get('epoch'), 'd', 5)} "
                f"{str(pa.get('reason') or '-')[:16]:>16} "
                f"{_fmt(pa.get('device_busy_s'), '.4f', 9)} "
                + " ".join(_fmt(pc.get(c), ".4f", 10) for c in cats)
                + f" {_fmt(pa.get('overlap_frac'), '.1%', 8)}"
                + f" {_fmt(pa.get('infeed_stall_s'), '.4f', 9)}"
            )
            cal = pa.get("calibration") or {}
            if cal:
                body = ", ".join(
                    f"{k.split('calibration_', 1)[-1]}={v:g}"
                    if isinstance(v, (int, float)) else f"{k}={v}"
                    for k, v in sorted(cal.items())
                )
                lines.append(f"      calibration: {body}")
            if pa.get("dropped"):
                n = sum(pa["dropped"].values())
                lines.append(
                    f"      WARNING: {n} trace file(s) dropped during "
                    f"analysis ({pa['dropped']})"
                )
    sw = report.get("serve_windows") or []
    if sw:
        # the table through the ONE shared renderer (serve/slo.py —
        # jax-free): the offline serve report and this view can never
        # drift column by column
        from tpu_dist_torch.serve.slo import window_table_lines  # noqa: PLC0415

        lines.append("serving SLO windows (serve/slo.py, schema v10):")
        lines.extend(window_table_lines(sw))
    for ev in report.get("serve_events") or []:
        if ev.get("event") == "retrace":
            lines.append(
                f"serve: RETRACE on a bucket-{ev.get('bucket')} batch "
                f"({ev.get('n_real')} real request(s)) — the compiled "
                "forward saw a new shape mid-serve"
            )
    for mr in report.get("memory_records") or []:
        # the full ledger through the ONE shared renderer (obs/memory.py
        # — jax-free): summarize and the `obs memory` CLI cannot drift
        lines.append(memory_lib.format_ledger_text(mr))
    for o in report.get("oom_events") or []:
        lines.append(
            "OOM"
            + (f" at epoch {o['epoch']}" if o.get("epoch") is not None else "")
            + ": "
            + (
                memory_lib.oom_summary_line(o["oom"])
                if isinstance(o.get("oom"), dict) else "RESOURCE_EXHAUSTED"
            )
        )
    mem = report.get("memory")
    if mem and mem.get("peak_hbm_bytes") is not None:
        lines.append(
            f"peak HBM: {memory_lib.fmt_bytes(mem['peak_hbm_bytes'])} "
            "(worst chip — the compare gate's memory scalar)"
        )
    plan = report.get("plan")
    if plan:
        bits = [f"plan: {plan.get('family', '?')}"]
        if plan.get("mode"):
            bits.append(f"mode={plan['mode']}")
        if plan.get("predicted_step_s") is not None:
            bits.append(f"predicted {plan['predicted_step_s'] * 1e3:.3g} ms/step")
        if plan.get("achieved_step_s") is not None:
            bits.append(f"achieved {plan['achieved_step_s'] * 1e3:.3g} ms/step")
        if plan.get("planner_error_frac") is not None:
            bits.append(
                f"planner_error_frac={plan['planner_error_frac']:.4f}"
                " (TD119 — the compare gate's planner scalar)"
            )
        lines.append("  ".join(bits))
    gp_epochs = report.get("goodput_epochs") or []
    if gp_epochs:
        lines.append("goodput (seconds per window):")
        cols = [b for b in goodput_lib.ALL_BUCKETS]
        lines.append(
            f"{'epoch':>5} {'window':>8} "
            + " ".join(f"{c[:10]:>10}" for c in cols)
        )
        any_tail = False
        for g in gp_epochs:
            ep = g.get("epoch")
            tail = bool(g.get("tail"))
            any_tail = any_tail or tail
            ep_cell = (
                f"{_fmt(ep, 'd', 4)}*" if isinstance(ep, int) and tail
                else f"{_fmt(ep, 'd', 5)}" if isinstance(ep, int)
                else "    -"
            )
            lines.append(
                f"{ep_cell} "
                f"{_fmt(g.get('window_s'), '.2f', 8)} "
                + " ".join(_fmt(g.get(f"{c}_s"), ".2f", 10) for c in cols)
            )
        if any_tail:
            lines.append(
                "  (* run-end tail window: final save / writer drain / "
                "teardown, not an epoch)"
            )
    gp = report.get("goodput")
    if gp:
        lines.append(goodput_lib.ledger_line(gp))
    if report["auto_recoveries"]:
        lines.append(f"auto-recoveries: {report['auto_recoveries']}")
    t = report["totals"]
    lines.append(
        f"total: {t['total_train_time_s']}s train"
        + (f", mean {t['images_per_sec_mean']} img/s" if t["images_per_sec_mean"] else "")
        + (f", mean MFU {t['mfu_mean']}" if t.get("mfu_mean") else "")
    )
    cnt = t.get("counters") or {}
    if cnt:
        lines.append("final counters:")
        for k in sorted(cnt):
            lines.append(f"  {k} = {cnt[k]}")
    return "\n".join(lines)


def export_trace(records: List[dict]) -> dict:
    """Chrome trace-event JSON from a run's history: the ``spans`` records'
    drained events, plus synthesized epoch/eval bars (from each record's
    monotonic ``rel_s``) so even a span-less log yields a loadable
    timeline.

    Resumed runs append to the same log with a fresh ``run_id`` and a
    restarted clock (``rel_s`` and the span recorder both re-zero in the
    new process), so each run segment is shifted to start where the
    previous one ended: the viewer shows sequential segments, not two runs
    overlapping at ts≈0."""
    events: List[dict] = []
    offset_s = 0.0   # where the current segment's clock-zero sits globally
    seg_end_s = 0.0  # furthest global timestamp seen so far
    seen_run = False
    cur_run = None
    for rec in records:
        rid = rec.get("run_id")
        if not seen_run or rid != cur_run:
            if seen_run:
                offset_s = seg_end_s  # resume boundary: new clock origin
            cur_run, seen_run = rid, True
        kind = rec.get("kind")
        rel = rec.get("rel_s")
        if rel is not None:
            seg_end_s = max(seg_end_s, offset_s + float(rel))
        if kind == "spans" and isinstance(rec.get("events"), list):
            for e in rec["events"]:
                if not isinstance(e, dict):
                    continue
                e = {**e, "ts": round(float(e.get("ts", 0)) + offset_s * 1e6, 1)}
                events.append(e)
                seg_end_s = max(
                    seg_end_s, (e["ts"] + float(e.get("dur", 0))) / 1e6
                )
        if kind in ("train_epoch", "eval") and rel is not None:
            dur = float(rec.get("epoch_time") or 0.0) if kind == "train_epoch" else 0.0
            # the record is stamped at the END of the region
            ts = (offset_s + float(rel) - dur) * 1e6
            events.append(
                {
                    "name": f"{kind}/{rec.get('epoch')}",
                    "ph": "X",
                    "ts": round(max(ts, offset_s * 1e6), 1),
                    "dur": round(dur * 1e6, 1),
                    "pid": 0,
                    "tid": 0,
                    "args": {"kind": kind, "epoch": rec.get("epoch")},
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
