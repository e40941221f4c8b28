"""Pod-wide telemetry aggregation, ``python -m tpu_dist_torch.obs pod``: the
port's copy of ``tpu_dist/obs/aggregate.py``.

Every other report reads one process at a time; this module merges
per-host artifacts into one view:

* **Report** (:func:`pod_report`): each host's ``--log_file`` JSONL is
  folded through ``summarize``; the per-host goodput ledgers stand side by
  side, per-epoch cross-host skew comes from the epoch times the logs
  carry, and each straggling epoch is attributed to a phase (slow with a
  high data-stall fraction: the input pipeline; without: compute/other).
  Heartbeat files (``--heartbeat``) add a liveness row per host.
* **Trace** (:func:`pod_trace`): per-host Chrome traces
  (``summarize.export_trace``) merged into one Perfetto timeline, one
  ``pid`` track per host, aligned on the shared wall clock (each host's
  origin is ``ts - rel_s`` of its first record). Where a log carries
  ``tenancy`` snapshots, one more track is the chip-ownership Gantt: a row
  per chip, a bar per ownership stretch stamped with its ``decision_id``.
* **Decision chains** (:func:`decision_chains`): every artifact carrying
  one ``decision_id`` (the scheduler's moves, the relaunches' ``resume``
  records) folded into one chain line.

Per-host logs come from ``--per_host_log`` (``<log_file>.h<rank>``, rank 0
the bare path) or from separately collected logs of one run. The report,
the text and the trace are the JAX package's on the same files. Host file
crunching only.
"""

from __future__ import annotations

import time
from statistics import median
from typing import List, Optional, Tuple

from tpu_dist_torch.obs import goodput as goodput_lib
from tpu_dist_torch.obs import summarize as summ

#: A straggling epoch is attributed to the input pipeline when the slow
#: host's data-stall fraction exceeds the other hosts' median by this
#: many absolute points.
_STALL_ATTRIBUTION_MARGIN = 0.1


def _wall_origin(records: List[dict]) -> Optional[float]:
    """The host's clock-zero (Trainer construction) on the wall clock:
    ``ts - rel_s`` of the first record carrying both."""
    for rec in records:
        ts, rel = rec.get("ts"), rec.get("rel_s")
        if isinstance(ts, (int, float)) and isinstance(rel, (int, float)):
            return float(ts) - float(rel)
    return None


def epoch_skew_rows(hosts: List[Tuple[str, dict]]) -> List[dict]:
    """Cross-host skew per epoch, with phase attribution. ``hosts`` is
    ``[(name, summarize_report), ...]``."""
    by_epoch: dict = {}
    for name, rep in hosts:
        for row in rep.get("epochs", []):
            e = row.get("epoch")
            t = row.get("epoch_time_s")
            if e is None or not isinstance(t, (int, float)):
                continue
            by_epoch.setdefault(e, []).append((name, row))
    out: List[dict] = []
    for e in sorted(by_epoch):
        entries = by_epoch[e]
        if len(entries) < 2:
            continue
        times = [row["epoch_time_s"] for _, row in entries]
        med = median(times)
        worst_i = max(range(len(entries)), key=lambda i: times[i])
        worst_name, worst_row = entries[worst_i]
        skew = times[worst_i] / med if med > 0 else 1.0
        stalls = [
            row.get("data_stall_frac")
            for i, (_, row) in enumerate(entries)
            if i != worst_i and isinstance(row.get("data_stall_frac"), (int, float))
        ]
        worst_stall = worst_row.get("data_stall_frac")
        phase = "unknown"
        if isinstance(worst_stall, (int, float)) and stalls:
            phase = (
                "data_stall"
                if worst_stall - median(stalls) > _STALL_ATTRIBUTION_MARGIN
                else "compute/other"
            )
        out.append({
            "epoch": e,
            "hosts": len(entries),
            "median_s": round(med, 4),
            "max_s": round(times[worst_i], 4),
            "skew": round(skew, 4),
            "worst_host": worst_name,
            "worst_stall_frac": worst_stall,
            "attribution": phase,
        })
    return out


def heartbeat_rows(
    paths: List[str], now: Optional[float] = None
) -> List[dict]:
    """Liveness row per heartbeat file (``obs/heartbeat.py`` format):
    position + beat age. An absent file reads as a clean exit — that is
    the heartbeat contract, not an error."""
    from tpu_dist_torch.obs import heartbeat as heartbeat_lib  # stdlib-only

    now = time.time() if now is None else now
    out = []
    for path in paths:
        rec = heartbeat_lib.read(path)
        if rec is None:
            out.append({"file": path, "status": "absent (clean exit or not started)"})
            continue
        age = now - rec["ts"] if isinstance(rec.get("ts"), (int, float)) else None
        out.append({
            "file": path,
            "status": "present",
            "counter": rec.get("counter"),
            "epoch": rec.get("epoch"),
            "step": rec.get("step"),
            "phase": rec.get("phase"),
            "beat_age_s": round(age, 1) if age is not None else None,
        })
    return out


def decision_chains(hosts: List[dict]) -> List[dict]:
    """Fold every artifact stamped with the same ``decision_id`` (schema
    v15) into one causal chain: the scheduler's chip moves (a donate and
    its completion grant SHARE the id) joined with the relaunch
    ``resume`` records the decision caused on donor and recipient.
    ``hosts`` is the per-host dict list :func:`pod_report` builds. A
    chain with moves but no observed resume is surfaced as incomplete —
    that is exactly the "decision fired but nobody relaunched" bug the
    tracing exists to catch, so it must not be dropped."""
    chains: dict = {}

    def chain(did: int, cause: Optional[str]) -> dict:
        c = chains.setdefault(did, {
            "decision_id": did, "cause": None, "moves": [], "resumes": [],
        })
        if cause and not c["cause"]:
            c["cause"] = cause
        return c

    for h in hosts:
        for fd in h.get("fleet_decisions", []):
            did = fd.get("decision_id")
            if did is None:
                continue
            chain(did, fd.get("cause"))["moves"].append(
                {"host": h["host"], **fd}
            )
        for rs in h.get("resumes", []):
            did = rs.get("decision_id")
            if did is None:
                continue
            chain(did, rs.get("decision_cause"))["resumes"].append(
                {"host": h["host"], **rs}
            )
    out = []
    for did in sorted(chains):
        c = chains[did]
        c["moves"].sort(key=lambda m: (m.get("tick") or 0))
        c["complete"] = bool(c["moves"]) and bool(c["resumes"])
        out.append(c)
    return out


def pod_report(
    host_records: List[Tuple[str, List[dict]]],
    heartbeats: Optional[List[str]] = None,
) -> dict:
    """The merged cross-host report over ``[(host_name, records), ...]``."""
    hosts = []
    reports = []
    for name, records in host_records:
        rep = summ.summarize(records)
        reports.append((name, rep))
        gp = rep.get("goodput")
        hosts.append({
            "host": name,
            "run_id": rep.get("run_id"),
            "n_epochs": rep["totals"]["n_epochs"],
            "images_per_sec_mean": rep["totals"].get("images_per_sec_mean"),
            "goodput": gp,
            "stragglers": rep.get("stragglers", []),
            "anomalies": len(rep.get("anomalies", [])),
            "profiles": rep.get("profiles", []),
            "profile_analyses": rep.get("profile_analyses", []),
            "skipped_kinds": rep.get("skipped_kinds", {}),
            # elastic segment boundaries (schema v7): the pod's host set
            # is NOT fixed across segments — surface world-size changes
            "resumes": rep.get("resumes", []),
            "world_sizes": rep.get("world_sizes", []),
            # fleet-scheduler chip moves (schema v8) found in this log
            "fleet_decisions": rep.get("fleet_decisions", []),
            # per-tick chip accounting (schema v14) — the chip-ownership
            # Gantt's raw material
            "tenancy_snapshots": rep.get("tenancy_snapshots", []),
            # crash bundles (schema v9): how this host's run DIED
            "postmortems": rep.get("postmortems", []),
            # serving SLO windows (schema v10): this host's serving
            # latency/rate rollup — last window is the current state
            "serve_windows": rep.get("serve_windows", []),
            "serve_events": rep.get("serve_events", []),
            # the memory layer (schema v11): the host's peak-HBM rollup
            # + OOM events — the pod view's per-host memory skew input
            "memory": rep.get("memory"),
            "oom_events": rep.get("oom_events", []),
        })
    fracs = [
        h["goodput"]["goodput_frac"] for h in hosts
        if h.get("goodput") and isinstance(
            h["goodput"].get("goodput_frac"), (int, float)
        )
    ]
    worst = min(
        (h for h in hosts if h.get("goodput")),
        key=lambda h: h["goodput"].get("goodput_frac", 1.0),
        default=None,
    )
    peaks = [
        (h["host"], h["memory"]["peak_hbm_bytes"]) for h in hosts
        if h.get("memory")
        and isinstance(h["memory"].get("peak_hbm_bytes"), (int, float))
    ]
    return {
        "n_hosts": len(hosts),
        "hosts": hosts,
        "decision_chains": decision_chains(hosts),
        "epoch_skew": epoch_skew_rows(reports),
        "heartbeats": heartbeat_rows(heartbeats) if heartbeats else [],
        "pod": {
            "goodput_frac_min": min(fracs) if fracs else None,
            "goodput_frac_mean": (
                round(sum(fracs) / len(fracs), 4) if fracs else None
            ),
            "worst_goodput_host": worst["host"] if worst else None,
            # cross-host peak-HBM spread: one hot HOST (after the
            # per-chip skew inside each) is the pod's OOM risk
            "peak_hbm_bytes_max": max((p for _, p in peaks), default=None),
            "peak_hbm_bytes_min": min((p for _, p in peaks), default=None),
            "worst_hbm_host": (
                max(peaks, key=lambda hp: hp[1])[0] if peaks else None
            ),
        },
    }


def _chip_ownership_events(
    host_records: List[Tuple[str, List[dict]]],
    base: Optional[float],
    pid: int,
) -> List[dict]:
    """The per-chip ownership Gantt track, synthesized from the raw
    ``tenancy`` snapshots found in any host's log: one ``tid`` row per
    chip, one ``X`` bar per ownership stretch (a run's name, ``free``,
    or ``pending``), each bar stamped with the ``decision_id`` active at
    the tick that started it. Chips inside a tick are laid out
    deterministically — runs in name order, then free, then pending —
    so the SAME layout renders on every machine; a bar ends where the
    next tick's layout disagrees, and the last tick extends by the
    median tick interval so it is visible at all."""
    snaps: dict = {}
    for _, records in host_records:
        for rec in records:
            # dedup by tick — the same scheduler tick may be mirrored
            # into several hosts' logs
            if rec.get("kind") != "tenancy" or rec.get("tick") is None:
                continue
            snaps.setdefault(rec["tick"], rec)
    if not snaps:
        return []
    ordered = [snaps[t] for t in sorted(snaps)]
    times = [
        float(rec["ts"]) if isinstance(rec.get("ts"), (int, float)) else None
        for rec in ordered
    ]
    if any(t is None for t in times):
        # no wall clock on the snapshots (foreign tooling): render ticks
        # as seconds so the track still has shape
        ref = 0.0 if base is None else base
        times = [ref + float(rec.get("tick", i)) for i, rec in enumerate(ordered)]
    ref = min(times) if base is None else base
    deltas = sorted(b - a for a, b in zip(times, times[1:]) if b > a)
    tail = median(deltas) if deltas else 1.0
    total = max(int(rec.get("total_chips") or 0) for rec in ordered)
    if total <= 0:
        return []

    def layout(rec: dict) -> List[str]:
        lane: List[str] = []
        alloc = rec.get("alloc") or {}
        for run in sorted(alloc):
            lane += [run] * int(alloc[run])
        lane += ["free"] * int(rec.get("free") or 0)
        lane += ["pending"] * int(rec.get("pending") or 0)
        return (lane + ["?"] * total)[:total]

    layouts = [layout(rec) for rec in ordered]
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "chip ownership (tenancy)"},
    }]
    for chip in range(total):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": chip,
            "args": {"name": f"chip {chip}"},
        })
    n = len(ordered)
    for chip in range(total):
        i = 0
        while i < n:
            j = i
            while j + 1 < n and layouts[j + 1][chip] == layouts[i][chip]:
                j += 1
            t0 = times[i]
            t1 = times[j + 1] if j + 1 < n else times[j] + tail
            args = {"tick": ordered[i].get("tick")}
            if ordered[i].get("decision_id") is not None:
                args["decision_id"] = ordered[i]["decision_id"]
            events.append({
                "name": layouts[i][chip], "ph": "X", "cat": "tenancy",
                "pid": pid, "tid": chip,
                "ts": round((t0 - ref) * 1e6, 1),
                "dur": round(max(t1 - t0, 0.0) * 1e6, 1),
                "args": args,
            })
            i = j + 1
    return events


def pod_trace(host_records: List[Tuple[str, List[dict]]]) -> dict:
    """One Perfetto timeline with a track per host. Host i's events keep
    their own layout but move to ``pid=i``; tracks are aligned on the
    shared wall clock via each host's recovered origin so cross-host
    skew is visible as displacement. A final synthetic track renders the
    per-chip ownership Gantt whenever tenancy snapshots exist."""
    events: List[dict] = []
    origins = [
        _wall_origin(records) for _, records in host_records
    ]
    known = [o for o in origins if o is not None]
    base = min(known) if known else 0.0
    for i, (name, records) in enumerate(host_records):
        offset_us = ((origins[i] - base) if origins[i] is not None else 0.0) * 1e6
        events.append({
            "name": "process_name", "ph": "M", "pid": i, "tid": 0,
            "args": {"name": name},
        })
        for e in summ.export_trace(records)["traceEvents"]:
            events.append({
                **e,
                "pid": i,
                "ts": round(float(e.get("ts", 0.0)) + offset_us, 1),
            })
    events.extend(_chip_ownership_events(
        host_records,
        base if known else None,
        pid=len(host_records),
    ))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def format_text(report: dict) -> str:
    lines = [f"pod report — {report['n_hosts']} host(s)"]
    w = max([len(h["host"]) for h in report["hosts"]] + [4])
    cols = [b for b in goodput_lib.ALL_BUCKETS]
    lines.append("per-host goodput ledgers:")
    lines.append(
        f"  {'host'.ljust(w)} {'goodput':>8} {'elapsed':>9} "
        + " ".join(f"{c[:9]:>9}" for c in cols)
        + f" {'img/s':>9} {'seg':>4}"
    )

    def cell(v, spec, width):
        return (format(v, spec) if isinstance(v, (int, float)) else "-").rjust(width)

    for h in report["hosts"]:
        gp = h.get("goodput") or {}
        lines.append(
            f"  {h['host'].ljust(w)} "
            f"{cell(gp.get('goodput_frac'), '.1%', 8)} "
            f"{cell(gp.get('elapsed_s'), '.1f', 9)} "
            + " ".join(cell(gp.get(f"{c}_s"), ".1f", 9) for c in cols)
            + f" {cell(h.get('images_per_sec_mean'), '.1f', 9)}"
            + f" {cell(gp.get('n_segments'), 'd', 4)}"
        )
    # elastic segments: a world-size change mid-log means later epoch
    # rows ran on a DIFFERENT host/device set — the skew table and the
    # per-host ledgers must be read per segment, so say so explicitly
    for h in report["hosts"]:
        ws = h.get("world_sizes") or []
        if len(ws) > 1:
            resumes = h.get("resumes", [])
            grows = sum(
                1 for r in resumes
                if goodput_lib.resume_direction(r) == "grown"
            )
            lines.append(
                f"elastic on {h['host']}: world size dp "
                + " -> ".join(str(x) for x in ws)
                + " ("
                + str(sum(1 for r in resumes if r.get("resharded")))
                + " resharded resume(s)"
                + (f", {grows} grow(s)" if grows else "")
                + ") — host set not fixed across segments"
            )
    # fleet-scheduler decisions: chips moved BETWEEN runs on this pod —
    # the arbitration audit trail, rendered next to the runs it moved
    for h in report["hosts"]:
        for fd in h.get("fleet_decisions", []):
            lines.append(
                f"fleet ({h['host']}) tick {fd.get('tick')}: "
                + goodput_lib.fleet_move_phrase(fd)
                + (f" — {fd['reason']}" if fd.get("reason") else "")
            )
    # causal chains (schema v15): one line per decision_id answering
    # "why did run A shrink at tick N" end to end — the chip moves the
    # scheduler made under that id, then the relaunches it caused. The
    # per-move phrase drops its own [decision #N] suffix: the chain
    # header already names it.
    for c in report.get("decision_chains", []):
        steps = []
        for m in c.get("moves", []):
            steps.append(
                f"tick {m.get('tick')} {m.get('action')}: "
                + goodput_lib.fleet_move_phrase({**m, "decision_id": None})
            )
        for rs in c.get("resumes", []):
            step = f"{rs['host']} resumed dp={rs.get('dp')}"
            if rs.get("restarts") is not None:
                step += f" (restart #{rs['restarts']})"
            steps.append(step)
        lines.append(
            f"decision #{c['decision_id']}"
            + (f" [{c['cause']}]" if c.get("cause") else "")
            + (": " + " -> ".join(steps) if steps else "")
            + ("" if c.get("complete")
               else "  <-- no resume observed: chain INCOMPLETE")
        )
    # crash forensics (schema v9): a postmortem bundle in a host's log
    # means that run DIED hard — the pod view must lead with who crashed
    # and where it was stuck, not bury it under throughput rows
    for h in report["hosts"]:
        for pm in h.get("postmortems", []):
            from tpu_dist_torch.obs.postmortem import rank_summary, sorted_ranks

            lines.append(
                f"POSTMORTEM on {h['host']}: crash bundle over "
                f"{pm.get('n_ranks')} rank(s)"
                + (f" — {pm['bundle']}" if pm.get("bundle") else "")
            )
            for rank in sorted_ranks(pm.get("verdicts") or {}):
                lines.append(f"  rank {rank}: {rank_summary(pm, rank)}")
    # the memory layer (schema v11): per-host peak HBM + OOMs, and the
    # pod-level spread — the hottest host is the pod's OOM risk even
    # when every mean looks healthy
    mem_hosts = [
        h for h in report["hosts"]
        if h.get("memory") or h.get("oom_events")
    ]
    if mem_hosts:
        from tpu_dist_torch.obs import memory as memory_lib

        lines.append("per-host peak HBM (worst chip):")
        for h in mem_hosts:
            mem = h.get("memory") or {}
            ooms = h.get("oom_events") or []
            lines.append(
                f"  {h['host'].ljust(w)} "
                f"{memory_lib.fmt_bytes(mem.get('peak_hbm_bytes')):>10}"
                + (f"  {len(ooms)} OOM event(s)" if ooms else "")
            )
        pod = report.get("pod") or {}
        if isinstance(pod.get("peak_hbm_bytes_max"), (int, float)):
            spread = pod["peak_hbm_bytes_max"] - (
                pod.get("peak_hbm_bytes_min") or pod["peak_hbm_bytes_max"]
            )
            lines.append(
                f"  pod: max {memory_lib.fmt_bytes(pod['peak_hbm_bytes_max'])}"
                f" on {pod.get('worst_hbm_host')}"
                + (
                    f", cross-host spread {memory_lib.fmt_bytes(spread)}"
                    if spread else ""
                )
            )
    # per-host profiler captures: paths + the xprof analysis rollup, so
    # the pod view answers WHERE each capture lives and WHAT it said —
    # not just who heartbeats and who straggles
    for h in report["hosts"]:
        caps = [p for p in h.get("profiles", []) if p.get("event") == "stop"]
        analyses = {
            pa.get("dir"): pa for pa in h.get("profile_analyses", [])
        }
        fails = [p for p in h.get("profiles", []) if p.get("event") == "error"]
        if not caps and not fails:
            continue
        lines.append(f"captures on {h['host']}:")
        for p in caps:
            lines.append(
                f"  epoch {p.get('epoch')} ({p.get('reason')}): "
                f"{p.get('steps')} step(s) → {p.get('dir')}"
            )
            pa = analyses.get(p.get("dir"))
            if pa and not pa.get("error"):
                lines.append(
                    "    busy "
                    f"{cell(pa.get('device_busy_s'), '.3f', 0).strip()}s, "
                    "collectives "
                    f"{cell(pa.get('collective_frac'), '.0%', 0).strip()}, "
                    "overlap "
                    f"{cell(pa.get('overlap_frac'), '.0%', 0).strip()}, "
                    "infeed stall "
                    f"{cell(pa.get('infeed_stall_s'), '.3f', 0).strip()}s"
                )
            elif pa:
                lines.append(f"    analysis FAILED: {pa['error']}")
        for p in fails:
            lines.append(
                f"  epoch {p.get('epoch')} ({p.get('reason')}): capture "
                f"FAILED: {p.get('error')}"
            )
    # per-host serving rollup (schema v10): the LAST window is the
    # host's current SLO state; mid-serve retraces are called out
    for h in report["hosts"]:
        sw = h.get("serve_windows") or []
        if not sw:
            continue
        last = sw[-1]
        retraces = sum(
            1 for e in h.get("serve_events") or []
            if e.get("event") == "retrace"
        )
        lines.append(
            f"serving on {h['host']}: {len(sw)} window(s), last "
            f"{cell(last.get('requests_per_s'), '.1f', 0).strip()} req/s, "
            f"p99 {cell(last.get('latency_p99_ms'), '.2f', 0).strip()} ms, "
            "avail "
            f"{cell(last.get('availability'), '.3f', 0).strip()}"
            + (f" — {retraces} mid-serve RETRACE(S)" if retraces else "")
        )
    for s in report.get("epoch_skew", []):
        mark = " <-- STRAGGLER" if s["skew"] > 1.5 else ""
        lines.append(
            f"epoch {s['epoch']}: max/median skew {s['skew']}x "
            f"(worst {s['worst_host']}: {s['max_s']}s vs median "
            f"{s['median_s']}s, attribution: {s['attribution']}){mark}"
        )
    for hb in report.get("heartbeats", []):
        if hb.get("status") == "present":
            lines.append(
                f"heartbeat {hb['file']}: beat {hb.get('counter')} at epoch "
                f"{hb.get('epoch')} step {hb.get('step')} phase "
                f"{hb.get('phase')}, {hb.get('beat_age_s')}s old"
            )
        else:
            lines.append(f"heartbeat {hb['file']}: {hb['status']}")
    pod = report.get("pod", {})
    if pod.get("goodput_frac_mean") is not None:
        lines.append(
            f"pod goodput: mean {pod['goodput_frac_mean']:.1%}, min "
            f"{pod['goodput_frac_min']:.1%} "
            f"({pod['worst_goodput_host']})"
        )
    return "\n".join(lines)
