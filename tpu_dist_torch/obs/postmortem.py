"""``obs postmortem``: per-rank crash-forensics bundles. The port's copy
of ``tpu_dist/obs/postmortem.py``; the bundle, the history record and the
text are the JAX package's.

After a crash or a wedge the evidence lies in per-rank files that
different parts left behind: the flight ring and the faulthandler stack
dumps of a crash directory (``obs/flight.py``), a heartbeat left
un-swept, the last OpenMetrics exposition, ``oom.json``, and the
history JSONL. :func:`discover` walks a set of directories and groups
the files by rank (the ``.h<k>`` naming of ``heartbeat.per_rank_path``);
:func:`assemble` folds them into one report a rank:

* the decoded ring tail, its torn slots, and its last ``step`` record
  (where the rank was when it stopped writing),
* the parsed stack dump and its stuck frame,
* the last heartbeat, the last exposition's key gauges and active alerts,
* the OOM report (``oom.json``, or re-parsed from the ring's fatal slot),
* a verdict: ``clean``, ``failed``, ``preempted``, ``interrupted``,
  ``fatal``, ``oom``, ``no-clean-exit`` (a ring that just stops, or a
  heartbeat left behind: a hard kill or a wedge) or ``unknown``.

The replica supervisor (``serve/supervisor.py``) calls
:func:`run_postmortem` after a crash or a wedge, appending one
``postmortem`` record to the replica's history. Host file crunching
only::

    python -m tpu_dist_torch.obs postmortem <dir> [<dir> ...]
        [--out bundle.json] [--annotate] [--tail N] [--format text|json]

Exit codes: 0 bundle assembled, 1 no forensic artifacts found in the
given dirs, 2 unreadable input.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import heartbeat as heartbeat_lib
from tpu_dist_torch.obs import memory as memory_lib
from tpu_dist_torch.obs import summarize as summ

#: Default bundle file name (written into the first scanned dir).
BUNDLE_NAME = "postmortem.json"

#: ``postmortem`` records stamp the current history schema
#: (``metrics/history.py::SCHEMA_VERSION``; v9 introduced this kind).
POSTMORTEM_SCHEMA_VERSION = 15

#: Artifact stems recognized during discovery; each may carry the
#: ``.h<k>`` per-rank suffix. History files are any ``*.jsonl``.
_HB_STEM = "hb.json"
_METRICS_STEM = "metrics.prom"

_RANK_SUFFIX_RE = re.compile(r"^(?P<stem>.+?)\.h(?P<rank>\d+)$")


def _split_rank(name: str) -> Tuple[str, int]:
    m = _RANK_SUFFIX_RE.match(name)
    if m:
        return m.group("stem"), int(m.group("rank"))
    return name, 0


def discover(dirs: List[str]) -> dict:
    """Walk the given dirs (non-recursive) and group forensic artifacts
    by rank: ``{"rings": {rank: path}, "stacks": {...}, "heartbeats":
    {...}, "expositions": {...}, "histories": {rank: path}, "ooms":
    {rank: path}, "scanned": [dirs that existed]}``. First occurrence of
    a (kind, rank) wins — pass the most authoritative dir first."""
    rings: Dict[int, str] = {}
    stacks: Dict[int, str] = {}
    hbs: Dict[int, str] = {}
    expos: Dict[int, str] = {}
    hists: Dict[int, str] = {}
    ooms: Dict[int, str] = {}
    scanned: List[str] = []
    for d in dirs:
        try:
            entries = sorted(os.listdir(d))
        except OSError:
            continue
        scanned.append(d)
        for entry in entries:
            stem, rank = _split_rank(entry)
            path = os.path.join(d, entry)
            if stem == flight_lib.RING_NAME:
                rings.setdefault(rank, path)
            elif stem == flight_lib.STACKS_NAME:
                stacks.setdefault(rank, path)
            elif stem == memory_lib.OOM_NAME:
                ooms.setdefault(rank, path)
            elif stem == _HB_STEM or (
                stem.endswith(".json") and "hb" in stem.split(".")[0]
            ):
                hbs.setdefault(rank, path)
            elif stem == _METRICS_STEM or stem.endswith(".prom"):
                expos.setdefault(rank, path)
            elif stem.endswith(".jsonl"):
                hists.setdefault(rank, path)
    return {
        "rings": rings, "stacks": stacks, "heartbeats": hbs,
        "expositions": expos, "histories": hists, "ooms": ooms,
        "scanned": scanned,
    }


def _ring_section(path: str, tail: int) -> Optional[dict]:
    try:
        dec = flight_lib.decode(path)
    except OSError:
        return {"file": path, "error": "unreadable"}
    last = flight_lib.last_step(dec)
    fatals = flight_lib.fatal_records(dec)
    recs = dec["records"]
    return {
        "file": path,
        "header": dec.get("header"),
        "n_records": len(recs),
        "torn_slots": dec["torn_slots"],
        "records": recs[-tail:],
        "last": dec.get("last"),
        "last_step": last,
        "fatal": fatals[-1] if fatals else None,
    }


def _stack_section(path: str) -> Optional[dict]:
    parsed = flight_lib.read_stack_dump(path)
    if parsed is None:
        return None
    return {
        "file": path,
        "n_dumps": parsed["n_dumps"],
        "n_threads": len(parsed["threads"]),
        "threads": [
            {
                "name": t.get("name"),
                "current": t["current"],
                "top": (
                    f"{t['frames'][0][2]} "
                    f"({t['frames'][0][0]}:{t['frames'][0][1]})"
                    if t["frames"] else None
                ),
            }
            for t in parsed["threads"]
        ],
        "stuck_frame": flight_lib.stuck_frame(parsed),
    }


def _exposition_section(path: str) -> Optional[dict]:
    vals = export_lib.scrape(textfile=path)
    if not vals:
        return None
    out = {"file": path, "gauges": export_lib.key_gauges(vals)}
    active = export_lib.active_labels(vals)
    if active:
        out["active_alerts"] = active
    return out


def _fatal_oom(ring: Optional[dict]) -> Optional[dict]:
    """The parsed OOM report hiding in a ring's fatal slot, when the
    fatal message (truncated to the slot budget) still carries the
    RESOURCE_EXHAUSTED signature — the fallback when the full
    ``oom.json`` artifact was lost with the filesystem."""
    fatal = (ring or {}).get("fatal")
    if not fatal:
        return None
    text = f"{fatal.get('error')}: {fatal.get('message')}"
    return memory_lib.parse_resource_exhausted(text)


def _verdict(ring: Optional[dict], stack: Optional[dict],
             heartbeat: Optional[dict], oom: Optional[dict] = None) -> str:
    """Classify how the rank ended. A ring whose terminal record is
    ``exit``/``preempt``/``interrupt`` ended on its own terms; one that
    just stops (plus a left-behind heartbeat) is the wedge/hard-kill
    signature ``obs postmortem`` exists for. A rank whose ``oom``
    section was resolved (a left-behind ``oom.json``, or the fatal slot
    re-parsed by the caller via :func:`_fatal_oom`) gets the distinct
    ``oom`` verdict (obs/memory.py): the fix is sharding/batch math,
    not a stack trace."""
    if oom is not None:
        return "oom"
    if ring and ring.get("fatal"):
        return "fatal"
    last = (ring or {}).get("last") or {}
    kind = last.get("kind")
    if kind == "exit":
        return "clean" if last.get("clean") else "failed"
    if kind == "preempt":
        return "preempted"
    if kind == "interrupt":
        return "interrupted"
    if ring and ring.get("n_records"):
        return "no-clean-exit"
    if heartbeat is not None:
        return "no-clean-exit"
    return "unknown"


def assemble(
    dirs: List[str], *, tail: int = 40, history_tail: int = 20,
) -> dict:
    """The bundle: one per-rank report over everything :func:`discover`
    found, plus the shared history tail. Tolerates every per-artifact
    failure (a half-written file is the expected input here)."""
    found = discover(dirs)
    ranks = sorted(
        set(found["rings"]) | set(found["stacks"]) | set(found["heartbeats"])
        | set(found["expositions"]) | set(found["ooms"])
    )
    rank_reports: List[dict] = []
    for rank in ranks:
        ring = (
            _ring_section(found["rings"][rank], tail)
            if rank in found["rings"] else None
        )
        stack = (
            _stack_section(found["stacks"][rank])
            if rank in found["stacks"] else None
        )
        hb = (
            heartbeat_lib.read(found["heartbeats"][rank])
            if rank in found["heartbeats"] else None
        )
        expo = (
            _exposition_section(found["expositions"][rank])
            if rank in found["expositions"] else None
        )
        # the full OOM artifact (parsed allocation report + the ledger
        # snapshot live at the crash) when the rank wrote one; else the
        # report re-parsed out of the ring's truncated fatal slot
        oom = (
            memory_lib.read_oom_report(found["ooms"][rank])
            if rank in found["ooms"] else None
        )
        if oom is None:
            parsed = _fatal_oom(ring)
            if parsed is not None:
                oom = {"oom": parsed, "source": "flight_ring"}
        rank_reports.append({
            "rank": rank,
            "verdict": _verdict(ring, stack, hb, oom),
            "flight": ring,
            "stack": stack,
            "heartbeat": hb,
            "exposition": expo,
            **({"oom": oom} if oom is not None else {}),
        })
    histories = []
    for rank in sorted(found["histories"]):
        path = found["histories"][rank]
        try:
            records, bad = summ.load_records(path)
        except OSError:
            histories.append({"rank": rank, "file": path,
                              "error": "unreadable"})
            continue
        histories.append({
            "rank": rank,
            "file": path,
            "n_records": len(records),
            "bad_lines": bad,
            "run_id": next(
                (r["run_id"] for r in reversed(records) if r.get("run_id")),
                None,
            ),
            "tail": records[-history_tail:],
        })
    return {
        "generated_ts": round(time.time(), 3),
        "scanned_dirs": found["scanned"],
        "n_ranks": len(rank_reports),
        "ranks": rank_reports,
        "histories": histories,
    }


def write_bundle(report: dict, out_path: str) -> str:
    # tpu-dist: ignore[TD002] — postmortem tooling runs in the single watchdog/CLI process
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    return out_path


def history_record(report: dict, bundle_path: Optional[str]) -> dict:
    """The compact ``postmortem`` history record (schema v9): enough for a
    summary of the history to render the crash without re-reading the
    bundle."""
    verdicts = {str(r["rank"]): r["verdict"] for r in report["ranks"]}
    stuck = {
        str(r["rank"]): r["stack"]["stuck_frame"]
        for r in report["ranks"]
        if r.get("stack") and r["stack"].get("stuck_frame")
    }
    fatal = {
        str(r["rank"]): (
            f"{r['flight']['fatal'].get('error')}: "
            f"{r['flight']['fatal'].get('message')}"
        )
        for r in report["ranks"]
        if r.get("flight") and r["flight"].get("fatal")
    }
    last_steps = {
        str(r["rank"]): {
            k: r["flight"]["last_step"].get(k) for k in ("epoch", "step")
        }
        for r in report["ranks"]
        if r.get("flight") and r["flight"].get("last_step")
    }
    ooms = {
        str(r["rank"]): memory_lib.oom_summary_line(r["oom"]["oom"])
        for r in report["ranks"]
        if isinstance(r.get("oom"), dict)
        and isinstance(r["oom"].get("oom"), dict)
    }
    rec = {
        "n_ranks": report["n_ranks"],
        "verdicts": verdicts,
    }
    if bundle_path:
        rec["bundle"] = bundle_path
    if stuck:
        rec["stuck_frames"] = stuck
    if fatal:
        rec["fatal"] = fatal
    if ooms:
        rec["oom"] = ooms
    if last_steps:
        rec["last_steps"] = last_steps
    return rec


def sorted_ranks(mapping: dict) -> List[str]:
    """Rank keys of a ``postmortem`` record's per-rank dicts, NUMERICALLY
    ordered (they are JSON string keys — a lexicographic sort would print
    0,1,10,11,...,2 on a 16-rank pod). ONE home for the ordering every
    renderer (summarize/tail/pod) shares."""
    return sorted(
        mapping,
        key=lambda r: (
            not str(r).isdigit(),
            int(r) if str(r).isdigit() else 0,
            str(r),
        ),
    )


def rank_summary(rec: dict, rank: str) -> str:
    """One line for one rank of a ``postmortem`` history record —
    ``'fatal, stuck in get (loader.py:118), flight ring ends at epoch 2
    step 3'``. ONE formatter shared by ``obs summarize``/``tail``/``pod``
    so the three renderings can never drift."""
    verdict = (rec.get("verdicts") or {}).get(rank, "unknown")
    stuck = (rec.get("stuck_frames") or {}).get(rank)
    fatal = (rec.get("fatal") or {}).get(rank)
    oom = (rec.get("oom") or {}).get(rank)
    ls = (rec.get("last_steps") or {}).get(rank) or {}
    return (
        str(verdict)
        + (f", stuck in {stuck}" if stuck else "")
        + (f", {oom}" if oom else (f", fatal {fatal}" if fatal else ""))
        + (
            f", flight ring ends at epoch {ls.get('epoch')} step "
            f"{ls.get('step')}" if ls else ""
        )
    )


def append_history_record(report: dict, bundle_path: Optional[str],
                          history_path: str) -> dict:
    """Append the ``postmortem`` record to the run's JSONL in the
    MetricsHistory line format (the supervisor's path: the crash lands in
    the same log the process was writing)."""
    rec = {
        "ts": round(time.time(), 3),
        "schema_version": POSTMORTEM_SCHEMA_VERSION,
        "kind": "postmortem",
        **history_record(report, bundle_path),
    }
    # tpu-dist: ignore[TD002] — single watchdog/CLI process (see above)
    with open(history_path, "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
    return rec


def run_postmortem(
    dirs: List[str], *, out: Optional[str] = None, annotate: bool = False,
    tail: int = 40,
) -> Tuple[dict, Optional[str]]:
    """The whole path (the replica supervisor and the CLI): assemble, write the
    bundle next to the evidence, optionally annotate the discovered
    primary history. Returns ``(report, bundle_path)``; ``bundle_path``
    is None when nothing at all was found (no bundle worth writing)."""
    report = assemble(dirs, tail=tail)
    if not report["ranks"] and not report["histories"]:
        return report, None
    bundle = out or os.path.join(
        (report["scanned_dirs"] or dirs)[0], BUNDLE_NAME
    )
    write_bundle(report, bundle)
    if annotate:
        primary = next(
            (h["file"] for h in report["histories"]
             if h.get("rank") == 0 and not h.get("error")),
            None,
        )
        if primary:
            append_history_record(report, bundle, primary)
    return report, bundle


def format_text(report: dict) -> str:
    lines = [
        f"postmortem — {report['n_ranks']} rank(s) across "
        f"{len(report.get('scanned_dirs') or [])} dir(s)"
    ]
    for r in report["ranks"]:
        lines.append(f"rank {r['rank']}: {r['verdict'].upper()}")
        ring = r.get("flight")
        if ring:
            if ring.get("error"):
                lines.append(f"  flight ring: {ring['error']} ({ring['file']})")
            else:
                ls = ring.get("last_step")
                lines.append(
                    f"  flight ring: {ring['n_records']} record(s)"
                    + (
                        f", {ring['torn_slots']} torn slot(s)"
                        if ring.get("torn_slots") else ""
                    )
                    + (
                        f" — last step epoch {ls.get('epoch')} step "
                        f"{ls.get('step')}" if ls else " — no step record"
                    )
                )
                fatal = ring.get("fatal")
                if fatal:
                    lines.append(
                        f"  fatal: {fatal.get('error')}: "
                        f"{fatal.get('message')}"
                    )
                    for fr in fatal.get("frames") or []:
                        lines.append(f"    {fr}")
                last = ring.get("last") or {}
                if last.get("kind") in ("exit", "preempt", "interrupt"):
                    lines.append(f"  terminal record: {last['kind']}")
        stack = r.get("stack")
        if stack:
            lines.append(
                f"  stack dump: {stack['n_threads']} thread(s), "
                f"{stack['n_dumps']} dump(s)"
                + (
                    f" — stuck in {stack['stuck_frame']}"
                    if stack.get("stuck_frame") else ""
                )
            )
            for t in stack["threads"]:
                if not t["current"] and t.get("top"):
                    lines.append(
                        f"    thread {t.get('name') or '?'}: {t['top']}"
                    )
        oom = r.get("oom")
        if isinstance(oom, dict) and isinstance(oom.get("oom"), dict):
            for ln in memory_lib.format_oom_text(oom["oom"]).splitlines():
                lines.append(f"  {ln}")
            led = oom.get("ledger")
            if isinstance(led, dict):
                lines.append("  " + memory_lib.summary_line(led))
        hb = r.get("heartbeat")
        if hb:
            lines.append(
                f"  heartbeat left behind: beat {hb.get('counter')} at "
                f"epoch {hb.get('epoch')} step {hb.get('step')} phase "
                f"{hb.get('phase')!r}"
            )
        expo = r.get("exposition")
        if expo:
            gauges = ", ".join(
                f"{k} {v}" for k, v in (expo.get("gauges") or {}).items()
            )
            lines.append(f"  last exposition: {gauges or '(empty)'}")
            if expo.get("active_alerts"):
                lines.append(
                    "  active alerts: " + ", ".join(expo["active_alerts"])
                )
    for h in report.get("histories", []):
        if h.get("error"):
            lines.append(f"history {h['file']}: {h['error']}")
            continue
        lines.append(
            f"history {h['file']}: {h['n_records']} record(s)"
            + (f", {h['bad_lines']} torn line(s)" if h.get("bad_lines") else "")
            + (f", run {h['run_id']}" if h.get("run_id") else "")
        )
        for rec in (h.get("tail") or [])[-5:]:
            lines.append(
                f"  [{rec.get('rel_s')}] {rec.get('kind')}"
                + (
                    f" epoch {rec.get('epoch')}"
                    if rec.get("epoch") is not None else ""
                )
            )
    return "\n".join(lines)
