"""The longitudinal run archive: the port's copy of
``tpu_dist/obs/archive.py``, behind ``python -m tpu_dist_torch.obs
{archive,trend}``, ``compare --against-archive`` and ``hub --archive``.

* **ingest**: fold a run artifact into one append-only ``archive.jsonl``
  of schema-pinned ``archive_record_v1`` lines: bench JSONLs (and
  ``LAST_GOOD_BENCH.json``), the ``BENCH_*.json`` / ``MULTICHIP_*.json``
  run wrappers (a failed probe archives as an empty STALE record),
  ``--log_file`` histories (through the summary) and the schema-pinned
  analysis reports (``shard_report`` / ``plan_report`` / ``tune_report``).
  Each record carries a deterministic fingerprint (the bench capture
  identity, else a content hash) and ingest is idempotent by it. A record
  that declares itself ``stale`` or re-emits an archived capture is
  archived flagged STALE and kept out of every band. Scalars pass through
  :data:`compare.METRIC_DIRECTIONS`: only metrics with a direction gate;
  the rest are counted. Torn tails, newer schemas and foreign lines are
  counted, never fatal.
* **band gating** (:func:`gate_candidate`): a candidate against the
  rolling ``median ± max(k·MAD, rel_floor·|median|) + slack`` band of the
  last N non-stale records a metric; a better-than-band value is never
  flagged, and a gate whose every band is stale compares nothing (exit 2
  at the CLI, never a silent pass).
* **trend + blame** (:func:`trend_report`): per-metric series in archive
  order with an offline CUSUM changepoint detector; ``--blame`` names the
  first archived record after the shift.
* **probe** (:func:`inject_probe`): a synthetic worse-than-band candidate
  must come back REGRESSED, a better one clean, and an injected step in a
  synthetic series must be localized to its record; a dead detector is
  exit 2.

The records, reports and exit codes are the JAX package's on the same
files. Host file crunching only; formatters return strings, and printing
and exit codes belong to ``obs/__main__.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from tpu_dist_torch.obs import compare as compare_lib
from tpu_dist_torch.obs import summarize as summ

#: Schema tag every archived line carries; bumps are additive (a reader
#: of v1 reads a v2 line's known fields and counts it ``newer_schema``).
SCHEMA = "archive_record_v1"
SCHEMA_VERSION = 1

#: Rolling band: the last N non-stale records per (label, metric).
DEFAULT_WINDOW = 20

#: Band half-width in MADs (median absolute deviation).
DEFAULT_K = 3.0

#: The band is never narrower than this fraction of |median| — a young
#: archive (one fresh record per metric is exactly the seeded state) has
#: MAD 0, and a zero-width band would flag noise as regression.
REL_FLOOR = 0.05

#: CUSUM acceptance: the segment-mean shift must clear this many MADs of
#: the within-segment residual noise AND this fraction of |before-mean|.
CUSUM_Z = 4.0
CUSUM_REL_MIN = 0.01
CUSUM_MIN_SEG = 3


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _mad(vals: List[float], med: Optional[float] = None) -> float:
    m = _median(vals) if med is None else med
    return _median([abs(v - m) for v in vals])


def _registered_scalars(rec: dict) -> Tuple[Dict[str, float], int]:
    """The record's gateable scalars: numeric fields whose name has a
    direction in :data:`compare.METRIC_DIRECTIONS` (or a suffix
    default). Everything else is counted, never silently dropped."""
    out: Dict[str, float] = {}
    unregistered = 0
    for key, val in rec.items():
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        try:
            compare_lib.direction_of(key)
        except KeyError:
            unregistered += 1
            continue
        out[key] = val
    return out, unregistered


def _record(
    label: str, metrics: Dict[str, float], fingerprint: str, *,
    source: str, source_path: str, stale: bool = False,
    run_id: Optional[str] = None, unregistered: int = 0,
    meta: Optional[dict] = None,
) -> dict:
    return {
        "schema": SCHEMA,
        "label": label,
        "fingerprint": fingerprint,
        "run_id": run_id,
        "stale": bool(stale),
        "metrics": metrics,
        "unregistered_metrics": unregistered,
        "source": source,
        "source_path": source_path,
        "meta": meta or {},
    }


# -- per-source record builders ----------------------------------------------


def _capture_fp_str(rec: dict) -> Optional[str]:
    fp = compare_lib.capture_fingerprint(rec)
    if fp is None:
        return None
    return "capture:" + ":".join(str(x) for x in fp)


def record_from_bench(
    rec: dict, *, source_path: str, seen_captures: set,
) -> dict:
    """One bench record → one archive record. The fingerprint is the
    capture identity when stamped, a canonical content hash otherwise
    (pre-stamp legacy records like ``LAST_GOOD_BENCH.json``). A record
    that self-declares ``stale: true`` or re-emits a capture already in
    ``seen_captures`` is flagged STALE — and gets a content-suffixed
    fingerprint so the stale COPY archives as its own excluded record
    instead of dedup-colliding with the fresh original."""
    base = _capture_fp_str(rec) or ("content:" + _sha(
        json.dumps(rec, sort_keys=True))[:16])
    reemitted = base.startswith("capture:") and base in seen_captures
    stale = bool(rec.get("stale")) or reemitted
    if base.startswith("capture:") and not stale:
        seen_captures.add(base)
    fingerprint = base
    if stale:
        fingerprint = base + ":stale:" + _sha(
            json.dumps(rec, sort_keys=True))[:8]
    metrics, unregistered = _registered_scalars(rec)
    meta = {
        k: rec[k]
        for k in ("unit", "captured_date", "captured_round", "hardware",
                  "age_days", "note")
        if k in rec
    }
    if reemitted:
        meta["reemitted_capture"] = True
    return _record(
        str(rec.get("metric") or "bench"), metrics, fingerprint,
        source="bench", source_path=source_path, stale=stale,
        unregistered=unregistered, meta=meta,
    )


def _bench_lines_from_tail(tail: str) -> List[dict]:
    """The driver wrapper's captured stdout: any full line that parses
    as a JSON object with a ``metric`` key is a bench record (the
    ``bench: emitted stale...`` stderr echo does not start with ``{``,
    so the same record is not double-counted)."""
    out: List[dict] = []
    for line in (tail or "").splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("metric"):
            out.append(rec)
    return out


def records_from_driver_bench(
    data: dict, *, source_path: str, seen_captures: set,
) -> List[dict]:
    """A ``BENCH_r0N.json`` driver wrapper (``{n, cmd, rc, tail,
    parsed}``). The embedded bench records (``parsed`` when the driver
    parsed one, otherwise JSON lines fished out of ``tail``) archive as
    bench records stamped with the round; a wrapper holding NO bench
    record archives as one empty STALE ``bench_probe`` record — the
    empty trajectory is committed evidence, not a silent gap."""
    parsed = data.get("parsed")
    if isinstance(parsed, dict) and parsed.get("metric"):
        bench_recs = [parsed]
    elif isinstance(parsed, list):
        bench_recs = [r for r in parsed
                      if isinstance(r, dict) and r.get("metric")]
    else:
        bench_recs = _bench_lines_from_tail(data.get("tail", ""))
    rnd = data.get("n")
    if not bench_recs:
        name = os.path.basename(source_path)
        fingerprint = (
            f"driver:{name}:n={rnd}:rc={data.get('rc')}:"
            + _sha(str(data.get("tail", "")))[:12]
        )
        return [_record(
            "bench_probe", {}, fingerprint,
            source="driver_bench", source_path=source_path, stale=True,
            meta={"round": rnd, "rc": data.get("rc"), "empty": True},
        )]
    out = []
    for rec in bench_recs:
        ar = record_from_bench(
            rec, source_path=source_path, seen_captures=seen_captures,
        )
        ar["source"] = "driver_bench"
        ar["meta"]["round"] = rnd
        ar["meta"]["rc"] = data.get("rc")
        out.append(ar)
    return out


def record_from_multichip(data: dict, *, source_path: str) -> dict:
    """A ``MULTICHIP_r0N.json`` driver wrapper (``{n_devices, rc, ok,
    skipped, tail}``) → one pass/fail point on the multichip axis."""
    name = os.path.basename(source_path)
    fingerprint = (
        f"multichip:{name}:" + _sha(json.dumps(data, sort_keys=True))[:12]
    )
    metrics = {"multichip_ok": 1.0 if data.get("ok") else 0.0}
    return _record(
        "multichip_dryrun", metrics, fingerprint,
        source="multichip", source_path=source_path,
        stale=bool(data.get("skipped")),
        meta={"n_devices": data.get("n_devices"), "rc": data.get("rc")},
    )


def record_from_history(path: str) -> dict:
    """A ``--log_file`` JSONL → one archive record over the summarize
    report's scalars. The fingerprint is the stamped capture identity
    (``summarize.capture_stamp`` — a content hash, so re-summarizing
    the same log dedupes)."""
    records, bad = summ.load_records(path)
    if not records:
        raise ValueError(f"no records in {path}")
    report = summ.summarize(records, bad)
    stamp = summ.capture_stamp(path)
    scalars = compare_lib.report_scalars(report)
    metrics = {
        k: v for k, v in scalars.items()
        if not k.startswith("_") and isinstance(v, (int, float))
        and not isinstance(v, bool)
    }
    return _record(
        "history", metrics, "history:" + stamp["fingerprint"],
        source="history", source_path=path, run_id=report.get("run_id"),
        meta={"n_records": len(records), "bad_lines": bad},
    )


def record_from_report(data: dict, *, source_path: str) -> dict:
    """A schema-pinned analysis report (``shard_report`` /
    ``plan_report`` / ``tune_report``): every registered scalar found
    anywhere in the tree archives under the report's schema tag."""
    tag = str(data.get("schema"))
    metrics: Dict[str, float] = {}
    unregistered = 0

    def walk(node):
        nonlocal unregistered
        if isinstance(node, dict):
            found, skipped = _registered_scalars(node)
            unregistered += skipped
            for k, v in found.items():
                metrics.setdefault(k, v)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(data)
    name = os.path.basename(source_path)
    fingerprint = (
        f"report:{name}:" + _sha(json.dumps(data, sort_keys=True))[:12]
    )
    return _record(
        tag.rsplit("_v", 1)[0], metrics, fingerprint,
        source="report", source_path=source_path,
        unregistered=unregistered, meta={"schema": tag},
    )


def hub_snapshot_record(
    snapshot: dict, *, fingerprint: str, source_path: str = "<hub>",
) -> dict:
    """One :class:`TelemetryHub` collect() snapshot → one archive record
    (``obs hub --archive``): the pod rollups become gateable series, so
    fleet goodput / breach count / chip capacity trend like any bench
    metric. The caller owns the fingerprint (one per scrape interval)."""
    roll = snapshot.get("rollup") or {}
    metrics: Dict[str, float] = {}
    for src, name in (
        ("runs_dead", "pod_runs_dead"),
        ("breach_count", "pod_breach_count"),
        ("total_chips", "pod_total_chips"),
        ("worst_stall_frac", "pod_worst_stall_frac"),
    ):
        v = roll.get(src)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            metrics[name] = v
    for kind, v in (roll.get("goodput_by_kind") or {}).items():
        if kind in ("train", "serve") and isinstance(v, (int, float)):
            metrics[f"pod_goodput_frac_{kind}"] = v
    return _record(
        "pod", metrics, fingerprint,
        source="hub", source_path=source_path,
        meta={
            "scrapes": snapshot.get("scrapes"),
            "runs_aggregated": roll.get("runs_aggregated"),
            "drops": snapshot.get("drops"),
        },
    )


# -- archive file I/O --------------------------------------------------------


def load_archive(path: str) -> Tuple[List[dict], dict]:
    """Torn-tail-tolerant, forward-compat archive loader: returns
    ``(records, counts)`` where counts reports ``bad_lines`` (torn /
    non-JSON), ``skipped_schema`` (lines that are not archive records at
    all), and ``newer_schema`` (``archive_record_v2+`` lines — read by
    their known fields, per the house additive-bump contract)."""
    counts = {"bad_lines": 0, "skipped_schema": 0, "newer_schema": 0}
    records: List[dict] = []
    if not os.path.exists(path):
        return records, counts
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                counts["bad_lines"] += 1
                continue
            if not isinstance(rec, dict):
                counts["bad_lines"] += 1
                continue
            tag = rec.get("schema")
            if not isinstance(tag, str) or \
                    not tag.startswith("archive_record_v"):
                counts["skipped_schema"] += 1
                continue
            try:
                ver = int(tag.rsplit("v", 1)[1])
            except ValueError:
                counts["skipped_schema"] += 1
                continue
            if ver > SCHEMA_VERSION:
                counts["newer_schema"] += 1
            records.append(rec)
    return records, counts


def append_records(path: str, records: List[dict]) -> None:
    """Append-only write, healing a torn tail first: if the file does
    not end in a newline (the previous writer died mid-line), a newline
    is inserted so the torn fragment stays isolated on its own line
    (counted by the loader) instead of corrupting the first new record."""
    if not records:
        return
    needs_nl = False
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell():
                f.seek(-1, os.SEEK_END)
                needs_nl = f.read(1) != b"\n"
    except OSError:
        needs_nl = False
    payload = "".join(json.dumps(r, sort_keys=True) + "\n" for r in records)
    # tpu-dist: ignore[TD002] — the archive is appended by the single ingest/CLI/hub process
    with open(path, "a") as f:
        if needs_nl:
            f.write("\n")
        f.write(payload)


# -- ingest ------------------------------------------------------------------


def _classify_json(data) -> str:
    if isinstance(data, dict):
        if data.get("metric"):
            return "bench"
        if "parsed" in data and "rc" in data and "cmd" in data:
            return "driver_bench"
        if "n_devices" in data and "rc" in data and "ok" in data:
            return "multichip"
        tag = data.get("schema")
        if isinstance(tag, str) and tag.startswith(
            ("shard_report", "plan_report", "tune_report")
        ):
            return "report"
    raise ValueError("unrecognized JSON artifact shape")


def records_from_path(path: str, *, seen_captures: set) -> List[dict]:
    """Classify one input artifact and build its archive record(s).
    Raises OSError on an unreadable file and ValueError on a shape no
    ingester recognizes — the CLI maps both to exit 2."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
        whole = True
    except json.JSONDecodeError:
        whole = False
    if whole:
        kind = _classify_json(data)
        if kind == "bench":
            return [record_from_bench(
                data, source_path=path, seen_captures=seen_captures,
            )]
        if kind == "driver_bench":
            return records_from_driver_bench(
                data, source_path=path, seen_captures=seen_captures,
            )
        if kind == "multichip":
            return [record_from_multichip(data, source_path=path)]
        return [record_from_report(data, source_path=path)]
    # JSONL: a history (kind-keyed) or a bench stream (metric-keyed)
    kinds = 0
    metrics = 0
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("kind"):
            kinds += 1
        elif rec.get("metric"):
            metrics += 1
    if kinds:
        return [record_from_history(path)]
    if metrics:
        return [
            record_from_bench(
                rec, source_path=path, seen_captures=seen_captures,
            )
            for rec in compare_lib._load_bench_list(path)
        ]
    raise ValueError(f"{path}: neither a JSON artifact nor a JSONL "
                     "history/bench stream this ingester recognizes")


def ingest_records(
    records: List[dict], archive_path: str, *, source_path: str = "<api>",
) -> dict:
    """Ingest already-loaded bench records (the ``bench.py --archive``
    self-ingest path). Same idempotence as :func:`ingest_paths`."""
    existing, counts = load_archive(archive_path)
    known = {r.get("fingerprint") for r in existing}
    by_fp = {r.get("fingerprint"): r for r in existing}
    seen_captures = _archived_captures(existing)
    fresh: List[dict] = []
    deduped = 0
    for rec in records:
        ar = record_from_bench(
            rec, source_path=source_path, seen_captures=seen_captures,
        )
        if _dedupe_or_keep(ar, known, by_fp):
            deduped += 1
            continue
        fresh.append(ar)
    _assign_seq(existing, fresh)
    append_records(archive_path, fresh)
    return {
        "archive": archive_path, "appended": len(fresh),
        "deduped": deduped, "records_seen": len(records), **counts,
    }


def _is_rearchival(ar: dict, archived: Optional[dict]) -> bool:
    """A record flagged as a capture re-emission that is actually a
    byte-equivalent RE-INGEST of the archived fresh record (same label,
    metrics, provenance) is a dedupe, not a stale copy — otherwise
    ingest idempotence would mint a spurious STALE record per pass."""
    if archived is None or archived.get("stale"):
        return False
    meta = {k: v for k, v in (ar.get("meta") or {}).items()
            if k != "reemitted_capture"}
    return (
        ar.get("label") == archived.get("label")
        and ar.get("metrics") == archived.get("metrics")
        and ar.get("unregistered_metrics")
        == archived.get("unregistered_metrics")
        and meta == (archived.get("meta") or {})
    )


def _dedupe_or_keep(
    ar: dict, known: set, by_fp: Dict[str, dict],
) -> bool:
    """True when ``ar`` is already archived (by fingerprint, or as the
    fresh original a flagged re-emission byte-matches)."""
    fp = ar["fingerprint"]
    if fp in known:
        return True
    if ar.get("meta", {}).get("reemitted_capture") and _is_rearchival(
        ar, by_fp.get(fp.split(":stale:")[0])
    ):
        return True
    known.add(fp)
    by_fp[fp] = ar
    return False


def _archived_captures(existing: List[dict]) -> set:
    out = set()
    for r in existing:
        fp = r.get("fingerprint")
        if isinstance(fp, str) and fp.startswith("capture:"):
            # strip any :stale:<hash> suffix back to the capture identity
            out.add(fp.split(":stale:")[0])
    return out


def _assign_seq(existing: List[dict], fresh: List[dict]) -> None:
    nxt = 1 + max(
        [r.get("seq", 0) for r in existing
         if isinstance(r.get("seq"), int)] + [len(existing)],
    ) if existing else 1
    for i, r in enumerate(fresh):
        r["seq"] = nxt + i


def ingest_paths(
    paths: List[str], archive_path: str,
) -> dict:
    """The ``archive ingest`` engine: classify every input, build its
    records, drop the ones whose fingerprint is already archived
    (idempotence), append the rest. Per-input accounting in the report —
    an input that fails to read or classify raises (exit 2 at the CLI);
    nothing is half-appended before the error because the append is one
    batch at the end."""
    existing, counts = load_archive(archive_path)
    known = {r.get("fingerprint") for r in existing}
    by_fp = {r.get("fingerprint"): r for r in existing}
    seen_captures = _archived_captures(existing)
    fresh: List[dict] = []
    inputs = []
    deduped = 0
    seen_total = 0
    for path in paths:
        recs = records_from_path(path, seen_captures=seen_captures)
        added = 0
        for ar in recs:
            seen_total += 1
            if _dedupe_or_keep(ar, known, by_fp):
                deduped += 1
                continue
            fresh.append(ar)
            added += 1
        inputs.append({
            "path": path, "records": len(recs), "appended": added,
            "stale": sum(1 for r in recs if r.get("stale")),
        })
    _assign_seq(existing, fresh)
    append_records(archive_path, fresh)
    return {
        "archive": archive_path, "inputs": inputs,
        "records_seen": seen_total, "appended": len(fresh),
        "deduped": deduped,
        "stale_appended": sum(1 for r in fresh if r.get("stale")),
        **counts,
    }


def format_ingest_text(report: dict) -> str:
    lines = [
        f"archive {report['archive']}: {report['appended']} appended"
        + (f" ({report['stale_appended']} STALE)"
           if report.get("stale_appended") else "")
        + (f", {report['deduped']} already archived (deduped)"
           if report["deduped"] else "")
        + (f", {report['bad_lines']} torn line(s)"
           if report.get("bad_lines") else "")
        + (f", {report['newer_schema']} newer-schema record(s) read"
           if report.get("newer_schema") else "")
    ]
    for i in report.get("inputs", []):
        lines.append(
            f"  {i['path']}: {i['records']} record(s), "
            f"{i['appended']} appended"
            + (f", {i['stale']} STALE" if i["stale"] else "")
        )
    return "\n".join(lines)


# -- MAD-band gating ---------------------------------------------------------


def band_for(
    records: List[dict], label: str, metric: str, *,
    window: int = DEFAULT_WINDOW,
) -> Optional[dict]:
    """The rolling band: median and MAD over the last ``window``
    non-stale archived values of (label, metric). None when no fresh
    record carries it."""
    vals = [
        r["metrics"][metric]
        for r in records
        if not r.get("stale") and r.get("label") == label
        and isinstance(r.get("metrics"), dict)
        and isinstance(r["metrics"].get(metric), (int, float))
        and not isinstance(r["metrics"].get(metric), bool)
    ]
    vals = vals[-window:]
    if not vals:
        return None
    med = _median(vals)
    return {"n": len(vals), "median": med, "mad": _mad(vals, med)}


def _has_stale(records: List[dict], label: str, metric: str) -> bool:
    return any(
        r.get("stale") and r.get("label") == label
        and isinstance(r.get("metrics"), dict)
        and metric in r["metrics"]
        for r in records
    )


def _gate_row(
    name: str, label: str, metric: str, cand, records: List[dict], *,
    k: float, window: int, rel_floor: float, cand_stale: bool = False,
) -> dict:
    if cand_stale:
        return {"metric": name, "baseline": "band", "candidate":
                "stale capture", "verdict": "STALE"}
    if not isinstance(cand, (int, float)) or isinstance(cand, bool):
        return {"metric": name, "baseline": "band", "candidate": cand,
                "verdict": "skipped"}
    b = band_for(records, label, metric, window=window)
    if b is None:
        if _has_stale(records, label, metric):
            # every archived point for this metric is a stale
            # re-emission — there is no band, and pretending the stale
            # numbers are one would be exactly the wound this archive
            # exists to close
            return {"metric": name, "baseline": "all archived records "
                    "STALE", "candidate": cand, "verdict": "STALE"}
        return {"metric": name, "baseline": None, "candidate": cand,
                "verdict": "skipped"}
    direction, slack = compare_lib.direction_of(metric)
    med, mad = b["median"], b["mad"]
    allowed = max(k * mad, rel_floor * abs(med)) + slack
    worse_by = (med - cand) if direction == "higher" else (cand - med)
    row = {
        "metric": name,
        "baseline": med,
        "candidate": cand,
        "band_n": b["n"],
        "mad": round(mad, 6),
        "allowed": round(allowed, 6),
        "delta": round(cand - med, 6),
        "verdict": "REGRESSED" if worse_by > allowed else "ok",
    }
    if med:
        row["delta_frac"] = round((cand - med) / abs(med), 4)
    return row


def gate_candidate(
    records: List[dict], candidate: str, *, bench: bool = False,
    k: float = DEFAULT_K, window: int = DEFAULT_WINDOW,
    rel_floor: float = REL_FLOOR,
) -> dict:
    """Gate a candidate artifact against the archive's rolling bands.

    ``bench=True``: the candidate is a bench JSONL — each record's
    registered fields gate against the (metric-label, field) band; a
    candidate record that self-declares stale or re-emits an archived
    capture fingerprint is a STALE row, never compared. Otherwise the
    candidate is a ``--log_file`` history gating its summarize scalars
    against the ``history`` label's bands."""
    rows: List[dict] = []
    archived_caps = _archived_captures(records)
    if bench:
        cand_map = compare_lib.load_bench_records(candidate)
        for name in sorted(cand_map):
            rec = cand_map[name]
            cap = _capture_fp_str(rec)
            cand_stale = bool(rec.get("stale")) or (
                cap is not None and cap in archived_caps
            )
            fields, _skipped = _registered_scalars(rec)
            if cand_stale:
                rows.append(_gate_row(
                    name, name, "value", None, records,
                    k=k, window=window, rel_floor=rel_floor,
                    cand_stale=True,
                ))
                continue
            for field in sorted(fields):
                rows.append(_gate_row(
                    f"{name}.{field}", name, field, fields[field],
                    records, k=k, window=window, rel_floor=rel_floor,
                ))
    else:
        scalars = compare_lib.load_history_scalars(candidate)
        for key in sorted(scalars):
            if key.startswith("_"):
                continue
            rows.append(_gate_row(
                key, "history", key, scalars[key], records,
                k=k, window=window, rel_floor=rel_floor,
            ))
    result = compare_lib._result(rows, threshold=rel_floor)
    result.update(band_k=k, band_window=window, candidate=candidate)
    return result


def gate_files(
    archive_path: str, candidate: str, *, bench: bool = False,
    k: float = DEFAULT_K, window: int = DEFAULT_WINDOW,
    rel_floor: float = REL_FLOOR,
) -> dict:
    """CLI engine for ``obs compare --against-archive``. Raises OSError
    on an unreadable file, ValueError on an empty archive — both exit 2
    at the CLI (a gate with no archive is broken, not passing)."""
    records, counts = load_archive(archive_path)
    if not records:
        raise ValueError(f"no archive records in {archive_path}")
    result = gate_candidate(
        records, candidate, bench=bench, k=k, window=window,
        rel_floor=rel_floor,
    )
    result["archive"] = archive_path
    result["archive_records"] = len(records)
    result["archive_counts"] = counts
    return result


def format_gate_text(result: dict) -> str:
    lines = [
        f"archive gate: candidate {result['candidate']} vs "
        f"{result['archive']} ({result['archive_records']} record(s), "
        f"band median ± max({result['band_k']:g}·MAD, "
        f"{result['threshold'] * 100:g}%·|median|) + slack, "
        f"window {result['band_window']})"
    ]
    w = max([len(r["metric"]) for r in result["rows"]] + [6])

    def cell(v):
        if isinstance(v, float):
            return format(v, ".6g").rjust(12)
        return str(v if v is not None else "-").rjust(12)

    lines.append(
        f"  {'metric'.ljust(w)} {'band median':>12} {'candidate':>12} "
        f"{'allowed':>10} {'n':>3}  verdict"
    )
    for r in result["rows"]:
        lines.append(
            f"  {r['metric'].ljust(w)} {cell(r.get('baseline'))} "
            f"{cell(r.get('candidate'))} "
            f"{cell(r.get('allowed'))[-10:]:>10} "
            f"{str(r.get('band_n', '-')):>3}  {r['verdict']}"
        )
    lines.append(
        f"archive gate: {result['regressions']} regression(s) over "
        f"{result['compared']} compared metric(s)"
        + (f", {result['skipped']} skipped" if result["skipped"] else "")
        + (f", {result['stale']} STALE" if result.get("stale") else "")
    )
    return "\n".join(lines)


# -- trend + changepoint blame -----------------------------------------------


def detect_changepoint(
    values: List[float], *, min_seg: int = CUSUM_MIN_SEG,
    z: float = CUSUM_Z, rel_min: float = CUSUM_REL_MIN,
) -> Optional[dict]:
    """Offline CUSUM split: the candidate changepoint is the index
    maximizing |cumulative deviation from the global mean|; it is
    accepted when the segment-mean shift clears ``z`` MADs of the
    within-segment residual noise AND ``rel_min`` of |before-mean| (so
    float dust on a flat series never flags). Returns ``{"index": i,
    ...}`` where ``i`` is the FIRST index of the shifted segment."""
    m = len(values)
    if m < 2 * min_seg:
        return None
    mean_all = sum(values) / m
    s = 0.0
    best_t: Optional[int] = None
    best = 0.0
    for t in range(m - 1):
        s += values[t] - mean_all
        if min_seg - 1 <= t <= m - min_seg - 1 and abs(s) > best:
            best, best_t = abs(s), t
    if best_t is None:
        return None
    before, after = values[:best_t + 1], values[best_t + 1:]
    mb = sum(before) / len(before)
    ma = sum(after) / len(after)
    resid = [v - mb for v in before] + [v - ma for v in after]
    noise = _mad(resid)
    shift = abs(ma - mb)
    if shift <= z * noise or shift <= rel_min * abs(mb):
        return None
    return {
        "index": best_t + 1,
        "before_mean": round(mb, 6),
        "after_mean": round(ma, 6),
        "shift": round(ma - mb, 6),
        "n_before": len(before),
        "n_after": len(after),
    }


def trend_report(
    records: List[dict], *, metric: Optional[str] = None,
    window: Optional[int] = None,
) -> dict:
    """Per-(label, metric) series in archive order (non-stale points
    only — stale re-emissions are counted, never plotted as data), each
    with its changepoint verdict and, when one fired, the BLAME: the
    first archived record after the shift, by fingerprint + run_id +
    source path. ``metric`` filters by metric name; ``window`` keeps
    only the trailing points."""
    by_key: Dict[Tuple[str, str], List[dict]] = {}
    n_stale: Dict[Tuple[str, str], int] = {}
    for r in records:
        label = r.get("label")
        mets = r.get("metrics")
        if not isinstance(mets, dict):
            continue
        for name, val in mets.items():
            if metric is not None and name != metric:
                continue
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            key = (str(label), name)
            if r.get("stale"):
                n_stale[key] = n_stale.get(key, 0) + 1
                continue
            by_key.setdefault(key, []).append({
                "seq": r.get("seq"),
                "value": val,
                "fingerprint": r.get("fingerprint"),
                "run_id": r.get("run_id"),
                "source_path": r.get("source_path"),
            })
    series = []
    for (label, name), points in sorted(by_key.items()):
        if window:
            points = points[-window:]
        values = [p["value"] for p in points]
        cp = detect_changepoint(values)
        entry = {
            "label": label,
            "metric": name,
            "n": len(points),
            "n_stale": n_stale.get((label, name), 0),
            "values": values,
            "points": points,
            "changepoint": cp,
        }
        if cp is not None:
            try:
                direction, _slack = compare_lib.direction_of(name)
                worse = (cp["shift"] < 0) if direction == "higher" \
                    else (cp["shift"] > 0)
                cp["kind"] = "regressed" if worse else "improved"
            except KeyError:
                cp["kind"] = "shifted"
            cp["blame"] = points[cp["index"]]
        series.append(entry)
    # stale-only metrics still show up (counted), so an archive of pure
    # re-emissions renders as "no fresh data", never as an empty page
    for key, count in sorted(n_stale.items()):
        if key not in by_key:
            series.append({
                "label": key[0], "metric": key[1], "n": 0,
                "n_stale": count, "values": [], "points": [],
                "changepoint": None,
            })
    return {"series": series, "n_records": len(records)}


def format_trend_text(report: dict, *, blame: bool = False) -> str:
    lines = [f"trend over {report['n_records']} archived record(s):"]
    for s in report["series"]:
        head = f"  {s['label']}.{s['metric']}: {s['n']} point(s)"
        if s["n_stale"]:
            head += f" (+{s['n_stale']} STALE excluded)"
        if s["values"]:
            vmin, vmax = min(s["values"]), max(s["values"])
            last = s["values"][-1]
            head += (f"  min {vmin:.6g}  max {vmax:.6g}  last {last:.6g}")
        lines.append(head)
        cp = s.get("changepoint")
        if cp is not None:
            lines.append(
                f"    changepoint [{cp.get('kind', 'shifted')}] at point "
                f"{cp['index']}: mean {cp['before_mean']:.6g} -> "
                f"{cp['after_mean']:.6g} (shift {cp['shift']:+.6g})"
            )
            if blame:
                b = cp["blame"]
                lines.append(
                    "    blame: first shifted record is "
                    f"fingerprint {b.get('fingerprint')} "
                    f"(run_id {b.get('run_id')}, seq {b.get('seq')}, "
                    f"source {b.get('source_path')})"
                )
    return "\n".join(lines)


# -- the injected-fault probe ------------------------------------------------


def inject_probe(
    records: List[dict], *, k: float = DEFAULT_K,
    window: int = DEFAULT_WINDOW, rel_floor: float = REL_FLOOR,
    max_bands: int = 8,
) -> dict:
    """The ``--inject-regression`` probe: against the archive's
    own bands, a synthetic candidate pushed past the allowance in the
    WORSE direction must come back REGRESSED and one pushed the same
    distance in the BETTER direction must come back clean; against a
    synthetic flat series with one injected step, the changepoint
    detector must localize the exact record. A detector that misses any
    of the three is DEAD — the CLI maps that to exit 2."""
    bands: List[dict] = []
    seen_keys: set = set()
    for r in records:
        if r.get("stale") or not isinstance(r.get("metrics"), dict):
            continue
        for name in r["metrics"]:
            key = (r.get("label"), name)
            if key in seen_keys:
                continue
            seen_keys.add(key)
            b = band_for(records, key[0], name, window=window)
            if b is not None:
                bands.append({"label": key[0], "metric": name, **b})
    bands = bands[:max_bands]
    gate_results = []
    missed = flagged_improvement = 0
    for b in bands:
        direction, slack = compare_lib.direction_of(b["metric"])
        allowed = max(k * b["mad"], rel_floor * abs(b["median"])) + slack
        delta = allowed + max(0.05 * abs(b["median"]), 1e-6)
        sign = -1.0 if direction == "higher" else 1.0
        worse = b["median"] + sign * delta
        better = b["median"] - sign * delta
        row_worse = _gate_row(
            b["metric"], b["label"], b["metric"], worse, records,
            k=k, window=window, rel_floor=rel_floor,
        )
        row_better = _gate_row(
            b["metric"], b["label"], b["metric"], better, records,
            k=k, window=window, rel_floor=rel_floor,
        )
        caught = row_worse["verdict"] == "REGRESSED"
        clean = row_better["verdict"] == "ok"
        missed += not caught
        flagged_improvement += not clean
        gate_results.append({
            "label": b["label"], "metric": b["metric"],
            "injected_worse": worse, "injected_better": better,
            "caught": caught, "improvement_clean": clean,
        })
    # synthetic changepoint: 8 flat points, then a 10% step down —
    # the detector must name index 8's record, exactly
    step_at = 8
    synth_records = []
    for i in range(step_at + 6):
        v = 100.0 if i < step_at else 90.0
        synth_records.append(_record(
            "synthetic", {"value": v}, f"synthetic:{i}",
            source="probe", source_path="<inject-probe>",
        ))
        synth_records[-1]["seq"] = i
    synth_trend = trend_report(synth_records, metric="value")
    cp = synth_trend["series"][0]["changepoint"] if \
        synth_trend["series"] else None
    localized = (
        cp is not None and cp["index"] == step_at
        and cp.get("blame", {}).get("fingerprint") == f"synthetic:{step_at}"
        and cp.get("kind") == "regressed"
    )
    return {
        "bands_probed": len(bands),
        "gate_probe": (
            "caught" if bands and not missed else
            "dead" if bands else "no-bands"
        ),
        "improvements_clean": not flagged_improvement,
        "changepoint_probe": "localized" if localized else "dead",
        "changepoint": cp,
        "gate_results": gate_results,
    }


def format_probe_text(probe: dict) -> str:
    lines = [
        f"inject-regression probe: {probe['bands_probed']} band(s) — "
        f"gate {probe['gate_probe']}, improvements "
        f"{'clean' if probe['improvements_clean'] else 'WRONGLY FLAGGED'}"
        f", changepoint {probe['changepoint_probe']}"
    ]
    for g in probe["gate_results"]:
        lines.append(
            f"  {g['label']}.{g['metric']}: injected "
            f"{g['injected_worse']:.6g} -> "
            f"{'caught' if g['caught'] else 'MISSED'}; improvement "
            f"{g['injected_better']:.6g} -> "
            f"{'clean' if g['improvement_clean'] else 'FLAGGED'}"
        )
    return "\n".join(lines)


def probe_is_dead(probe: dict) -> bool:
    """True when any leg of the injected-fault probe failed — the
    archive gate or the changepoint detector would silently pass real
    regressions (exit 2 at the CLI)."""
    return (
        probe["gate_probe"] != "caught"
        or not probe["improvements_clean"]
        or probe["changepoint_probe"] != "localized"
    )


# -- hub integration ---------------------------------------------------------


def append_hub_snapshot(
    path: str, snapshot: dict, *, now: Optional[float] = None,
) -> dict:
    """Append one pod-rollup record per hub interval (``obs hub
    --archive``): the fingerprint is host+pid+scrape-count(+time), so a
    looped hub archives one record per pass and a restarted hub never
    collides with its predecessor's lines."""
    import socket
    import time as time_lib

    t = time_lib.time() if now is None else now
    fingerprint = (
        f"hub:{socket.gethostname()}:{os.getpid()}:"
        f"{snapshot.get('scrapes', 0)}:{t:.3f}"
    )
    rec = hub_snapshot_record(
        snapshot, fingerprint=fingerprint, source_path=path,
    )
    rec["meta"]["time"] = round(t, 3)
    existing, _counts = load_archive(path)
    _assign_seq(existing, [rec])
    append_records(path, [rec])
    return rec
