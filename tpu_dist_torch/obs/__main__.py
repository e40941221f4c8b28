"""CLI: ``python -m tpu_dist_torch.obs`` — offline run-telemetry reports;
the port's counterpart of ``python -m tpu_dist.obs``.

Subcommands::

    summarize <run.jsonl> [--format text|json]
        The run's report (``obs/summarize.py``): the per-epoch table, the
        device stats, anomalies, stragglers, profiler captures and their
        attribution, goodput, serving windows, resumes and fleet
        decisions, the final counters. Exit 1 when the file holds no
        record. With ``--bench`` the input is a ``bench.py`` output (one
        JSON object a line): a record a row with its capture fingerprint,
        re-emitted captures and bench's own ``stale: true`` flagged STALE;
        exit 1 when it holds no bench record.

    xprof <capture_dir | trace.json[.gz]> [--top K] [--format text|json]
        Device-time attribution of a ``torch.profiler`` capture
        (``obs/xprof.py``): seconds by category, collectives by kind, the
        comm/compute overlap, infeed stall, the top ops. Exit 1 when the
        capture has nothing to attribute (a ``CaptureError``), 2 when the
        path cannot be read.

    tail <run.jsonl> [--heartbeat hb.json] [--interval S] [--once] [--rows N]
        Follow a live run (``obs/tail.py``): a rolling per-epoch table
        (throughput, p50, stall, MFU, goodput), the latest alert, anomaly,
        straggler, resume, fleet, serving, memory and postmortem lines and
        a heartbeat liveness row; torn tails tolerated. Exits 0 when the
        run's closing record lands; ``--once`` renders once (exit 1 when
        the log holds no record).

    compare <baseline.jsonl> <candidate.jsonl> [--threshold 0.05]
            [--bench] [--goodput] [--slo] [--format text|json]
    compare <candidate> --against-archive <archive.jsonl> [--bench]
            [--band-k 3.0] [--band-window 20] [--format text|json]
        Regression gate over two history JSONLs (``obs/compare.py``):
        throughput, step-time percentiles, stall fraction, MFU, final
        metrics and goodput; ``--goodput`` restricts it to the
        time-to-useful-work metrics, ``--slo`` to the serving SLO metrics
        of the ``serve`` records (lower latency is never flagged); with
        ``--bench`` the two inputs are ``bench.py`` outputs, matched by
        metric name, and a record that re-emits the baseline's capture (or
        says ``stale: true``) is STALE, compared not at all. Exit 1
        on a regression beyond the threshold, 2 when nothing compared.
        With ``--against-archive`` the one input (a history, or with
        ``--bench`` a bench output) gates against the archive's rolling
        median ± k·MAD bands (``obs/archive.py``); a band of STALE records
        only, or no band at all, is exit 2.

    archive ingest <artifact> [<artifact> ...] [--archive archive.jsonl]
        Fold run artifacts (bench JSONLs, ``BENCH_*.json`` /
        ``MULTICHIP_*.json`` wrappers, ``--log_file`` histories, shard /
        plan / tune reports) into one append-only archive of
        ``archive_record_v1`` lines (``obs/archive.py``), idempotent by
        fingerprint, stale re-emissions flagged. Exit 1 when the inputs
        held nothing archivable, 2 when one cannot be read or classified.

    trend <archive.jsonl> [--metric NAME] [--window N] [--blame]
          [--inject-regression] [--format text|json]
        Per-metric series over the archive with a CUSUM changepoint
        detector; ``--blame`` names the first archived record after each
        shift. ``--inject-regression`` probes the gate and the detector:
        exit 2 when either is dead.

    pod <host0.jsonl> <host1.jsonl> ... [--heartbeat hb.json ...]
        [--trace-out pod_trace.json] [--format text|json]
        Cross-host aggregation (``obs/aggregate.py``): per-host goodput
        ledgers side by side, per-epoch skew with its attribution, the
        decision chains, heartbeat liveness, captures and serving rollups;
        ``--trace-out`` writes one merged Perfetto trace, a track per host
        and the chip-ownership track.

    postmortem <dir> [<dir> ...] [--out bundle.json] [--annotate]
        [--tail N] [--format text|json]
        Crash forensics (``obs/postmortem.py``): flight rings, stack
        dumps, left-behind heartbeats, expositions, ``oom.json`` files and
        history JSONLs folded into one bundle with a verdict a rank.
        ``--annotate`` appends a ``postmortem`` record to the rank-0
        history found. Exit 1 when the dirs hold no forensic artifacts.

    memory <run.jsonl> [--format text|json]
    memory --oom <traceback.txt> [--format text|json]
        The memory report (``obs/memory.py``): the run's ledger snapshots
        (the static per-leaf accounting, the first step's waterfall, the
        census reconciled with the allocator), the per-epoch ``mem.*``
        gauges, OOM events and the ``peak_hbm_bytes`` scalar the compare
        gate reads. With ``--oom`` the input is a raw out-of-memory text
        (XLA's ``RESOURCE_EXHAUSTED`` or PyTorch's CUDA message), parsed
        into the typed report. Exit 1 when the history holds no memory
        telemetry (or the text no OOM signature).

    export-trace <run.jsonl> [-o trace.json]
        Chrome trace-event JSON (Perfetto / chrome://tracing) from the
        run's drained spans and synthesized epoch and eval bars (default
        output ``<log>.trace.json``). Exit 1 when the file holds no record.

    hub --run name=metrics_path[,hb=...][,port=P][,kind=train|serve] ...
        [--fleet fleet.prom] [--out FILE] [--port P] [--interval S]
        [--once] [--stale-after S]
        The pod telemetry hub (``obs/hub.py``): every run's exposition
        relabelled ``{run=...}`` on one page, with the hub's drop counts
        and the pod rollups; ``--once`` prints (or ``--out`` writes) one
        pass and exits 1 when no run could be read, else it publishes
        every ``--interval`` to ``--out`` and ``GET /metrics`` on
        ``--port`` until interrupted. ``--archive PATH`` appends one
        pod-rollup archive record a pass.

Exit codes: 0 ok, 1 empty/unusable input (or, for ``compare``, a
regression), 2 bad invocation or I/O error. File crunching
only: no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.obs",
        description="offline run-telemetry reports over history JSONLs and crash dirs",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="per-epoch throughput/latency/counter report")
    s.add_argument("log", help="JSONL history written by --log_file")
    s.add_argument("--format", choices=("text", "json"), default="text")
    s.add_argument("--bench", action="store_true",
                   help="input is a bench.py JSON (one record per line): a row a record with "
                        "its capture fingerprint; re-emitted captures are flagged STALE")
    xp = sub.add_parser(
        "xprof",
        help="device-time attribution of a torch.profiler capture",
    )
    xp.add_argument("capture", help="capture directory, or one trace .json[.gz] file")
    xp.add_argument("--top", type=int, default=10, metavar="K",
                    help="top-K ops by self time (default 10)")
    xp.add_argument("--format", choices=("text", "json"), default="text")
    tl = sub.add_parser("tail", help="follow a live run: rolling epoch table + alerts")
    tl.add_argument("log", help="the run's --log_file JSONL (may still be growing)")
    tl.add_argument("--heartbeat", default=None, metavar="FILE",
                    help="the run's --heartbeat_file for a liveness row")
    tl.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="poll and redraw interval (default 2 s)")
    tl.add_argument("--once", action="store_true",
                    help="render the current state once and exit")
    tl.add_argument("--rows", type=int, default=None, metavar="N",
                    help="epochs kept in the rolling table")
    c = sub.add_parser(
        "compare",
        help="regression gate: diff two runs' telemetry, exit 1 on regression",
    )
    c.add_argument("baseline", help="baseline history JSONL (or bench JSON with --bench); with "
                                    "--against-archive the one candidate input")
    c.add_argument("candidate", nargs="?", default=None,
                   help="candidate history JSONL (or bench JSON with --bench); omitted "
                        "with --against-archive")
    c.add_argument(
        "--threshold", type=float, default=0.05, metavar="FRAC",
        help="relative regression tolerance (default 0.05 = 5%%); each "
             "metric adds its own absolute noise slack on top",
    )
    c.add_argument("--bench", action="store_true",
                   help="inputs are bench.py JSON outputs (one object per line), matched by "
                        "their 'metric' name")
    c.add_argument("--goodput", action="store_true",
                   help="gate on the time-to-useful-work metrics only")
    c.add_argument("--slo", action="store_true",
                   help="gate on the serving SLO metrics only (serve records)")
    c.add_argument("--against-archive", default=None, metavar="ARCHIVE",
                   dest="against_archive",
                   help="gate the one candidate against this archive's rolling median ± "
                        "k·MAD bands instead of one baseline")
    c.add_argument("--band-k", type=float, default=None, metavar="K",
                   help="band half-width in MADs (--against-archive; default 3.0)")
    c.add_argument("--band-window", type=int, default=None, metavar="N",
                   help="band over the last N non-stale records (--against-archive; "
                        "default 20)")
    c.add_argument("--format", choices=("text", "json"), default="text")
    ar = sub.add_parser(
        "archive",
        help="longitudinal run archive: fold run artifacts into one append-only "
             "fingerprinted archive.jsonl",
    )
    ar.add_argument("action", choices=("ingest",),
                    help="'ingest' folds the given artifacts in (idempotent by fingerprint)")
    ar.add_argument("inputs", nargs="+",
                    help="artifacts: bench JSONLs, BENCH_*.json / MULTICHIP_*.json wrappers, "
                         "--log_file histories, shard/plan/tune reports")
    ar.add_argument("--archive", "-a", default="archive.jsonl", metavar="PATH",
                    help="the archive JSONL to append to (default archive.jsonl)")
    ar.add_argument("--format", choices=("text", "json"), default="text")
    tr = sub.add_parser(
        "trend",
        help="per-metric series over the archive, CUSUM changepoints, --blame, "
             "--inject-regression",
    )
    tr.add_argument("archive", help="the archive JSONL (archive ingest)")
    tr.add_argument("--metric", default=None, help="render only this metric's series")
    tr.add_argument("--window", type=int, default=None, metavar="N",
                    help="keep only the trailing N points a series")
    tr.add_argument("--blame", action="store_true",
                    help="name the first archived record after each detected shift")
    tr.add_argument("--inject-regression", action="store_true", dest="inject_regression",
                    help="probe: injected past-band candidates must be caught, improvements "
                         "clean, an injected changepoint localized; a dead detector exits 2")
    tr.add_argument("--format", choices=("text", "json"), default="text")
    pd = sub.add_parser("pod", help="merge per-host logs into one cross-host report / timeline")
    pd.add_argument("logs", nargs="+", help="per-host JSONL histories")
    pd.add_argument("--heartbeat", action="append", default=[], metavar="FILE",
                    help="per-host heartbeat file(s) for liveness rows")
    pd.add_argument("--trace-out", default=None, metavar="PATH",
                    help="also write one merged Perfetto trace (a track per host)")
    pd.add_argument("--format", choices=("text", "json"), default="text")
    pm = sub.add_parser(
        "postmortem",
        help="assemble per-rank crash-forensics bundles from a run's leftover files",
    )
    pm.add_argument("dirs", nargs="+",
                    help="directories to scan; the first receives the bundle by default")
    pm.add_argument("--out", default=None, metavar="PATH",
                    help="bundle output path (default <first dir>/postmortem.json)")
    pm.add_argument("--annotate", action="store_true",
                    help="append a 'postmortem' record to the rank-0 history found")
    pm.add_argument("--tail", type=int, default=40, metavar="N",
                    help="ring records kept per rank in the bundle")
    pm.add_argument("--format", choices=("text", "json"), default="text")
    hb = sub.add_parser(
        "hub",
        help="pod telemetry hub: federate every run's exposition into one /metrics with "
             "per-run labels and pod rollups",
    )
    hb.add_argument("--run", action="append", default=[], metavar="SPEC", dest="runs",
                    help="one run source: name=metrics_path[,hb=heartbeat][,port=P]"
                         "[,kind=train|serve] (or name=port:P for HTTP only); repeatable, "
                         "at least one")
    hb.add_argument("--fleet", default=None, metavar="FILE",
                    help="the fleet scheduler's exposition (write_exposition), which the "
                         "card and decision rollups come from")
    hb.add_argument("--out", default=None, metavar="FILE",
                    help="publish the federated exposition to this textfile (atomically)")
    hb.add_argument("--port", type=int, default=None, metavar="P",
                    help="also serve GET /metrics on this port")
    hb.add_argument("--interval", type=float, default=5.0, metavar="S",
                    help="scrape and publish interval (default 5 s)")
    hb.add_argument("--once", action="store_true",
                    help="one aggregation pass, printed (or --out), then exit")
    hb.add_argument("--stale-after", type=float, default=None, metavar="S",
                    help="heartbeat age past which a run reads dead (default: "
                         "hub.STALE_AFTER_S)")
    hb.add_argument("--archive", default=None, metavar="PATH",
                    help="append one pod-rollup archive record a pass to this archive")
    mm = sub.add_parser(
        "memory",
        help="memory report: ledger snapshots, mem.* gauge series, OOM events, peak-HBM gate "
             "scalar (or --oom: parse a raw out-of-memory text)",
    )
    mm.add_argument("input", help="a --log_file JSONL history (default) or, with --oom, a text "
                                  "file holding an out-of-memory message")
    mm.add_argument("--oom", action="store_true",
                    help="INPUT is a raw out-of-memory text, not a history")
    mm.add_argument("--format", choices=("text", "json"), default="text")
    t = sub.add_parser("export-trace", help="write Chrome trace-event JSON")
    t.add_argument("log", help="JSONL history written by --log_file")
    t.add_argument("-o", "--out", default=None, help="output path (default: <log>.trace.json)")
    args = ap.parse_args(argv)

    if args.cmd == "tail":
        from tpu_dist_torch.obs import tail as tail_lib  # noqa: PLC0415

        return tail_lib.run_tail(args.log, heartbeat=args.heartbeat, interval=args.interval,
                                 once=args.once, **({"rows": args.rows} if args.rows else {}))
    if args.cmd == "pod":
        return _pod(args)
    if args.cmd == "archive":
        return _archive(args)
    if args.cmd == "trend":
        return _trend(args)
    if args.cmd == "hub":
        return _hub(args)
    if args.cmd == "memory":
        return _memory(args)
    if args.cmd == "export-trace":
        return _export_trace(args)
    if args.cmd == "xprof":
        return _xprof(args)
    if args.cmd == "summarize":
        return _summarize(args)

    if args.cmd == "postmortem":
        from tpu_dist_torch.obs import postmortem as postmortem_lib  # noqa: PLC0415

        missing = [d for d in args.dirs if not os.path.isdir(d)]
        if missing:
            print(
                f"tpu_dist_torch.obs: cannot read director"
                f"{'y' if len(missing) == 1 else 'ies'} "
                + ", ".join(missing), file=sys.stderr,
            )
            return 2
        report, bundle = postmortem_lib.run_postmortem(
            args.dirs, out=args.out, annotate=args.annotate, tail=args.tail,
        )
        if bundle is None:
            print(
                "tpu_dist_torch.obs: no forensic artifacts (flight rings, "
                "stack dumps, heartbeats, expositions, histories) found "
                "in " + ", ".join(args.dirs), file=sys.stderr,
            )
            return 1
        if args.format == "json":
            print(json.dumps(report, indent=2, default=str))
        else:
            print(postmortem_lib.format_text(report))
        print(f"bundle written to {bundle}")
        return 0

    from tpu_dist_torch.obs import compare as compare_lib  # noqa: PLC0415

    if args.against_archive:
        return _against_archive(args)
    if args.candidate is None:
        print("tpu_dist_torch.obs: compare needs a baseline and a candidate "
              "(or --against-archive)", file=sys.stderr)
        return 2
    if args.band_k is not None or args.band_window is not None:
        print("tpu_dist_torch.obs: --band-k/--band-window only apply with --against-archive",
              file=sys.stderr)
        return 2
    try:
        result = compare_lib.compare_files(
            args.baseline, args.candidate, threshold=args.threshold, bench=args.bench,
            goodput_only=args.goodput, slo_only=args.slo,
        )
    except (OSError, ValueError) as e:
        print(f"tpu_dist_torch.obs: compare failed: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(result, indent=2))
    else:
        print(compare_lib.format_text(result))
    if result["compared"] == 0:
        # a gate that compared nothing must not pass silently
        print("tpu_dist_torch.obs: no comparable metrics between the two inputs",
              file=sys.stderr)
        return 2
    return 1 if result["regressions"] else 0


def _xprof(args) -> int:
    """The ``xprof`` subcommand (``tpu_dist/obs/__main__.py:423-450``)."""
    from tpu_dist_torch.obs import xprof as xprof_lib  # noqa: PLC0415

    if not os.path.exists(args.capture):
        print(f"tpu_dist_torch.obs: cannot read {args.capture}: no such file or directory",
              file=sys.stderr)
        return 2
    try:
        if os.path.isdir(args.capture):
            report = xprof_lib.analyze_capture(args.capture, top_k=args.top)
        else:
            report = xprof_lib.analyze_trace_file(args.capture, top_k=args.top)
    except xprof_lib.CaptureError as e:
        # typed: empty capture / all traces malformed / no device track
        print(f"tpu_dist_torch.obs: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"tpu_dist_torch.obs: cannot read {args.capture}: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(xprof_lib.format_text(report))
    return 0


def _summarize(args) -> int:
    """The ``summarize`` subcommand (``tpu_dist/obs/__main__.py:462-477``
    with ``--bench``, else ``:704-725``)."""
    from tpu_dist_torch.obs import compare as compare_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import summarize as summ  # noqa: PLC0415

    if args.bench:
        try:
            report = compare_lib.bench_report(args.log)
        except OSError as e:
            print(f"tpu_dist_torch.obs: cannot read {args.log}: {e}", file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"tpu_dist_torch.obs: {e}", file=sys.stderr)
            return 1
        if args.format == "json":
            print(json.dumps(report, indent=2))
        else:
            print(compare_lib.format_bench_report(report))
        return 0
    try:
        records, bad = summ.load_records(args.log)
    except OSError as e:
        print(f"tpu_dist_torch.obs: cannot read {args.log}: {e}", file=sys.stderr)
        return 2
    if not records:
        print(f"tpu_dist_torch.obs: no records in {args.log}", file=sys.stderr)
        return 1
    report = summ.stamp_capture(summ.summarize(records, bad), args.log)
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(summ.format_text(report))
    return 0


def _memory(args) -> int:
    """The ``memory`` subcommand (``tpu_dist/obs/__main__.py:351-393``)."""
    from tpu_dist_torch.obs import memory as memory_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import summarize as summ  # noqa: PLC0415

    if args.oom:
        try:
            with open(args.input, errors="replace") as f:
                text = f.read()
        except OSError as e:
            print(f"tpu_dist_torch.obs: cannot read {args.input}: {e}", file=sys.stderr)
            return 2
        report = memory_lib.parse_resource_exhausted(text)
        if report is None:
            print(f"tpu_dist_torch.obs: {args.input} carries no RESOURCE_EXHAUSTED / "
                  "out-of-memory signature", file=sys.stderr)
            return 1
        if args.format == "json":
            print(json.dumps(report, indent=2))
        else:
            print(memory_lib.format_oom_text(report))
        return 0
    try:
        records, _bad = summ.load_records(args.input)
    except OSError as e:
        print(f"tpu_dist_torch.obs: cannot read {args.input}: {e}", file=sys.stderr)
        return 2
    report = memory_lib.memory_report(records)
    if not (report["ledgers"] or report["epoch_series"] or report["ooms"]):
        print(f"tpu_dist_torch.obs: no memory telemetry (memory records or mem.* gauges) in "
              f"{args.input}", file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(report, indent=2, default=str))
    else:
        print(memory_lib.format_report_text(report))
    return 0


def _export_trace(args) -> int:
    """The ``export-trace`` subcommand (``tpu_dist/obs/__main__.py:704-733``)."""
    from tpu_dist_torch.obs import summarize as summ  # noqa: PLC0415

    try:
        records, _bad = summ.load_records(args.log)
    except OSError as e:
        print(f"tpu_dist_torch.obs: cannot read {args.log}: {e}", file=sys.stderr)
        return 2
    if not records:
        print(f"tpu_dist_torch.obs: no records in {args.log}", file=sys.stderr)
        return 1
    out_path = args.out or (args.log + ".trace.json")
    trace = summ.export_trace(records)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace['traceEvents'])} event(s) to {out_path}")
    return 0


def _pod(args) -> int:
    """The ``pod`` subcommand (``tpu_dist/obs/__main__.py:538-563``)."""
    from tpu_dist_torch.obs import aggregate as aggregate_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import summarize as summ  # noqa: PLC0415

    hosts = []
    for path in args.logs:
        try:
            records, _bad = summ.load_records(path)
        except OSError as e:
            print(f"tpu_dist_torch.obs: cannot read {path}: {e}", file=sys.stderr)
            return 2
        if not records:
            print(f"tpu_dist_torch.obs: no records in {path}", file=sys.stderr)
            return 1
        hosts.append((path, records))
    report = aggregate_lib.pod_report(hosts, heartbeats=args.heartbeat)
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(aggregate_lib.format_text(report))
    if args.trace_out:
        trace = aggregate_lib.pod_trace(hosts)
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        print(f"wrote {len(trace['traceEvents'])} event(s) across {len(hosts)} host track(s) "
              f"to {args.trace_out}")
    return 0


def _archive(args) -> int:
    """The ``archive ingest`` subcommand (``tpu_dist/obs/__main__.py:567-584``)."""
    from tpu_dist_torch.obs import archive as archive_lib  # noqa: PLC0415

    try:
        report = archive_lib.ingest_paths(args.inputs, args.archive)
    except (OSError, ValueError) as e:
        print(f"tpu_dist_torch.obs: archive ingest failed: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(archive_lib.format_ingest_text(report))
    if report["records_seen"] == 0:
        print("tpu_dist_torch.obs: the inputs held no archivable records", file=sys.stderr)
        return 1
    return 0


def _trend(args) -> int:
    """The ``trend`` subcommand (``tpu_dist/obs/__main__.py:586-626``)."""
    from tpu_dist_torch.obs import archive as archive_lib  # noqa: PLC0415

    try:
        records, _counts = archive_lib.load_archive(args.archive)
    except OSError as e:
        print(f"tpu_dist_torch.obs: cannot read {args.archive}: {e}", file=sys.stderr)
        return 2
    if not records:
        print(f"tpu_dist_torch.obs: no archive records in {args.archive}", file=sys.stderr)
        return 1
    if args.inject_regression:
        probe = archive_lib.inject_probe(records)
        if args.format == "json":
            print(json.dumps(probe, indent=2))
        else:
            print(archive_lib.format_probe_text(probe))
        if archive_lib.probe_is_dead(probe):
            # an injected regression unflagged, an improvement flagged, or a
            # changepoint not localized: every real pass would be vacuous
            print("tpu_dist_torch.obs: the injected-regression probe came back CLEAN — the "
                  "archive gate / changepoint detector is dead", file=sys.stderr)
            return 2
        return 0
    report = archive_lib.trend_report(records, metric=args.metric, window=args.window)
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(archive_lib.format_trend_text(report, blame=args.blame))
    return 0


def _against_archive(args) -> int:
    """``compare --against-archive`` (``tpu_dist/obs/__main__.py:629-675``)."""
    from tpu_dist_torch.obs import archive as archive_lib  # noqa: PLC0415

    if args.candidate is not None:
        print("tpu_dist_torch.obs: --against-archive takes ONE candidate positional (the "
              "archive IS the baseline)", file=sys.stderr)
        return 2
    if args.goodput or args.slo:
        print("tpu_dist_torch.obs: --goodput/--slo gate two history logs; the archive gate "
              "bands every registered metric", file=sys.stderr)
        return 2
    try:
        result = archive_lib.gate_files(
            args.against_archive, args.baseline, bench=args.bench,
            **({"k": args.band_k} if args.band_k is not None else {}),
            **({"window": args.band_window} if args.band_window is not None else {}))
    except (OSError, ValueError) as e:
        print(f"tpu_dist_torch.obs: archive gate failed: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(result, indent=2))
    else:
        print(archive_lib.format_gate_text(result))
    if result["compared"] == 0:
        # all-stale bands or no overlap: a gate that compared nothing
        print("tpu_dist_torch.obs: the archive band compared nothing"
              + (" — every relevant record is STALE" if result.get("stale") else ""),
              file=sys.stderr)
        return 2
    return 1 if result["regressions"] else 0


def _hub(args) -> int:
    """The ``hub`` subcommand (``tpu_dist/obs/__main__.py:479-535``)."""
    from tpu_dist_torch.obs import hub as hub_lib  # noqa: PLC0415

    if not args.runs:
        print("tpu_dist_torch.obs: hub needs at least one --run "
              "name=metrics_path[,hb=...,port=...,kind=...]", file=sys.stderr)
        return 2
    try:
        sources = [hub_lib.parse_source(s) for s in args.runs]
        h = hub_lib.TelemetryHub(
            sources, fleet_exposition=args.fleet,
            **({"stale_after_s": args.stale_after} if args.stale_after is not None else {}))
    except ValueError as e:
        print(f"tpu_dist_torch.obs: {e}", file=sys.stderr)
        return 2
    if args.archive:
        from tpu_dist_torch.obs import archive as archive_lib  # noqa: PLC0415
    if args.once:
        snap = h.collect()
        if args.out:
            h.write(args.out, snap)
            print(f"federated {snap['rollup']['runs_aggregated']} run(s) to {args.out}")
        else:
            print(h.federated(snap), end="")
        if args.archive:
            archive_lib.append_hub_snapshot(args.archive, snap)
        return 0 if snap["rollup"]["runs_aggregated"] else 1
    server = hub_lib.HubServer(args.port) if args.port else None
    if server is not None:
        print(f"hub serving /metrics on :{server.port}")
    try:
        while True:
            snap = h.collect()
            text = h.federated(snap)
            if args.out:
                h.write(args.out, snap)
            if server is not None:
                server.publish(text)
            if args.archive:
                # one pod-rollup record a pass: the fleet's series grows
                archive_lib.append_hub_snapshot(args.archive, snap)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        if server is not None:
            server.close()


if __name__ == "__main__":
    sys.exit(main())
