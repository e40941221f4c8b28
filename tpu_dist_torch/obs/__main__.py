"""CLI: ``python -m tpu_dist_torch.obs`` — offline run-telemetry reports;
the port's counterpart of ``python -m tpu_dist.obs``.

Subcommands::

    summarize <run.jsonl> [--format text|json]
        The run's report (``obs/summarize.py``): the per-epoch table, the
        device stats, anomalies, stragglers, profiler captures and their
        attribution, goodput, serving windows, resumes and fleet
        decisions, the final counters. Exit 1 when the file holds no
        record. ``--bench`` is not ported: exit 2 naming its ROADMAP item.

    xprof <capture_dir | trace.json[.gz]> [--top K] [--format text|json]
        Device-time attribution of a ``torch.profiler`` capture
        (``obs/xprof.py``): seconds by category, collectives by kind, the
        comm/compute overlap, infeed stall, the top ops. Exit 1 when the
        capture has nothing to attribute (a ``CaptureError``), 2 when the
        path cannot be read.

    compare <baseline.jsonl> <candidate.jsonl> [--threshold 0.05]
            [--goodput] [--slo] [--format text|json]
        Regression gate over two history JSONLs (``obs/compare.py``):
        throughput, step-time percentiles, stall fraction, MFU, final
        metrics and goodput; ``--goodput`` restricts it to the
        time-to-useful-work metrics, ``--slo`` to the serving SLO metrics
        of the ``serve`` records (lower latency is never flagged). Exit 1
        on a regression beyond the threshold, 2 when nothing compared.
        ``--bench`` and ``--against-archive`` are not ported: exit 2
        naming their ROADMAP item.

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
        ``--port`` until interrupted. ``--archive`` is not ported: exit 2
        naming its ROADMAP item.

The other subcommands of ``python -m tpu_dist.obs`` exit 2 naming the
ROADMAP item they wait for (:data:`UNPORTED`).

Exit codes: 0 ok, 1 empty/unusable input (or, for ``compare``, a
regression), 2 bad invocation, I/O error or not ported. File crunching
only: no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_TELEMETRY = "Queue A 6 (telemetry: obs/*)"

#: The subcommands of ``python -m tpu_dist.obs`` that the port lacks.
UNPORTED = {
    "tail": f"{_TELEMETRY}, obs/tail.py",
    "archive": f"{_TELEMETRY}, obs/archive.py",
    "trend": f"{_TELEMETRY}, obs/archive.py",
    "pod": f"{_TELEMETRY}, obs/aggregate.py",
}

#: Where ``compare --against-archive`` waits.
ARCHIVE_QUEUE = f"{_TELEMETRY}, obs/archive.py"


def _not_ported(what: str, queue: str) -> int:
    print(f"tpu_dist_torch.obs: {what} is not ported to tpu_dist_torch yet; "
          f"it waits for ROADMAP.md {queue}", file=sys.stderr)
    return 2


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
                   help="input is a bench.py JSON (not ported)")
    xp = sub.add_parser(
        "xprof",
        help="device-time attribution of a torch.profiler capture",
    )
    xp.add_argument("capture", help="capture directory, or one trace .json[.gz] file")
    xp.add_argument("--top", type=int, default=10, metavar="K",
                    help="top-K ops by self time (default 10)")
    xp.add_argument("--format", choices=("text", "json"), default="text")
    c = sub.add_parser(
        "compare",
        help="regression gate: diff two runs' telemetry, exit 1 on regression",
    )
    c.add_argument("baseline", help="baseline history JSONL")
    c.add_argument("candidate", nargs="?", default=None, help="candidate history JSONL")
    c.add_argument(
        "--threshold", type=float, default=0.05, metavar="FRAC",
        help="relative regression tolerance (default 0.05 = 5%%); each "
             "metric adds its own absolute noise slack on top",
    )
    c.add_argument("--bench", action="store_true",
                   help="inputs are bench.py outputs (not ported)")
    c.add_argument("--goodput", action="store_true",
                   help="gate on the time-to-useful-work metrics only")
    c.add_argument("--slo", action="store_true",
                   help="gate on the serving SLO metrics only (serve records)")
    c.add_argument("--against-archive", default=None, metavar="ARCHIVE",
                   dest="against_archive", help="not ported")
    c.add_argument("--band-k", type=float, default=None, metavar="K", help="not ported")
    c.add_argument("--band-window", type=int, default=None, metavar="N", help="not ported")
    c.add_argument("--format", choices=("text", "json"), default="text")
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
    hb.add_argument("--archive", default=None, metavar="PATH", help="not ported")
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
    for name in UNPORTED:
        sub.add_parser(name, add_help=False, help="not ported")
    args, rest = ap.parse_known_args(argv)

    if args.cmd in UNPORTED:
        return _not_ported(repr(args.cmd), UNPORTED[args.cmd])
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

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

    if args.against_archive or args.band_k is not None or args.band_window is not None:
        return _not_ported("compare --against-archive", ARCHIVE_QUEUE)
    if args.bench:
        return _not_ported("compare --bench", compare_lib.BENCH_QUEUE)
    if args.candidate is None:
        print("tpu_dist_torch.obs: compare needs a baseline and a candidate",
              file=sys.stderr)
        return 2
    try:
        result = compare_lib.compare_files(
            args.baseline, args.candidate, threshold=args.threshold,
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
    """The ``summarize`` subcommand (``tpu_dist/obs/__main__.py:704-725``)."""
    from tpu_dist_torch.obs import compare as compare_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import summarize as summ  # noqa: PLC0415

    if args.bench:
        return _not_ported("summarize --bench", compare_lib.BENCH_QUEUE)
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


def _hub(args) -> int:
    """The ``hub`` subcommand (``tpu_dist/obs/__main__.py:479-535``)."""
    if args.archive:
        return _not_ported("hub --archive", ARCHIVE_QUEUE)
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
    if args.once:
        snap = h.collect()
        if args.out:
            h.write(args.out, snap)
            print(f"federated {snap['rollup']['runs_aggregated']} run(s) to {args.out}")
        else:
            print(h.federated(snap), end="")
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
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        if server is not None:
            server.close()


if __name__ == "__main__":
    sys.exit(main())
