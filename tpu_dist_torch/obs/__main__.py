"""CLI: ``python -m tpu_dist_torch.obs`` — offline run-telemetry reports;
the port's counterpart of ``python -m tpu_dist.obs``.

Subcommands::

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

_TELEMETRY = "Queue A 6 (telemetry: obs/*)"

#: The subcommands of ``python -m tpu_dist.obs`` that the port lacks.
UNPORTED = {
    "summarize": f"{_TELEMETRY}, obs/summarize.py's format_text",
    "tail": f"{_TELEMETRY}, obs/tail.py",
    "export-trace": f"{_TELEMETRY}, obs/summarize.py's export_trace",
    "archive": f"{_TELEMETRY}, obs/archive.py",
    "trend": f"{_TELEMETRY}, obs/archive.py",
    "hub": f"{_TELEMETRY}, obs/hub.py",
    "pod": f"{_TELEMETRY}, obs/aggregate.py",
    "xprof": f"{_TELEMETRY}, obs/xprof.py",
    "memory": f"{_TELEMETRY}, obs/memory.py's ledger",
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
    for name in UNPORTED:
        sub.add_parser(name, add_help=False, help="not ported")
    args, rest = ap.parse_known_args(argv)

    if args.cmd in UNPORTED:
        return _not_ported(repr(args.cmd), UNPORTED[args.cmd])
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

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


if __name__ == "__main__":
    sys.exit(main())
