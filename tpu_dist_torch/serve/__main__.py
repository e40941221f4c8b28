"""CLI: ``python -m tpu_dist_torch.serve`` — the serving report.

Subcommands::

    report <run.jsonl> [--format text|json]
        The serving SLO report of a history JSONL's ``serve`` records: the
        per-window table (requests/s, latency p50/p99 bounds, TTFB,
        availability, batch occupancy, queue depth), the SLO alerts that
        fired, and the final latency histogram; the same text and JSON as
        ``python -m tpu_dist.serve report``. Exit 1 when the log holds no
        serve records.

    drill, replica
        Not ported: exit 2 naming the ROADMAP item they wait for.

Exit codes: 0 ok, 1 unusable input, 2 bad invocation or not ported. The
report is file crunching only: no device.
"""

from __future__ import annotations

import argparse
import json
import sys

#: The subcommands of ``python -m tpu_dist.serve`` that the port lacks.
UNPORTED = {
    "drill": "Queue A 5 (replica, supervisor, drill): serve/drill.py, obs/flight.py, "
             "obs/postmortem.py",
    "replica": "Queue A 5 (replica, supervisor, drill): serve/replica.py, "
               "serve/supervisor.py, obs/flight.py, obs/postmortem.py",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.serve",
        description="serving SLO reports",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "report", help="per-window serving SLO report from a history JSONL"
    )
    r.add_argument("log", help="history JSONL holding serve records")
    r.add_argument("--format", choices=("text", "json"), default="text")
    for name in UNPORTED:
        sub.add_parser(name, add_help=False, help="not ported")
    args, rest = ap.parse_known_args(argv)

    if args.cmd in UNPORTED:
        print(f"tpu_dist_torch.serve: {args.cmd!r} is not ported to tpu_dist_torch yet; "
              f"it waits for ROADMAP.md {UNPORTED[args.cmd]}", file=sys.stderr)
        return 2
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

    from tpu_dist_torch.obs.summarize import load_records  # noqa: PLC0415
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415

    try:
        records, _bad = load_records(args.log)
    except OSError as e:
        print(f"tpu_dist_torch.serve: cannot read {args.log}: {e}",
              file=sys.stderr)
        return 2
    report = slo_lib.serve_report(records)
    if not report["n_windows"]:
        print(f"tpu_dist_torch.serve: no serve records in {args.log}",
              file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(report, indent=2, default=str))
    else:
        print(slo_lib.format_report_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
