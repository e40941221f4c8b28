"""CLI: ``python -m tpu_dist_torch.serve`` — serving reports, the drill and
the replica; the port's counterpart of ``python -m tpu_dist.serve``.

Subcommands::

    report <run.jsonl> [--format text|json]
        The serving SLO report of a history JSONL's ``serve`` records: the
        per-window table (requests/s, latency p50/p99 bounds, TTFB,
        availability, batch occupancy, queue depth), the SLO alerts that
        fired, and the final latency histogram; the same text and JSON as
        ``python -m tpu_dist.serve report``. Exit 1 when the log holds no
        serve records.

    drill --workdir DIR [--format text|json] [--device cuda|cpu]
        The serving proof (``serve/drill.py``): a deterministic trace
        replay from a dp = 4 ZeRO-1 checkpoint through the elastic
        remapper, zero post-warmup retraces, the histogram invariants, and
        the ``obs compare --slo`` exit contract (an injected regression
        exits 1, an improvement 0). Exit 1 when an invariant fails.

    replica --ckpt C --workdir D [--device cuda|cpu] [...]
        One supervised serving replica (``serve/replica.py``): restore
        ladder, warmup, paced synthetic serving with the heartbeat, flight
        ring, exposition and history armed; SIGTERM runs the shed, drain,
        sweep vacate. ``ReplicaSupervisor`` spawns these.

Exit codes: 0 ok, 1 unusable input or a failed drill, 2 bad invocation.
The report is file crunching only: no device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.serve",
        description="serving SLO reports, the serving drill and the replica",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "report", help="per-window serving SLO report from a history JSONL"
    )
    r.add_argument("log", help="history JSONL holding serve records")
    r.add_argument("--format", choices=("text", "json"), default="text")
    d = sub.add_parser("drill", help="deterministic serving drill")
    d.add_argument("--workdir", required=True)
    d.add_argument("--format", choices=("text", "json"), default="text")
    d.add_argument("--device", default="cuda")
    sub.add_parser("replica", add_help=False,
                   help="one supervised serving replica (serve/replica.py)")
    args, rest = ap.parse_known_args(argv)

    if args.cmd == "replica":
        from tpu_dist_torch.serve import replica as replica_lib  # noqa: PLC0415

        return replica_lib.main(rest)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.cmd == "drill":
        from tpu_dist_torch.serve import drill as drill_lib  # noqa: PLC0415

        return drill_lib.main(["--workdir", args.workdir, "--format", args.format,
                               "--device", args.device])

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
