"""CLI: ``python -m tpu_dist_torch.analysis [paths] | shard | plan |
tune-overlap``, the port's counterpart of ``python -m tpu_dist.analysis``,
with JAX's flags and exit codes: 0 clean, 1 violations, 2 an error, a
dead detector (an injected probe that comes back clean) or a full run
that skipped families.

* no subcommand (the default command): the AST lint (TD001-TD008) of
  ``paths`` (default: the ``tpu_dist_torch`` package), then the audit
  (the cases' TD101-TD104 and the no-op probes TD105-TD115, TD120,
  TD122-TD124), the findings filtered by the inline suppressions and the
  baseline (``--baseline``, default
  ``tpu_dist_torch/analysis/analysis_baseline.json``). ``--no-lint`` and
  ``--no-audit`` (or JAX's name for it, ``--no-jaxpr``) skip a layer,
  ``--case`` runs only the named audit cases (and no probe),
  ``--write-baseline`` accepts the current findings (refused on a partial
  run), ``--list-rules`` prints the registry.
* ``shard``: run every config family once, check TD116/TD117, print or
  write ``shard_report.json`` (``--inject-reshard`` adds the TD117 probe).
* ``plan``: the ``--auto_shard`` planner over the families (or a shard
  report, ``--from-report``), TD118-verified (``--inject-miscost``).
* ``tune-overlap``: the overlap tuner, TD121-gated (``--inject-payload``).

The audit and the subcommands run over a process group the CLI starts
itself: ``--nprocs N`` ranks (default: the visible cards on CUDA, 8 on the
CPU, JAX's emulated mesh), spawned as processes of this module, on
``--device`` (default ``cuda``; ``--device cpu`` takes gloo ranks). One
rank runs in this process. When a process group exists already (a
caller's), the command runs on it. Rank 0 lints, prints and writes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

SUBCOMMANDS = ("shard", "plan", "tune-overlap")
DEFAULT = "default"  # the command without a subcommand: lint + audit


def _add_common(ap: argparse.ArgumentParser, what: str) -> None:
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None, help=f"write the schema-pinned {what} here")
    ap.add_argument("--family", action="append",
                    help="restrict to this config family (repeatable)")
    ap.add_argument("--list-families", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a rank) or cpu (gloo)")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="ranks of the process group (default: the visible cards on "
                         "CUDA, 8 on the CPU)")


def _default_parser() -> argparse.ArgumentParser:
    from tpu_dist_torch.analysis.lint import DEFAULT_PATH  # noqa: PLC0415

    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.analysis",
        description="distributed-training lint (TD0xx) + step audit (TD1xx); subcommands: "
                    + ", ".join(SUBCOMMANDS))
    ap.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                    help=f"files/dirs to lint (default: the {DEFAULT_PATH} package)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: tpu_dist_torch/analysis/analysis_baseline.json "
                         "when it exists)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline file and exit 0")
    ap.add_argument("--no-lint", action="store_true", help="skip the AST lint layer")
    ap.add_argument("--no-audit", "--no-jaxpr", action="store_true",
                    help="skip the step audit (--no-jaxpr is JAX's name for it)")
    ap.add_argument("--case", action="append",
                    help="run only this audit case, and no probe (repeatable)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a rank) or cpu (gloo)")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="ranks of the audit's process group (default: the visible cards on "
                         "CUDA, 8 on the CPU)")
    return ap


def _lint_targets(paths: list) -> tuple:
    """``(paths, root)`` to lint: the default path is the package itself,
    reported relative to its parent, wherever the CLI runs from."""
    from tpu_dist_torch.analysis.lint import DEFAULT_PATH  # noqa: PLC0415

    if paths == [DEFAULT_PATH]:
        import tpu_dist_torch  # noqa: PLC0415

        pkg = os.path.dirname(os.path.abspath(tpu_dist_torch.__file__))
        return [pkg], os.path.dirname(pkg)
    return paths, None


def default_body(args) -> int:
    """The lint (rank 0) and the audit (every rank), the baseline, the
    report; returns the exit code (rank 0's is the command's)."""
    from tpu_dist_torch.analysis import baseline as baseline_lib  # noqa: PLC0415
    from tpu_dist_torch.analysis.lint import lint_paths  # noqa: PLC0415
    from tpu_dist_torch.analysis.rules import RULES  # noqa: PLC0415
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415

    primary = collectives.rank() == 0
    violations: list = []
    report: dict = {}
    if not args.no_lint and primary:
        violations.extend(lint_paths(*_lint_targets(args.paths)))
    if not args.no_audit:
        from tpu_dist_torch.analysis.noop_probes import audit_all  # noqa: PLC0415

        report, audit_vs = audit_all(args.device, names=args.case)
        violations.extend(audit_vs)
    if not primary:
        return 1 if violations else 0
    baseline_path = args.baseline or (baseline_lib.DEFAULT_BASELINE
                                      if os.path.exists(baseline_lib.DEFAULT_BASELINE) else None)
    if args.write_baseline:
        path = args.baseline or baseline_lib.DEFAULT_BASELINE
        baseline_lib.write(violations, path)
        print(f"wrote {len(violations)} accepted finding(s) to {path}", flush=True)
        return 0
    stale: list = []
    if baseline_path:
        violations, stale = baseline_lib.apply(violations, baseline_lib.load(baseline_path))
    if args.format == "json":
        print(json.dumps({
            "violations": [v.to_json() for v in violations],
            "stale_baseline_entries": stale,
            "audit_report": report,
            "counts": {"new": len(violations), "stale_baseline": len(stale)},
            "rules": [{"id": r.id, "name": r.name, "summary": r.summary}
                      for r in sorted(RULES.values(), key=lambda r: r.id)],
        }, indent=2), flush=True)
    else:
        for v in violations:
            print(v.format_text())
        for e in stale:
            print(f"stale baseline entry (no longer produced): {e.get('rule')} "
                  f"{e.get('path')} {e.get('snippet')!r}")
        print(f"tpu_dist_torch.analysis: {len(violations)} new violation(s)"
              + (f", {len(stale)} stale baseline entr(ies)" if stale else ""), flush=True)
    return 1 if violations else 0


def _default_checks(args) -> int:
    """The refusals that need no process group: exit 2 or 0 to go on."""
    from tpu_dist_torch.analysis import step_audit  # noqa: PLC0415
    from tpu_dist_torch.analysis.lint import DEFAULT_PATH  # noqa: PLC0415

    missing = [p for p in (() if args.no_lint else _lint_targets(args.paths)[0])
               if not os.path.exists(p)]
    if missing:
        # os.walk would iterate nothing: a false-green "0 violations"
        print(f"tpu_dist_torch.analysis: lint path does not exist: {missing[0]}",
              file=sys.stderr)
        return 2
    unknown = sorted(set(args.case or ()) - set(step_audit.registered_cases()))
    if unknown:
        print(f"tpu_dist_torch.analysis: unknown audit case(s) {unknown}; registered: "
              f"{step_audit.registered_cases()}", file=sys.stderr)
        return 2
    if args.write_baseline and (args.no_lint or args.no_audit or args.case
                                or args.paths != [DEFAULT_PATH]):
        # a partial run would REPLACE the file with only this run's
        # findings, silently dropping accepted entries of the layers or
        # paths that did not run
        print("tpu_dist_torch.analysis: refusing --write-baseline on a partial run "
              "(--no-lint/--no-audit/--case/custom paths); run the full analyzer to "
              "regenerate the baseline", file=sys.stderr)
        return 2
    return 0


def _parser(cmd: str) -> argparse.ArgumentParser:
    if cmd == "shard":
        ap = argparse.ArgumentParser(
            prog="python -m tpu_dist_torch.analysis shard",
            description="collective audit of every config family (TD116/TD117): writes the "
                        "shard_report.json the --auto_shard planner reads")
        _add_common(ap, "shard_report.json")
        ap.add_argument("--inject-reshard", action="store_true",
                        help="ALSO run the ZeRO-1 step behind a raw all-gather of its flat "
                             "parameters; its TD117 findings prove the detector alive; exit 2 "
                             "if it comes back clean")
    elif cmd == "plan":
        ap = argparse.ArgumentParser(
            prog="python -m tpu_dist_torch.analysis plan",
            description="the --auto_shard planner: rank the config families by predicted "
                        "step time under the per-card memory budget, TD118-verify the chosen "
                        "plan, write plan_report.json")
        _add_common(ap, "plan_report.json")
        ap.add_argument("--from-report", default=None, metavar="SHARD_REPORT",
                        help="price candidates from a shard_report.json instead of running "
                             "each family (TD118 still runs the chosen one fresh)")
        ap.add_argument("--tune-report", default=None, metavar="TUNE_REPORT",
                        help="tune_report.json from `tune-overlap`: attach its chosen knobs "
                             "to every candidate (tune_knobs); the ranking stays")
        ap.add_argument("--hbm_budget_bytes", type=int, default=None,
                        help="per-device memory budget (default: the card's table row; the "
                             "CPU has none and skips the filter)")
        ap.add_argument("--memory_headroom", type=float, default=0.9, metavar="FRAC",
                        help="fraction of the budget the static ledger may claim")
        ap.add_argument("--inject-miscost", action="store_true",
                        help="ALSO run TD118 over a mis-priced copy of the plan; its "
                             "violations prove the detector alive; exit 2 if clean")
    else:
        ap = argparse.ArgumentParser(
            prog="python -m tpu_dist_torch.analysis tune-overlap",
            description="the overlap tuner: search the schedule-only collective knobs per "
                        "family (TD121: payload pinned, schedule must move), write "
                        "tune_report.json")
        _add_common(ap, "tune_report.json")
        ap.add_argument("--capture", default=None, metavar="DIR",
                        help="torch.profiler capture dir: its measured overlap_frac is the "
                             "objective instead of the dispatch-schedule proxy")
        ap.add_argument("--inject-payload", action="store_true",
                        help="ALSO re-gate a payload-perturbed copy of the report; its TD121 "
                             "findings prove the detector alive; exit 2 if clean")
    return ap


def _say(msg: str, err: bool = False) -> None:
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415

    if collectives.rank() == 0:
        print(msg, file=sys.stderr if err else sys.stdout, flush=True)


def _unknown(args, known: list, cmd: str) -> int:
    unknown = sorted(set(args.family or ()) - set(known))
    if unknown:
        _say(f"tpu_dist_torch.analysis {cmd}: unknown famil(ies) {unknown}; known: {known}",
             err=True)
        return 2
    return 0


def _emit(args, report: dict, violations: list, text: str, save, tag: str) -> None:
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415

    if collectives.rank() != 0:
        return
    if args.out:
        save(report, args.out)
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True), flush=True)
        return
    print(text)
    for v in violations:
        print(v.format_text())
    if args.out:
        print(f"{tag}: wrote {args.out}", flush=True)


def _skipped(args, report: dict, cmd: str) -> bool:
    if report["counts"]["skipped"] and not args.family:
        # a full run that lost families must be loud: degrade per family,
        # fail the gate overall
        _say(f"tpu_dist_torch.analysis {cmd}: {report['counts']['skipped']} famil(ies) "
             f"skipped: {report['skips']}", err=True)
        return True
    return False


def shard_body(args) -> int:
    from tpu_dist_torch.analysis import shardlint  # noqa: PLC0415

    rc = _unknown(args, shardlint.registered_families(), "shard")
    if rc:
        return rc
    report, violations = shardlint.build_shard_report(args.device, names=args.family)
    if args.inject_reshard:
        _, inj_vs = shardlint.shard_case("zero1_sgd", args.device,
                                         step_override=shardlint.injected_bad_zero1(args.device))
        report["injected_reshard_probe"] = {"violations": [v.to_json() for v in inj_vs],
                                            "caught": bool(inj_vs)}
        if not inj_vs:
            _say("tpu_dist_torch.analysis shard: the injected raw all-gather probe came back "
                 "CLEAN — the TD117 detector is dead", err=True)
            return 2
    _emit(args, report, violations, shardlint.format_text(report), shardlint.save_shard_report,
          "shardlint")
    if _skipped(args, report, "shard"):
        return 2
    return 1 if violations else 0


def plan_body(args) -> int:
    from tpu_dist_torch.analysis import overlap, planner, shardlint  # noqa: PLC0415

    rc = _unknown(args, shardlint.registered_families(), "plan")
    if rc:
        return rc
    try:
        shard_report = (shardlint.load_shard_report(args.from_report) if args.from_report
                        else None)
        tune_report = overlap.load_tune_report(args.tune_report) if args.tune_report else None
    except (OSError, ValueError) as e:
        _say(f"tpu_dist_torch.analysis plan: {e}", err=True)
        return 2
    plan = planner.build_plan(device=args.device, names=args.family,
                              hbm_budget_bytes=args.hbm_budget_bytes,
                              memory_headroom=args.memory_headroom, shard_report=shard_report,
                              tune_report=tune_report)
    probe, violations = planner.verify_plan(plan, args.device)
    plan["verification"] = probe
    if args.inject_miscost:
        inj_probe, inj_vs = planner.verify_plan(planner.inject_miscost(plan), args.device)
        plan["injected_miscost_probe"] = {"violations": inj_probe.get("violations", []),
                                          "caught": bool(inj_vs)}
        if not inj_vs:
            _say("tpu_dist_torch.analysis plan: the injected mis-priced plan came back CLEAN "
                 "— the TD118 detector is dead", err=True)
            return 2
    _emit(args, plan, violations, planner.format_text(plan), planner.save_plan_report,
          "autoplan")
    if _skipped(args, plan, "plan"):
        return 2
    return 1 if violations else 0


def tune_body(args) -> int:
    from tpu_dist_torch.analysis import overlap  # noqa: PLC0415

    rc = _unknown(args, overlap.tunable_families(), "tune-overlap")
    if rc:
        return rc
    report, violations = overlap.tune(args.device, names=args.family,
                                      capture_dir=args.capture)
    if args.inject_payload:
        inj_vs = overlap.recheck_report(overlap.inject_payload(report))
        report["injected_payload_probe"] = {"violations": [v.to_json() for v in inj_vs],
                                            "caught": bool(inj_vs)}
        if not inj_vs:
            _say("tpu_dist_torch.analysis tune-overlap: the injected payload-perturbed report "
                 "came back CLEAN — the TD121 detector is dead", err=True)
            return 2
    _emit(args, report, violations, overlap.format_text(report), overlap.save_tune_report,
          "tune-overlap")
    if _skipped(args, report, "tune-overlap"):
        return 2
    return 1 if violations else 0


BODIES = {"shard": shard_body, "plan": plan_body, "tune-overlap": tune_body,
          DEFAULT: default_body}


def _list(cmd: str, nprocs: int) -> int:
    from tpu_dist_torch.analysis import overlap, planner, shardlint  # noqa: PLC0415

    names = {"shard": shardlint.registered_families,
             "plan": lambda: planner.plan_candidates(nprocs),
             "tune-overlap": overlap.tunable_families}[cmd]()
    for name in names:
        print(name)
    return 0


def _free_port() -> int:
    import socket  # noqa: PLC0415

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _in_group(cmd: str, args, world: int, rank: int, port: int) -> int:
    """Join a ``world``-rank group as ``rank``, run the subcommand, leave."""
    import torch.distributed as dist  # noqa: PLC0415

    from tpu_dist_torch.comm import mesh  # noqa: PLC0415

    _, created = mesh.initialize_distributed(args.device, world_size=world, rank=rank,
                                             master_port=port)
    try:
        return BODIES[cmd](args)
    finally:
        if created:
            dist.destroy_process_group()


def _child(rank: int, cmd: str, args, world: int, port: int, out_dir: str) -> None:
    import torch  # noqa: PLC0415

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    rc = _in_group(cmd, args, world, rank, port)
    with open(os.path.join(out_dir, f"{rank}.rc"), "w") as f:
        f.write(str(rc))


def run(cmd: str, args) -> int:
    """Run subcommand ``cmd`` over the caller's process group, or a group
    of ``args.nprocs`` ranks started here; returns rank 0's exit code."""
    import torch  # noqa: PLC0415
    import torch.multiprocessing as mp  # noqa: PLC0415

    from tpu_dist_torch import resolve_device  # noqa: PLC0415
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415

    resolve_device(args.device)  # no card and no --device cpu: raise, never fall back
    if collectives.active():
        return BODIES[cmd](args)
    n = args.nprocs
    if n is None:
        n = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 8
    if n < 1:
        raise ValueError(f"--nprocs must be >= 1, got {n}")
    if n == 1:
        return _in_group(cmd, args, 1, 0, _free_port())
    # the ranks start from this module under its package name: run as
    # ``python -m`` it is ``__main__``, which a spawned process cannot import
    from tpu_dist_torch.analysis.__main__ import _child  # noqa: PLC0415

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_child, args=(cmd, args, n, _free_port(), out_dir), nprocs=n,
                           join=True, start_method="spawn")
        with open(os.path.join(out_dir, "0.rc")) as f:
            return int(f.read())


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if not argv or argv[0] not in SUBCOMMANDS:
        args = _default_parser().parse_args(argv)
        if args.list_rules:
            from tpu_dist_torch.analysis.rules import RULES  # noqa: PLC0415

            for r in sorted(RULES.values(), key=lambda r: r.id):
                print(f"{r.id}  {r.name}\n      {r.summary}")
            return 0
        rc = _default_checks(args)
        if rc:
            return rc
        if args.no_audit:
            return default_body(args)  # the lint needs no process group
        return run(DEFAULT, args)
    cmd = argv[0]
    args = _parser(cmd).parse_args(argv[1:])
    if args.list_families:
        import torch  # noqa: PLC0415

        n = args.nprocs or (torch.cuda.device_count() if args.device != "cpu" else 8)
        return _list(cmd, n)
    return run(cmd, args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BrokenPipeError:
        sys.exit(0)  # output piped into head etc.
    except BaseException:  # noqa: BLE001 — exit 2 tells a tool crash apart
        import traceback

        traceback.print_exc()
        sys.exit(2)
