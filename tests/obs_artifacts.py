"""Synthetic run artifacts for the port's telemetry-tool tests
(``test_torch_obs_tail.py``, ``test_torch_obs_pod.py``,
``test_torch_obs_archive.py``), written into a test's ``tmp_path`` in the
shapes the JAX package's own tests use (``tests/test_goodput.py``,
``test_fleet.py``, ``test_hub.py``, ``test_archive.py``): per-host
histories with every record kind the tools render, a scheduler's log with
fleet decisions and tenancy ticks, heartbeat files, bench streams with
capture stamps, the run wrappers and a schema-pinned report. Both
packages' tools read the same files; no test reads the repo's own
artifacts. Also :func:`run_both`, which runs one command line through the
two CLIs and returns each one's exit code and output.
"""

import json

from tpu_dist.obs.__main__ import main as jax_main
from tpu_dist_torch.obs.__main__ import main as port_main

THROUGHPUT = "resnet18_cifar100_train_throughput"


def write_jsonl(path, records) -> str:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _rec(kind, run_id, ts, rel_s, **kw):
    return {"kind": kind, "run_id": run_id, "ts": ts, "rel_s": rel_s, "schema_version": 15,
            **kw}


def host_records(name: str, *, epoch_time: float, stall: float, frac: float,
                 t0: float = 1000.0, crashed: bool = False, peak: int = 2 << 30) -> list:
    """One host's history of 3 epochs with every kind ``tail``,
    ``summarize`` and ``pod`` render: epochs, evals, goodput windows and
    the final totals, an alert, an anomaly, a straggler, a profile capture
    and its analysis (and a failed one), an auto-recovery, a grown resume
    that actuates decision 1, serving windows and a retrace, a memory
    ledger and an OOM event, spans, and with ``crashed`` a postmortem
    bundle in place of the final totals."""
    run, r2 = f"r-{name}", f"r-{name}-2"
    recs = [_rec("memory", run, t0 + 0.5, 0.5, static={"bytes_per_device": peak // 2},
                 xla={"peak_bytes": peak}, reconciliation={
                     "bytes_in_use": peak // 2, "attributed_bytes": peak // 2,
                     "unattributed_bytes": 0, "source": "census"})]
    t = t0
    for e in range(3):
        rid = run if e < 2 else r2
        if e == 2:
            t += 6.0  # the relaunch gap before the grown segment
            recs.append(_rec("resume", rid, t + 0.1, 0.1, epoch=e, world=8, dp=8, prev_dp=4,
                             resharded=True, restarts=1, decision_id=1,
                             decision_cause="serve_breach"))
        t += epoch_time
        rel = t - t0 if e < 2 else 0.1 + epoch_time
        recs.append(_rec("train_epoch", rid, t, rel, epoch=e, epoch_time=epoch_time,
                         images_per_sec=5000.0 / epoch_time, loss=2.0 - 0.25 * e,
                         acc1=10.0 + e, acc5=40.0 + e, data_stall_frac=stall,
                         step_time_p50=0.011 * epoch_time, step_time_p95=0.02,
                         step_time_p99=0.03, mfu=0.31 + 0.01 * e, steps=10))
        recs.append(_rec("spans", rid, t, rel, events=[
            {"name": "train/dispatch", "ph": "X", "ts": 1e5 * (e + 1), "dur": 5e4, "pid": 0,
             "tid": 1}]))
        recs.append(_rec("eval", rid, t + 0.2, rel + 0.2, epoch=e, top1=20.0 + 5 * e,
                         top5=50.0 + e, loss=1.9 - 0.1 * e))
        recs.append(_rec("goodput", rid, t + 0.3, rel + 0.3, epoch=e, window_s=epoch_time,
                         productive_s=round(frac * epoch_time, 4),
                         unattributed_s=round((1 - frac) * epoch_time, 4)))
        if e == 0:
            recs += [
                _rec("alert", rid, t + 0.4, rel + 0.4, rule="stall_high",
                     metric="data_stall_frac", value=stall, op=">", threshold=0.1,
                     sustained=2, epoch=e, step=7),
                _rec("anomaly", rid, t + 0.4, rel + 0.4, anomaly="loss_spike", epoch=e,
                     step=3, value=9.5, ratio=4.2, median=2.2),
                _rec("straggler", rid, t + 0.4, rel + 0.4, epoch=e, worst_rank=1, skew=1.8,
                     straggler=True),
                _rec("profile", rid, t + 0.4, rel + 0.4, event="start", reason="anomaly",
                     epoch=e, dir=f"/prof/{name}/cap0"),
                _rec("profile", rid, t + 0.5, rel + 0.5, event="stop", reason="anomaly",
                     epoch=e, steps=3, dir=f"/prof/{name}/cap0"),
                _rec("profile_analysis", rid, t + 0.6, rel + 0.6, reason="anomaly",
                     dir=f"/prof/{name}/cap0", device_busy_s=0.123, collective_frac=0.25,
                     overlap_frac=0.5, infeed_stall_s=0.01),
                _rec("profile", rid, t + 0.7, rel + 0.7, event="error", reason="manual",
                     epoch=e, error="capture dir not writable"),
                _rec("auto_recover", rid, t + 0.8, rel + 0.8, epoch=e, lr_scale=0.5),
            ]
        if e == 1:
            recs += [
                _rec("serve", rid, t + 0.4, rel + 0.4, requests_per_s=512.5,
                     latency_p50_ms=3.2, latency_p99_ms=12.8, availability=0.999,
                     batch_occupancy=0.75, queue_depth_max=4, retraces=1),
                _rec("serve", rid, t + 0.5, rel + 0.5, event="retrace", bucket=8, n_real=5),
                _rec("memory", rid, t + 0.6, rel + 0.6, event="oom", oom={
                    "kind": "oom", "requested_bytes": 1 << 30, "limit_bytes": 80 << 30}),
            ]
    if crashed:
        recs.append(_rec("postmortem", r2, t + 1.0, 1.0 + epoch_time, n_ranks=2,
                         bundle=f"/crash/{name}/postmortem.json",
                         verdicts={"0": "fatal", "1": "no-clean-exit"},
                         fatal={"0": "RuntimeError: boom"}, stuck_frames={"1": "all_reduce"}))
    else:
        recs.append(_rec("goodput", r2, t + 1.0, 1.0 + epoch_time, final=True,
                         elapsed_s=round(t + 1.0 - t0, 4),
                         productive_s=round(frac * 3 * epoch_time, 4),
                         unattributed_s=round(t + 1.0 - t0 - frac * 3 * epoch_time, 4),
                         goodput_frac=frac))
    return recs


def scheduler_records() -> list:
    """A fleet scheduler's log: decision 1 (donate + grant, which the
    hosts' resume records complete), decision 2 that nobody relaunched
    for, and the tenancy ticks, one of them a conservation violation."""
    return [
        {"kind": "fleet", "schema_version": 15, "ts": 1001.0, "tick": 3, "run_id": "sched",
         "action": "donate", "donor": "tr", "for_run": "sv", "chips": 4, "preempt": True,
         "decision_id": 1, "cause": "serve_breach", "alloc_before": {"tr": 8, "sv": 2},
         "alloc_after": {"tr": 4, "sv": 2}, "reason": "sv breached its p99"},
        {"kind": "fleet", "schema_version": 15, "ts": 1002.0, "tick": 4, "run_id": "sched",
         "action": "grant", "recipient": "sv", "chips": 4, "preempt": True,
         "decision_id": 1, "cause": "serve_breach", "chained": True,
         "alloc_after": {"tr": 4, "sv": 6}},
        {"kind": "fleet", "schema_version": 15, "ts": 1010.0, "tick": 9, "run_id": "sched",
         "action": "donate", "donor": "sv", "for_run": "tr", "chips": 2, "decision_id": 2,
         "cause": "serve_release", "alloc_after": {"tr": 4, "sv": 4}},
        {"kind": "tenancy", "schema_version": 15, "ts": 1001.0, "tick": 3, "run_id": "sched",
         "alloc": {"tr": 4, "sv": 2}, "free": 1, "pending": 4, "total_chips": 11,
         "decision_id": 1},
        {"kind": "tenancy", "schema_version": 15, "ts": 1002.0, "tick": 4, "run_id": "sched",
         "alloc": {"tr": 4, "sv": 6}, "free": 1, "pending": 0, "total_chips": 11,
         "decision_id": 1},
        {"kind": "tenancy", "schema_version": 15, "ts": 1003.0, "tick": 5, "run_id": "sched",
         "alloc": {"tr": 4, "sv": 6}, "free": 0, "pending": 0, "total_chips": 11},
    ]


def heartbeat(path, counter=42, epoch=2, step=7, phase="step", ts=4990.0) -> str:
    with open(path, "w") as f:
        json.dump({"counter": counter, "epoch": epoch, "step": step, "phase": phase,
                   "ts": ts, "pid": 1234}, f)
    return str(path)


def write_hosts(tmp_path) -> dict:
    """Two hosts' logs (``b`` slower, stalled and crashed), the scheduler's
    log and two heartbeat files (one missing): their paths."""
    return {
        "a": write_jsonl(tmp_path / "a.jsonl", host_records("a", epoch_time=10.0, stall=0.05,
                                                            frac=0.9)),
        "b": write_jsonl(tmp_path / "b.jsonl", host_records(
            "b", epoch_time=35.0, stall=0.4, frac=0.6, t0=1000.5, crashed=True,
            peak=3 << 30)),
        "sched": write_jsonl(tmp_path / "sched.jsonl", scheduler_records()),
        "hb": heartbeat(tmp_path / "hb.json"),
        "hb_gone": str(tmp_path / "hb.h1.json"),
    }


# -- the archive's inputs ----------------------------------------------------------


def bench_rec(value, i, *, metric=THROUGHPUT, **extra) -> dict:
    rec = {"metric": metric, "value": value, "unit": "images/sec",
           "capture": {"host": "testhost", "bench_run_id": f"run{i:02d}", "mono_s": float(i)}}
    rec.update(extra)
    return rec


def history(path, ips, loss=2.0, run_id="r") -> str:
    return write_jsonl(path, [{
        "kind": "train_epoch", "epoch": e, "run_id": run_id, "loss": loss,
        "epoch_time": 2.0, "images_per_sec": ips, "step_time_p50": 0.01,
        "step_time_p95": 0.02, "step_time_p99": 0.03, "data_stall_frac": 0.05,
    } for e in range(2)])


def write_archive_inputs(tmp_path) -> dict:
    """Every artifact kind the archive ingests: a bench stream (8 captures
    with a step down at the sixth, a second metric, a self-declared stale
    record and a re-emitted capture), a run wrapper with a parsed record
    and an empty one, a multichip wrapper (ok and skipped), a
    ``plan_report``, three histories, and the gate's candidates."""
    d = tmp_path
    values = [1000.0, 1004.0, 998.0, 1001.0, 1003.0, 900.0, 902.0, 899.0]
    stream = [bench_rec(v, i) for i, v in enumerate(values)]
    stream += [bench_rec(50.0 + i, 20 + i, metric="vit_b16_step_ms", unit="ms")
               for i in range(4)]
    stream += [bench_rec(1200.0, 99, stale=True), bench_rec(1000.0, 0)]
    out = {"bench": write_jsonl(d / "bench.jsonl", stream)}
    with open(d / "run_wrap_ok.json", "w") as f:
        json.dump({"n": 3, "cmd": "python bench.py", "rc": 0, "tail": "",
                   "parsed": bench_rec(901.0, 50)}, f)
    out["wrap_ok"] = str(d / "run_wrap_ok.json")
    with open(d / "run_wrap_empty.json", "w") as f:
        json.dump({"n": 4, "cmd": "python bench.py", "rc": 1,
                   "tail": "Traceback: device busy\n", "parsed": None}, f)
    out["wrap_empty"] = str(d / "run_wrap_empty.json")
    for name, ok, skipped in (("mc_ok", True, False), ("mc_skip", False, True)):
        with open(d / f"{name}.json", "w") as f:
            json.dump({"n_devices": 8, "rc": 0 if ok else 1, "ok": ok, "skipped": skipped,
                       "tail": "dryrun"}, f)
        out[name] = str(d / f"{name}.json")
    with open(d / "plan.json", "w") as f:
        json.dump({"schema": "plan_report_v1", "chosen": {
            "name": "zero1_sgd", "step_time_p50_s": 0.05, "peak_hbm_bytes": 3 << 30,
            "unknown_score": 7}}, f)
    out["report"] = str(d / "plan.json")
    out["histories"] = [history(d / f"h{i}.jsonl", ips, run_id=f"h{i}")
                        for i, ips in enumerate([1000.0, 1010.0, 990.0])]
    out["worse"] = history(d / "worse.jsonl", 600.0, run_id="worse")
    out["same"] = history(d / "same.jsonl", 1000.0, run_id="same")
    out["cand_bench"] = write_jsonl(d / "cand.jsonl", [bench_rec(700.0, 70)])
    out["cand_good"] = write_jsonl(d / "cand_good.jsonl", [bench_rec(1001.0, 71)])
    out["cand_stale"] = write_jsonl(d / "cand_stale.jsonl", [bench_rec(1000.0, 0)])
    return out


def run_both(capsys, argv_of) -> tuple:
    """``argv_of(pkg)`` (``"jax"`` or ``"port"``) through each package's
    ``obs`` CLI: ``((rc, stdout, stderr) of JAX, ... of the port)``, with
    the programs' names cut out of the messages."""
    out = []
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        capsys.readouterr()
        rc = main(argv_of(pkg))
        o, e = capsys.readouterr()
        # the JAX message names the analysis layer's rule the port lacks
        out.append((rc, o, e.replace("tpu_dist_torch.obs", "tpu_dist.obs")
                    .replace(" (TD124)", "")))
    return tuple(out)
