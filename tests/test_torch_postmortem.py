"""The port's crash-forensics bundle (``tpu_dist_torch/obs/postmortem.py``)
and OOM report (``tpu_dist_torch/obs/memory.py``) held against the JAX
package's (``tpu_dist/obs/{postmortem,memory}.py``).

Evidence directories are built for every verdict (clean, failed,
preempted, interrupted, fatal, oom from ``oom.json`` and from a ring's
fatal slot, no-clean-exit from a ring that stops and from a heartbeat left
behind, unknown; one and two ranks, with stack dumps, expositions and
histories). Each package's ``assemble``, ``write_bundle``,
``history_record``, ``append_history_record`` (through ``run_postmortem``
with ``annotate``), ``format_text`` and CLI run on its own copy of the
directory; after the copy's path and the wall-clock fields
(``generated_ts``, a record's ``ts``) are normalised, they are equal. The
PyTorch CUDA OOM message parses into the typed report (the JAX markers miss
its lowercase "out of memory"), and on the JAX package's own texts the
port's parser returns the JAX dict. All comparisons are exact.
"""

import json
import os
import shutil
import sys
import time

import pytest

from tpu_dist.obs import __main__ as jax_obs
from tpu_dist.obs import counters as jax_counters
from tpu_dist.obs import memory as jax_memory
from tpu_dist.obs import postmortem as jax_pm
from tpu_dist_torch.obs import __main__ as obs
from tpu_dist_torch.obs import counters, export, flight, memory
from tpu_dist_torch.obs import postmortem as pm

JAX_GPU_OOM = """RESOURCE_EXHAUSTED: Out of memory while trying to allocate 2684354560 bytes.
BufferAssignment OOM Debugging.
Largest program allocations in hbm:
  1. Size: 2.50G
     Operator: op_name="jit(train_step)/dot_general"
     Shape: f32[8192,81920]
  2. Size: 640.0M
     XLA Label: fusion
     Shape: bf16[320,1024,1024]
"""
JAX_TPU_OOM = (
    "RESOURCE_EXHAUSTED: XLA:TPU compile permanent error. "
    "Ran out of memory in memory space hbm. Used 15.90G of 15.48G hbm. "
    "Exceeded hbm capacity by 430.5M. Total hbm usage >= 16.43G:\n"
    "    reserved        530.00M\n    program          15.90G\n"
)
TORCH_OOM = (
    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.10 "
    "GiB of which 1.05 GiB is free. Process 4242 has 78.04 GiB memory in use. Of the "
    "allocated memory 76.50 GiB is allocated by PyTorch, and 1.03 GiB is reserved by "
    "PyTorch but unallocated. If reserved but unallocated memory is large try setting "
    "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True to avoid fragmentation."
)


@pytest.fixture(autouse=True)
def _fresh_registries():
    counters.reset()
    jax_counters.reset()
    yield
    counters.reset()
    jax_counters.reset()


# -- evidence directories, one per verdict ---------------------------------------


def _ring(d, rank=0, *, steps=3, end=None, fatal=None, n_slots=16):
    name = flight.RING_NAME + (f".h{rank}" if rank else "")
    rec = flight.FlightRecorder(os.path.join(d, name), run_id="run-x", rank=rank,
                                n_slots=n_slots)
    rec.record("open", epoch=0, world=2, dp=2)
    for i in range(steps):
        rec.step(1, i)
    if fatal is not None:
        try:
            raise fatal
        except Exception:  # noqa: BLE001 — the fatal slot of any error
            rec.fatal(*sys.exc_info())
    if end is not None:
        kind, fields = end
        rec.close(kind, **fields)


def _extras(d, rank=0):
    sfx = f".h{rank}" if rank else ""
    with open(os.path.join(d, flight.STACKS_NAME + sfx), "w") as f:
        f.write('Thread 0x02 (most recent call first):\n'
                '  File "/x/loader.py", line 150 in iter_from\n'
                'Current thread 0x01 (most recent call first):\n'
                '  File "/x/trainer.py", line 701 in train_epoch\n'
                '  File "/x/trainer.py", line 880 in fit\n')
    with open(os.path.join(d, "hb.json" + sfx), "w") as f:
        json.dump({"counter": 9, "epoch": 1, "step": 3, "phase": "train", "ts": 1000.0}, f)
    with open(os.path.join(d, "metrics.prom" + sfx), "w") as f:
        f.write(export.render({"train.epoch": 1, "train.data_stall_frac": 0.4,
                               "serve.latency_p99_ms": 12.8},
                              {"alert_active": {"stall_high": 1}}))


def _history(d):
    with open(os.path.join(d, "run.jsonl"), "w") as f:
        for rec in ({"kind": "train_epoch", "epoch": 0, "run_id": "run-x",
                     "schema_version": 15, "ts": 1.0, "rel_s": 1.0, "loss": 2.0},
                    {"kind": "eval", "epoch": 0, "run_id": "run-x", "schema_version": 15,
                     "ts": 2.0, "rel_s": 2.0, "top1": 10.0}):
            f.write(json.dumps(rec) + "\n")
        f.write('{"kind": "train_ep\n')  # a torn line


SCENES = {
    "clean": lambda d: _ring(d, end=("exit", {"clean": True})),
    "failed": lambda d: _ring(d, end=("exit", {"clean": False})),
    "preempted": lambda d: (_ring(d, end=("preempt", {"epoch": 1})), _history(d)),
    "interrupted": lambda d: _ring(d, end=("interrupt", {"epoch": 1})),
    "fatal": lambda d: (_ring(d, fatal=RuntimeError("boom at step 2"),
                              end=("exit", {"clean": False})), _extras(d)),
    "oom-json": lambda d: (_ring(d, fatal=RuntimeError("x"), end=("exit", {"clean": False})),
                           memory.write_oom_report(os.path.join(d, memory.OOM_NAME),
                                                   memory.parse_resource_exhausted(JAX_GPU_OOM),
                                                   {})),
    "oom-ring": lambda d: _ring(d, fatal=RuntimeError(JAX_TPU_OOM), end=("exit", {})),
    "no-clean-exit": lambda d: (_ring(d, steps=40, n_slots=8), _extras(d), _history(d)),
    "heartbeat-only": lambda d: _extras(d),
    "unknown": lambda d: _ring(d, steps=0, n_slots=4) or _strip_ring(d),
    "two-ranks": lambda d: (_ring(d, steps=4), _extras(d),
                            _ring(d, 1, fatal=ValueError("rank 1"), end=("exit", {"clean": False})),
                            _history(d)),
}
VERDICTS = {"clean": ["clean"], "failed": ["failed"], "preempted": ["preempted"],
            "interrupted": ["interrupted"], "fatal": ["fatal"], "oom-json": ["oom"],
            "oom-ring": ["oom"], "no-clean-exit": ["no-clean-exit"],
            "heartbeat-only": ["no-clean-exit"], "unknown": ["unknown"],
            "two-ranks": ["no-clean-exit", "fatal"]}


def _strip_ring(d):
    """A ring with no record left (a writer killed before its first slot)."""
    rec = flight.FlightRecorder(os.path.join(d, flight.RING_NAME), n_slots=4)
    rec._fd, fd = -1, rec._fd
    os.close(fd)


def _normalise(obj, root):
    """Paths under ``root`` made relative, wall-clock fields dropped."""
    if isinstance(obj, dict):
        return {k: _normalise(v, root) for k, v in obj.items()
                if k not in ("generated_ts", "ts", "t", "pid")}
    if isinstance(obj, list):
        return [_normalise(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(root, "<dir>")
    return obj


def _pair(tmp_path, scene):
    src = str(tmp_path / "src")
    os.makedirs(src)
    SCENES[scene](src)
    dirs = {}
    for pkg in ("port", "jax"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(src, dirs[pkg])
    return dirs


@pytest.mark.parametrize("scene", list(SCENES))
def test_bundle_record_and_text_equal_jax(tmp_path, scene):
    dirs = _pair(tmp_path, scene)
    got = {}
    for pkg, lib in (("port", pm), ("jax", jax_pm)):
        d = dirs[pkg]
        report = lib.assemble([d])
        text = lib.format_text(report)
        report2, bundle = lib.run_postmortem([d], annotate=True)
        with open(bundle) as f:
            written = json.load(f)
        hist = os.path.join(d, "run.jsonl")
        appended = None
        if os.path.exists(hist):
            with open(hist) as f:
                appended = json.loads(f.read().splitlines()[-1])
        got[pkg] = _normalise({
            "report": report, "text": text, "again": report2, "bundle": written,
            "record": lib.history_record(report, bundle), "appended": appended,
        }, d)
    assert got["port"] == got["jax"]
    assert [r["verdict"] for r in got["port"]["report"]["ranks"]] == VERDICTS[scene]
    if scene in ("preempted", "no-clean-exit", "two-ranks"):
        assert got["port"]["appended"]["kind"] == "postmortem"


def test_the_last_step_of_a_ring_that_stops_is_where_it_stopped(tmp_path):
    d = str(tmp_path)
    SCENES["no-clean-exit"](d)
    rank0 = pm.assemble([d])["ranks"][0]
    assert rank0["flight"]["last_step"]["step"] == 39 and rank0["flight"]["n_records"] == 8
    assert rank0["stack"]["stuck_frame"] == "train_epoch (/x/trainer.py:701)"


@pytest.mark.parametrize("scene", ["two-ranks", "clean"])
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_postmortem_cli_equals_jax(tmp_path, capsys, scene, fmt):
    dirs = _pair(tmp_path, scene)
    out = {}
    for pkg, main in (("port", obs.main), ("jax", jax_obs.main)):
        assert main(["postmortem", dirs[pkg], "--format", fmt, "--tail", "5"]) == 0
        out[pkg] = capsys.readouterr().out.replace(dirs[pkg], "<dir>")
        if fmt == "json":
            body = out[pkg].rsplit("bundle written to", 1)[0]
            out[pkg] = _normalise(json.loads(body), "<dir>")
    assert out["port"] == out["jax"]


def test_postmortem_cli_exit_codes_equal_jax(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    for argv, rc in ((["postmortem", str(empty)], 1),
                     (["postmortem", str(tmp_path / "missing")], 2)):
        assert obs.main(argv) == jax_obs.main(argv) == rc
    capsys.readouterr()


# -- OOM reports -------------------------------------------------------------------


@pytest.mark.parametrize("text", [JAX_GPU_OOM, JAX_TPU_OOM, JAX_TPU_OOM[:200],
                                  "RESOURCE_EXHAUSTED", "a different error", "",
                                  "OOM when allocating tensor with shape[1,2]",
                                  "Out of memory while trying to allocate 1.5g"],
                         ids=["gpu", "tpu", "truncated", "headline", "other", "empty",
                              "tf", "lowercase-unit"])
def test_the_parser_returns_the_jax_dict_on_jax_texts(text):
    ours = memory.parse_resource_exhausted(text)
    assert ours == jax_memory.parse_resource_exhausted(text)
    if ours is not None:
        assert memory.oom_summary_line(ours) == jax_memory.oom_summary_line(ours)
        assert memory.format_oom_text(ours) == jax_memory.format_oom_text(ours)


def test_the_pytorch_cuda_oom_message_parses():
    assert jax_memory.parse_resource_exhausted(TORCH_OOM) is None  # the JAX markers miss it
    r = memory.parse_resource_exhausted(TORCH_OOM)
    gib = 1024 ** 3
    assert r["kind"] == "oom" and r["headline"].startswith("CUDA out of memory.")
    assert r["requested_bytes"] == 2 * gib
    assert r["used_bytes"] == int(76.5 * gib) and r["limit_bytes"] == int(79.1 * gib)
    assert memory.oom_summary_line(r) == "OOM: requested 2.0GiB, used 76.5GiB of 79.1GiB"


def test_a_pytorch_oom_in_a_fatal_slot_reads_as_oom(tmp_path):
    d = str(tmp_path)
    import torch

    _ring(d, fatal=torch.OutOfMemoryError(TORCH_OOM), end=("exit", {"clean": False}))
    rank0 = pm.assemble([d])["ranks"][0]
    assert rank0["verdict"] == "oom" and rank0["oom"]["source"] == "flight_ring"
    assert rank0["oom"]["oom"]["requested_bytes"] == 2 * 1024 ** 3
    assert "OOM: requested 2.0GiB" in pm.format_text(pm.assemble([d]))


def test_oom_report_files_cross_between_the_packages(tmp_path):
    report = memory.parse_resource_exhausted(JAX_GPU_OOM)
    ours, theirs = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    memory.write_oom_report(ours, report, {"static": {"bytes_per_device": 5}})
    jax_memory.write_oom_report(theirs, report, {"static": {"bytes_per_device": 5}})
    a, b = jax_memory.read_oom_report(ours), memory.read_oom_report(theirs)
    assert _normalise(a, "") == _normalise(b, "")
    assert memory.summary_line(a["ledger"]) == jax_memory.summary_line(a["ledger"])
    assert memory.read_oom_report(str(tmp_path / "absent")) is None
    assert memory.write_oom_report(str(tmp_path / "no" / "dir.json"), report) is None
    assert counters.get("mem.oom_report_errors") == 1
    for n in (None, 0, 512, 1536, 5 * 1024 ** 3, -2048, 3 * 1024 ** 5):
        assert memory.fmt_bytes(n) == jax_memory.fmt_bytes(n)


def test_record_peak_hbm_equals_jax():
    for rec in ({"allocator": {"peak_bytes_in_use": 7}}, {"xla": {"peak_bytes": 5}},
                {"reconciliation": {"bytes_in_use": 3}}, {}, {"allocator": {}}):
        assert memory.record_peak_hbm(rec) == jax_memory.record_peak_hbm(rec)


def test_the_schema_literal_is_the_histories():
    from tpu_dist_torch.metrics.history import SCHEMA_VERSION

    assert pm.POSTMORTEM_SCHEMA_VERSION == jax_pm.POSTMORTEM_SCHEMA_VERSION == SCHEMA_VERSION


def test_a_heartbeat_from_now_is_read_back(tmp_path):
    with open(tmp_path / "hb.json", "w") as f:
        json.dump({"counter": 1, "ts": time.time()}, f)
    assert pm.assemble([str(tmp_path)])["ranks"][0]["heartbeat"]["counter"] == 1
