"""The port's flight recorder (``tpu_dist_torch/obs/flight.py``) held against
the JAX package's (``tpu_dist/obs/flight.py``), and the span-open tap of
``tpu_dist_torch/obs/spans.py``.

A ring is one file format: every ring below, written by either package,
decodes to the same dict under both ``decode``s, and the same sequence of
records written by each package gives the same records but for the wall
clock (``t``) and the header's ``pid``/``ts``. The cases: wraparound past
``n_slots``, a torn slot, an oversized record shed to fit, counter deltas
on ``step`` records, a ``fatal`` slot from an unhandled exception in a
subprocess (main thread and worker thread), and a ring SIGKILLed while
its writer hammers it. ``last_step``, ``fatal_records``,
``parse_stack_dump``, ``stuck_frame`` and ``read_stack_dump`` equal the
JAX functions on the same inputs, real faulthandler dumps included. All
comparisons are exact: no arithmetic differs.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest
from torch_ranks import child_env

from tpu_dist.obs import counters as jax_counters
from tpu_dist.obs import flight as jax_flight
from tpu_dist_torch.obs import counters, flight, spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (flight, counters), "jax": (jax_flight, jax_counters)}
WALL = ("t",)


@pytest.fixture(autouse=True)
def _fresh_registries():
    counters.reset()
    jax_counters.reset()
    yield
    counters.reset()
    jax_counters.reset()


def _both_decode(path):
    """Decode with both packages; they must agree exactly."""
    ours, theirs = flight.decode(path), jax_flight.decode(path)
    assert ours == theirs
    return ours


def _strip(decoded):
    recs = [{k: v for k, v in r.items() if k not in WALL} for r in decoded["records"]]
    header = {k: v for k, v in (decoded["header"] or {}).items() if k not in ("pid", "ts")}
    return header, recs, decoded["torn_slots"], decoded["empty_slots"]


def _write(pkg, path, script):
    fl, cnt = PACKAGES[pkg]
    return script(fl, cnt, path)


def _wraparound(fl, cnt, path):
    rec = fl.FlightRecorder(path, run_id="run-1", rank=3, n_slots=8, slot_size=256)
    rec.record("open", world=4, dp=4)
    for i in range(20):
        cnt.inc("train.steps")
        rec.step(0, i)
    rec.close("exit", clean=True)


def _deltas(fl, cnt, path):
    rec = fl.FlightRecorder(path, n_slots=16)
    cnt.inc("ckpt.writes", 2)
    cnt.set_gauge("run.id", "abc")  # a string gauge: never in a delta
    rec.step(1, 0)
    cnt.inc("ckpt.writes", 5)
    cnt.inc("loader.data_wait_s", 0.25)
    rec.step(1, 1)
    rec.step(1, 2)  # nothing moved: no counters key
    rec.span_open("ckpt/write", {"file": "ckpt_1.npz"})
    rec.record("preempt", epoch=1)


def _oversized(fl, cnt, path):
    rec = fl.FlightRecorder(path, n_slots=4, slot_size=256)
    for i in range(40):
        cnt.inc(f"some.rather.long.counter_name_{i}", i + 1)
    rec.step(0, 0)  # the counters delta cannot fit: shed
    rec.record("note", message="x" * 500, items=list(range(50)))  # trimmed
    rec.record("huge", **{f"k{i}": "v" * 60 for i in range(8)})  # overflow stub


@pytest.mark.parametrize("script", [_wraparound, _deltas, _oversized],
                         ids=["wraparound", "deltas", "oversized"])
def test_rings_cross_between_the_packages(tmp_path, script):
    got = {}
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg}.ring")
        _write(pkg, path, script)
        dec = _both_decode(path)
        got[pkg] = _strip(dec)
        geometry = dec["header"]["slot_size"] * dec["header"]["n_slots"]
        assert os.path.getsize(path) == flight.HEADER_SIZE + geometry  # the file never grows
    assert got["port"] == got["jax"]
    header, recs, torn, _ = got["port"]
    assert torn == 0
    if script is _wraparound:
        assert header == {"slot_size": 256, "n_slots": 8, "run_id": "run-1", "rank": 3}
        assert [r["seq"] for r in recs] == list(range(15, 23)) and recs[-1]["clean"] is True
    if script is _deltas:
        assert [r.get("counters") for r in recs[:3]] == [
            {"ckpt.writes": 2}, {"ckpt.writes": 5, "loader.data_wait_s": 0.25}, None]
        assert recs[3] == {"seq": 4, "kind": "span", "name": "ckpt/write"}
    if script is _oversized:
        step, note, huge = recs[-3:]
        assert "counters" not in step and step["step"] == 0
        assert note["overflow"] is True and len(note["message"]) == 80
        assert note["items"] == [0, 1, 2, 3]
        assert huge == {"seq": 3, "kind": "huge", "overflow": True}


def test_a_slot_is_encoded_byte_for_byte_as_in_jax():
    for payload in ('{"seq": 1, "kind": "step"}', "é" * 10, "x" * 200):
        for size in (64, 128, 512):
            assert flight._encode_slot(payload, size) == jax_flight._encode_slot(payload, size)


def test_a_torn_slot_and_a_torn_header_decode_alike(tmp_path):
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg}.ring")
        _write(pkg, path, _wraparound)
        with open(path, "r+b") as f:
            f.seek(flight.HEADER_SIZE + 3 * 256 + 20)  # inside slot 3's payload
            f.write(b"#")
        dec = _both_decode(path)
        assert dec["torn_slots"] == 1 and len(dec["records"]) == 7
        with open(path, "r+b") as f:
            f.seek(len(b"TDFR1 ") + 3)
            f.write(b"\xff")
        dec = _both_decode(path)
        assert dec["header"] is None and dec["torn_header"] is True


def test_reopening_a_ring_starts_it_empty(tmp_path):
    path = str(tmp_path / "flight.ring")
    first = jax_flight.FlightRecorder(path, n_slots=8)
    first.record("open")
    first.close("preempt", epoch=0)
    second = flight.FlightRecorder(path, n_slots=8)
    second.record("open")
    dec = _both_decode(path)
    assert [r["kind"] for r in dec["records"]] == ["open"]
    second.close()


_FATAL_CHILD = """
import sys, threading
sys.path.insert(0, {root!r})
from {pkg}.obs import flight
rec = flight.FlightRecorder({path!r}, n_slots=16, run_id="r", rank=1)
rec.install_excepthooks()
rec.record("open")
rec.step(0, 0)
if {thread!r}:
    t = threading.Thread(target=lambda: 1 / 0, name="worker")
    t.start()
    t.join()
    rec.close("exit", clean=True)
else:
    raise ValueError("boom at step 0")
"""


@pytest.mark.parametrize("thread", [False, True], ids=["main", "thread"])
def test_an_unhandled_exception_stamps_the_same_fatal_slot(tmp_path, thread):
    got = {}
    for pkg in ("tpu_dist_torch", "tpu_dist"):
        path = str(tmp_path / f"{pkg}.ring")
        child = _FATAL_CHILD.format(root=ROOT, pkg=pkg, path=path, thread=thread)
        proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                              timeout=60, env=child_env(JAX_PLATFORMS="cpu"))
        assert proc.returncode == (0 if thread else 1), proc.stderr
        # the previous hook still ran: the traceback reached stderr
        assert ("ZeroDivisionError" if thread else "ValueError: boom") in proc.stderr
        dec = _both_decode(path)
        fatal = flight.fatal_records(dec)
        assert fatal == jax_flight.fatal_records(dec) and len(fatal) == 1
        f = {k: v for k, v in fatal[0].items() if k not in WALL}
        f["frames"] = [fr.rsplit(":", 2)[1:] for fr in f["frames"]]  # file paths differ
        got[pkg] = (f, _strip(dec)[0], flight.last_step(dec) == jax_flight.last_step(dec))
    assert got["tpu_dist_torch"] == got["tpu_dist"]
    f = got["tpu_dist_torch"][0]
    assert f["error"] == ("ZeroDivisionError" if thread else "ValueError")
    assert f.get("thread") == ("worker" if thread else None)


_HAMMER_CHILD = """
import sys
sys.path.insert(0, {root!r})
from tpu_dist_torch.obs import flight
rec = flight.FlightRecorder({path!r}, n_slots=32, slot_size=256)
rec.record("open", world=1)
i = 0
while True:
    rec.step(0, i)
    i += 1
"""


def test_a_ring_sigkilled_mid_write_keeps_its_complete_slots(tmp_path):
    path = str(tmp_path / "flight.ring")
    proc = subprocess.Popen([sys.executable, "-c", _HAMMER_CHILD.format(root=ROOT, path=path)],
                            env=child_env())
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if flight.decode(path)["records"][-1]["seq"] > 100:
                    break
            except (OSError, IndexError):
                pass
            time.sleep(0.02)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    dec = _both_decode(path)
    assert dec["torn_slots"] <= 1 and len(dec["records"]) >= 31
    seqs = [r["seq"] for r in dec["records"]]
    assert seqs == sorted(seqs) and sum(b - a - 1 for a, b in zip(seqs, seqs[1:])) <= 1
    assert dec["last"]["kind"] == "step"
    assert flight.last_step(dec) == jax_flight.last_step(dec) == dec["last"]


DUMP = (
    'Thread 0x00007f01 (producer):\n'
    '  File "/x/loader.py", line 118 in get\n'
    '  File "/x/loader.py", line 40 in run\n'
    'Current thread 0x00007f02 (most recent call first):\n'
    '  File "/x/trainer.py", line 399 in train_epoch\n'
    '  File "/x/trainer.py", line 330 in fit\n'
)


@pytest.mark.parametrize("text", [DUMP, DUMP + DUMP, "", "garbage\n",
                                  DUMP.replace("Current thread", "Thread")],
                         ids=["one", "two", "empty", "garbage", "no-current"])
def test_stack_dump_parsing_equals_jax(text):
    ours, theirs = flight.parse_stack_dump(text), jax_flight.parse_stack_dump(text)
    assert ours == theirs
    assert flight.stuck_frame(ours) == jax_flight.stuck_frame(theirs)


_DUMP_CHILD = """
import os, signal, sys, threading, time
sys.path.insert(0, {root!r})
from {pkg}.obs import flight
def parked():
    time.sleep(30)
threading.Thread(target=parked, name="parked", daemon=True).start()
h = flight.arm_faulthandler({path!r})
assert h is not None and h.registered
os.kill(os.getpid(), signal.SIGUSR1)
time.sleep(0.2)
os.kill(os.getpid(), signal.SIGUSR1)
time.sleep(0.2)
flight.disarm_faulthandler(h)
"""


def test_a_real_sigusr1_dump_reads_alike(tmp_path):
    for pkg in ("tpu_dist_torch", "tpu_dist"):
        path = str(tmp_path / f"{pkg}.stacks.txt")
        proc = subprocess.run(
            [sys.executable, "-c", _DUMP_CHILD.format(root=ROOT, pkg=pkg, path=path)],
            capture_output=True, text=True, timeout=60, env=child_env(JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr
        ours, theirs = flight.read_stack_dump(path), jax_flight.read_stack_dump(path)
        assert ours == theirs and ours["n_dumps"] == 2 and len(ours["threads"]) >= 2
        assert flight.stuck_frame(ours) == jax_flight.stuck_frame(theirs)
        assert flight.stuck_frame(ours).startswith("<module>")
        with open(path) as f:
            half = len(f.read()) // 2
        assert flight.read_stack_dump(path, half) == jax_flight.read_stack_dump(path, half)
    assert flight.read_stack_dump(str(tmp_path / "absent")) is None


def test_arm_and_disarm_restore_the_faulthandler_state(tmp_path):
    import faulthandler

    was = faulthandler.is_enabled()
    handle = flight.arm_faulthandler(str(tmp_path / "stacks.txt"))
    assert handle is not None and faulthandler.is_enabled()
    flight.disarm_faulthandler(handle)
    assert faulthandler.is_enabled() == was
    flight.disarm_faulthandler(None)


def test_uninstall_leaves_a_later_wrapper_in_place(tmp_path):
    rec = flight.FlightRecorder(str(tmp_path / "flight.ring"), n_slots=4)
    before = sys.excepthook
    rec.install_excepthooks()
    ours = sys.excepthook

    def later(*a):
        return ours(*a)

    sys.excepthook = later
    try:
        rec.uninstall_excepthooks()
        assert sys.excepthook is later
    finally:
        sys.excepthook = before
    rec.close()


def test_span_opens_reach_the_ring_with_the_recorder_disabled(tmp_path):
    assert not spans.enabled()
    rec = flight.FlightRecorder(str(tmp_path / "flight.ring"), n_slots=8)
    spans.set_open_listener(rec.span_open)
    try:
        with spans.span("ckpt/write", file="ckpt_0.npz"):
            pass
    finally:
        spans.clear_open_listener()
    with spans.span("ckpt/prune"):  # no listener, recorder off: a no-op
        pass
    assert spans.events() == []
    rec.close()
    kinds = [(r["kind"], r.get("name")) for r in flight.decode(rec.path)["records"]]
    assert kinds == [("span", "ckpt/write"), ("exit", None)]


def test_counter_delta_equals_jax():
    cases = [({}, {"a": 1, "b": 2.5, "s": "x"}), ({"a": 1, "b": 2.5}, {"a": 1, "b": 3.0}),
             (None, {"t": True, "n": 0})]
    for prev, cur in cases:
        assert counters.delta(prev, cur) == jax_counters.delta(prev, cur)
