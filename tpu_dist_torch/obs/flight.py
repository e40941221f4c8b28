"""Flight recorder: a per-rank event ring that survives a SIGKILL, and the
on-demand stack capture. The port's copy of ``tpu_dist/obs/flight.py``;
the ring file is the JAX package's byte for byte, so a ring written by
either package decodes to the same records under the other's
:func:`decode`.

* :class:`FlightRecorder`: ``n_slots`` fixed slots of ``slot_size``
  bytes after a fixed-size header, each record written with one
  ``os.pwrite`` into slot ``seq % n_slots`` as ``crc32-hex SP json NL``
  padded with NULs. The file never grows and holds no buffer, so a hard
  kill tears at most the slot being written, which :func:`decode` counts
  as torn instead of raising. The last ``n_slots`` events of the run stay
  readable.
* Fatal slots: :meth:`FlightRecorder.install_excepthooks` wraps
  ``sys.excepthook`` and ``threading.excepthook`` so an unhandled
  exception stamps a ``fatal`` record (type, message, innermost frames)
  before the interpreter dies; the previous hooks still run.
* Stack capture: :func:`arm_faulthandler` points ``faulthandler`` at a
  per-rank file for hard faults and registers ``SIGUSR1`` as an
  all-threads dump; :func:`parse_stack_dump` turns that text back into
  frames and :func:`stuck_frame` names where the process was.

Host-side file I/O at step boundaries only: nothing here touches the
device, and the module imports only the standard library and the
counter registry, so the decoder runs wherever the ring is copied.
"""

from __future__ import annotations

import io
import json
import os
import re
import sys
import threading
import time
import traceback
import zlib
from typing import Dict, List, Optional, Tuple

from tpu_dist_torch.obs import counters as counters_lib

#: Ring geometry defaults: 256 slots x 512 B = a 128 KiB file holding the
#: last ~256 events — at one step record per step plus sparse events,
#: minutes of context on a fast loop, hours on a slow one.
DEFAULT_SLOT_SIZE = 512
DEFAULT_N_SLOTS = 256
#: Fixed-size header region before slot 0. The header is itself
#: CRC-free JSON — a run killed before the first slot still identifies
#: itself; a torn header degrades the decode to the geometry defaults.
HEADER_SIZE = 256
_MAGIC = b"TDFR1 "

#: Canonical per-rank artifact names inside a ``--crash_dir`` (rank 0
#: bare, rank k ``.h<k>`` — ``heartbeat.per_rank_path``, the ONE naming
#: scheme every forensic reader shares).
RING_NAME = "flight.ring"
STACKS_NAME = "stacks.txt"


def _encode_slot(payload: str, slot_size: int) -> Optional[bytes]:
    """``crc32-hex SP payload NL`` padded with NULs; None when it cannot
    fit (caller shrinks the payload and retries)."""
    body = payload.encode("utf-8", "replace")
    raw = b"%08x %s\n" % (zlib.crc32(body), body)
    if len(raw) > slot_size:
        return None
    return raw + b"\0" * (slot_size - len(raw))


class FlightRecorder:
    """One writer per ring file (the trainer derives one path per rank).

    Every mutation is a single ``pwrite`` into a preallocated region —
    no append, no flush discipline, no growth. ``record`` NEVER raises:
    forensics must not be able to kill the training step it documents
    (failed writes are counted, ``flight.write_errors``)."""

    def __init__(
        self,
        path: str,
        *,
        slot_size: int = DEFAULT_SLOT_SIZE,
        n_slots: int = DEFAULT_N_SLOTS,
        run_id: Optional[str] = None,
        rank: Optional[int] = None,
    ):
        if slot_size < 64 or n_slots < 2:
            raise ValueError(
                f"ring needs slot_size >= 64 and n_slots >= 2, got "
                f"{slot_size}/{n_slots}"
            )
        self.path = path
        self.slot_size = slot_size
        self.n_slots = n_slots
        self.run_id = run_id
        self.rank = rank
        self.seq = 0
        self._lock = threading.Lock()
        self._last_counters: Dict[str, object] = {}
        self._prev_sys_hook = None
        self._prev_thread_hook = None
        self._sys_wrapper = None
        self._thread_wrapper = None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        # start from an EMPTY ring: truncate away any previous process's
        # slots first (an elastic relaunch reuses the same --crash_dir
        # path, and stale slots carry valid CRCs — decode would sort the
        # old run's records into this run's tail and a hard kill could
        # read as the previous round's clean 'preempt'), then extend to
        # the full geometry (sparse zeros decode as empty slots)
        os.ftruncate(self._fd, 0)
        os.ftruncate(self._fd, HEADER_SIZE + slot_size * n_slots)
        header = {
            "slot_size": slot_size, "n_slots": n_slots,
            "pid": os.getpid(), "ts": round(time.time(), 3),
        }
        if run_id:
            header["run_id"] = str(run_id)[:64]
        if rank is not None:
            header["rank"] = rank
        raw = _MAGIC + json.dumps(header).encode() + b"\n"
        os.pwrite(self._fd, raw[:HEADER_SIZE].ljust(HEADER_SIZE, b"\0"), 0)

    # -- writing ----------------------------------------------------------

    def record(self, kind: str, **fields) -> bool:
        """Stamp one slot. Oversized records shed their bulk (the
        ``counters`` delta first, then long strings) rather than fail —
        a slot ALWAYS lands unless the filesystem itself refuses."""
        rec = {"seq": None, "t": round(time.time(), 3), "kind": kind}
        rec.update(fields)
        try:
            with self._lock:
                self.seq += 1
                rec["seq"] = self.seq
                raw = self._fit(rec)
                off = HEADER_SIZE + ((self.seq - 1) % self.n_slots) * self.slot_size
                os.pwrite(self._fd, raw, off)
            return True
        except (OSError, ValueError, TypeError):
            # ValueError: fd closed under us (interpreter teardown);
            # TypeError: unserializable field — shed everything but the kind
            counters_lib.inc("flight.write_errors")
            return False

    def _fit(self, rec: dict) -> bytes:
        raw = _encode_slot(json.dumps(rec, default=str), self.slot_size)
        if raw is not None:
            return raw
        slim = dict(rec)
        slim.pop("counters", None)  # the usual bulk: shed it first
        raw = _encode_slot(json.dumps(slim, default=str), self.slot_size)
        if raw is not None:
            return raw
        for k, v in list(slim.items()):  # long strings/lists next
            if isinstance(v, str) and len(v) > 80:
                slim[k] = v[:80]
            elif isinstance(v, (list, tuple)) and len(v) > 4:
                slim[k] = list(v)[:4]
        slim["overflow"] = True
        raw = _encode_slot(json.dumps(slim, default=str), self.slot_size)
        if raw is not None:
            return raw
        return _encode_slot(
            json.dumps({"seq": rec["seq"], "t": rec["t"],
                        "kind": rec["kind"], "overflow": True}),
            self.slot_size,
        )

    def step(self, epoch: int, step: int) -> bool:
        """The step-boundary record: position plus the counter registry's
        numeric delta since the previous step record — the last slots of
        a killed run read as 'step 412: +1 ckpt write, +3 batches, then
        nothing', which is the whole forensic point."""
        cur = counters_lib.snapshot()
        delta = counters_lib.delta(self._last_counters, cur)
        self._last_counters = cur
        return self.record(
            "step", epoch=epoch, step=step,
            **({"counters": delta} if delta else {}),
        )

    def span_open(self, name: str, args: Optional[dict] = None) -> None:
        """``spans.set_open_listener`` target: every host span OPEN (ckpt
        write, restore ladder, loader produce, eval) stamps a slot — the
        ring then shows which host operation was in flight at death."""
        self.record("span", name=name)

    def fatal(self, exc_type, exc, tb, thread: Optional[str] = None) -> bool:
        """The last-words slot: type, message, innermost frames."""
        frames: List[str] = []
        try:
            for fr in traceback.extract_tb(tb)[-6:]:
                frames.append(f"{fr.filename}:{fr.lineno}:{fr.name}")
        except Exception:  # tpu-dist: ignore[TD006] — a broken traceback must not lose the record
            pass  # object must not lose the fatal record itself
        return self.record(
            "fatal",
            error=getattr(exc_type, "__name__", str(exc_type)),
            message=str(exc)[:200],
            frames=frames,
            **({"thread": thread} if thread else {}),
        )

    def close(self, kind: str = "exit", **fields) -> None:
        """Stamp a terminal record and release the fd. A ring whose last
        record is ``exit``/``preempt`` ended on its own terms; one that
        just stops is the signature of a hard kill."""
        self.record(kind, **fields)
        with self._lock:
            fd, self._fd = self._fd, -1
            if fd >= 0:
                try:
                    os.close(fd)
                # tpu-dist: ignore[TD006] — already closed
                except OSError:
                    pass

    # -- excepthooks ------------------------------------------------------

    def install_excepthooks(self) -> None:
        """Wrap ``sys.excepthook`` + ``threading.excepthook`` so an
        unhandled exception anywhere stamps a ``fatal`` slot, then chain
        to the previous hooks (their output still appears)."""
        if self._prev_sys_hook is not None:
            return  # already installed

        prev_sys = sys.excepthook
        prev_thread = threading.excepthook

        def _sys_hook(exc_type, exc, tb):
            self.fatal(exc_type, exc, tb)
            prev_sys(exc_type, exc, tb)

        def _thread_hook(hook_args):
            self.fatal(
                hook_args.exc_type, hook_args.exc_value,
                hook_args.exc_traceback,
                thread=getattr(hook_args.thread, "name", None),
            )
            prev_thread(hook_args)

        self._prev_sys_hook = prev_sys
        self._prev_thread_hook = prev_thread
        self._sys_wrapper = _sys_hook
        self._thread_wrapper = _thread_hook
        sys.excepthook = _sys_hook
        threading.excepthook = _thread_hook

    def uninstall_excepthooks(self) -> None:
        """Restore the chained hooks. Idempotent, and unwinds our layer
        ONLY when it is still on top: if someone wrapped the hooks after
        us, blindly restoring ``_prev_*`` would drop their layer for the
        rest of the process — instead we leave the chain intact (the
        newer wrapper keeps chaining through ours, which goes quiet once
        the ring closes)."""
        if self._prev_sys_hook is not None:
            if sys.excepthook is self._sys_wrapper:
                sys.excepthook = self._prev_sys_hook
            self._prev_sys_hook = None
        if self._prev_thread_hook is not None:
            if threading.excepthook is self._thread_wrapper:
                threading.excepthook = self._prev_thread_hook
            self._prev_thread_hook = None


# --------------------------------------------------------------------------
# Decoding — torn-tail tolerant by construction.
# --------------------------------------------------------------------------


def decode(path: str) -> dict:
    """Read a ring back: ``{"header", "records", "torn_slots",
    "empty_slots", "last"}`` with records ordered by ``seq``.

    NEVER raises on content: a torn header falls back to the geometry
    defaults, a torn slot (the SIGKILL-mid-pwrite case) is counted in
    ``torn_slots``, an all-zero slot counts as empty. Only a genuinely
    unreadable file raises ``OSError`` — the caller decides whether
    absence means 'never armed' or 'lost'."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    torn_header = False
    head = data[:HEADER_SIZE]
    if head.startswith(_MAGIC):
        try:
            header = json.loads(head[len(_MAGIC):].split(b"\0", 1)[0])
        except (json.JSONDecodeError, UnicodeDecodeError):
            torn_header = True
    else:
        torn_header = bool(head.strip(b"\0"))
    slot_size = (
        int(header["slot_size"])
        if isinstance(header, dict)
        and isinstance(header.get("slot_size"), int)
        and header["slot_size"] >= 64
        else DEFAULT_SLOT_SIZE
    )
    records: List[dict] = []
    torn = 0
    empty = 0
    body = data[HEADER_SIZE:]
    for i in range(0, len(body), slot_size):
        chunk = body[i:i + slot_size].rstrip(b"\0")
        if not chunk:
            empty += 1
            continue
        if chunk.endswith(b"\n"):
            chunk = chunk[:-1]
        m = re.match(rb"([0-9a-f]{8}) (.*)$", chunk, re.DOTALL)
        if not m:
            torn += 1
            continue
        crc, payload = m.group(1), m.group(2)
        if zlib.crc32(payload) != int(crc, 16):
            torn += 1
            continue
        try:
            rec = json.loads(payload)
        except (json.JSONDecodeError, UnicodeDecodeError):
            torn += 1
            continue
        if isinstance(rec, dict) and isinstance(rec.get("seq"), int):
            records.append(rec)
        else:
            torn += 1
    records.sort(key=lambda r: r["seq"])
    return {
        "header": header,
        "torn_header": torn_header,
        "records": records,
        "torn_slots": torn,
        "empty_slots": empty,
        "last": records[-1] if records else None,
    }


def last_step(decoded: dict) -> Optional[dict]:
    """The newest ``step`` record of a decoded ring — where the run was
    when it stopped writing."""
    for rec in reversed(decoded.get("records") or []):
        if rec.get("kind") == "step":
            return rec
    return None


def fatal_records(decoded: dict) -> List[dict]:
    return [
        r for r in (decoded.get("records") or []) if r.get("kind") == "fatal"
    ]


# --------------------------------------------------------------------------
# faulthandler arming — hard-fault tracebacks + SIGUSR1 all-threads dump.
# --------------------------------------------------------------------------


class _FaulthandlerHandle:
    """What :func:`arm_faulthandler` returns; :func:`disarm_faulthandler`
    needs the open file plus the prior-state bookkeeping."""

    def __init__(self, path: str, f: io.IOBase, was_enabled: bool,
                 registered: bool):
        self.path = path
        self.file = f
        self.was_enabled = was_enabled
        self.registered = registered


def arm_faulthandler(path: str) -> Optional[_FaulthandlerHandle]:
    """Point ``faulthandler`` at ``path`` (append mode — dumps
    accumulate) for hard faults AND register ``SIGUSR1`` as an
    on-demand all-threads dump. Returns a handle for
    :func:`disarm_faulthandler`, or None when the platform refuses
    (no SIGUSR1 on Windows; arming is then skipped, never fatal)."""
    import faulthandler
    import signal

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # line-buffered, so a dump survives a kill
    # tpu-dist: ignore[TD002] — per-rank crash file by design (the rank derives its own path)
    f = open(path, "a", buffering=1)
    was_enabled = faulthandler.is_enabled()
    faulthandler.enable(file=f, all_threads=True)
    registered = False
    try:
        faulthandler.register(
            signal.SIGUSR1, file=f, all_threads=True, chain=False
        )
        registered = True
    # tpu-dist: ignore[TD006] — degraded arming is the contract: no SIGUSR1 here, hard
    # faults only
    except (AttributeError, ValueError, OSError):
        pass
    return _FaulthandlerHandle(path, f, was_enabled, registered)


def disarm_faulthandler(handle: Optional[_FaulthandlerHandle]) -> None:
    """Undo :func:`arm_faulthandler`: unregister the SIGUSR1 dump, and
    restore faulthandler to its prior disposition (back onto stderr when
    something else — e.g. pytest — had it enabled, off otherwise)."""
    if handle is None:
        return
    import faulthandler
    import signal

    if handle.registered:
        try:
            faulthandler.unregister(signal.SIGUSR1)
        # tpu-dist: ignore[TD006] — nothing registered: nothing to undo
        except (AttributeError, ValueError):
            pass
    if handle.was_enabled:
        faulthandler.enable()  # back to stderr, the pre-arm owner
    else:
        faulthandler.disable()
    try:
        handle.file.close()
    # tpu-dist: ignore[TD006] — already closed
    except OSError:
        pass


# --------------------------------------------------------------------------
# Stack-dump parsing — faulthandler text back into frames.
# --------------------------------------------------------------------------

_THREAD_RE = re.compile(
    r"^(Current thread|Thread) (0x[0-9a-fA-F]+)(?: \(([^)]*)\))?"
)
_FRAME_RE = re.compile(r'^  File "([^"]+)", line (\d+) in (.+)$')


def parse_stack_dump(text: str) -> dict:
    """Structure a faulthandler dump file: ``{"threads": [...],
    "current": {...}|None, "n_dumps": k}``.

    The file accumulates (SIGUSR1 appends) so threads are grouped into
    dumps — a new dump starts whenever a ``Current thread``/``Thread``
    header follows a frame or fatal line of a previous block's current
    thread; in practice every dump ends with the current thread, so the
    LAST dump is what the accessors report. Each thread entry:
    ``{"thread", "name", "current", "frames": [[file, line, func],
    ...]}`` with frames most-recent-first (the faulthandler order)."""
    dumps: List[List[dict]] = []
    cur_dump: List[dict] = []
    cur_thread: Optional[dict] = None
    for line in text.splitlines():
        m = _THREAD_RE.match(line)
        if m:
            if cur_dump and any(t["current"] for t in cur_dump):
                # a previous dump already closed with its current thread:
                # this header opens a NEW dump
                dumps.append(cur_dump)
                cur_dump = []
            cur_thread = {
                "thread": m.group(2),
                "name": m.group(3),
                "current": m.group(1) == "Current thread",
                "frames": [],
            }
            cur_dump.append(cur_thread)
            continue
        fm = _FRAME_RE.match(line)
        if fm and cur_thread is not None:
            cur_thread["frames"].append(
                [fm.group(1), int(fm.group(2)), fm.group(3)]
            )
    if cur_dump:
        dumps.append(cur_dump)
    last = dumps[-1] if dumps else []
    # the current thread's position inside a dump is interpreter-order,
    # not guaranteed last — take the LAST current-thread block anywhere
    # (the newest dump's, however the blocks were grouped)
    all_blocks = [t for d in dumps for t in d]
    current = next((t for t in reversed(all_blocks) if t["current"]), None)
    return {"threads": last, "current": current, "n_dumps": len(dumps)}


def stuck_frame(parsed: dict) -> Optional[str]:
    """One human line naming WHERE the dumped process was: the top
    (most recent) frame of the last dump's current thread —
    ``'get (tpu_dist_torch/data/loader.py:150)'``."""
    cur = parsed.get("current")
    if not cur or not cur.get("frames"):
        return None
    fname, lineno, func = cur["frames"][0]
    return f"{func} ({fname}:{lineno})"


def read_stack_dump(path: str, offset: int = 0) -> Optional[dict]:
    """Parse the dump file (from ``offset`` — the watchdog passes the
    pre-signal size so it reads only its dump). None when absent/empty."""
    try:
        with open(path, "r", errors="replace") as f:
            f.seek(offset)
            text = f.read()
    except OSError:
        return None
    if not text.strip():
        return None
    return parse_stack_dump(text)
