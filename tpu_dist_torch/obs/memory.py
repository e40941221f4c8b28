"""Device-memory forensics: the OOM report part of
``tpu_dist/obs/memory.py`` (``tpu_dist/obs/memory.py:404-673``), and the
one gating scalar the history summary reads from a ledger snapshot.

An out-of-memory error's text is parsed into a typed report
(:func:`parse_resource_exhausted`): the failed request, the used and
limit bytes, the largest buffers where the text lists them. The parser
reads the JAX package's ``RESOURCE_EXHAUSTED`` texts as that package
does, and PyTorch's CUDA text (``CUDA out of memory. Tried to allocate
2.00 GiB. GPU 0 has a total capacity of 79.10 GiB of which ...``), whose
lowercase "out of memory" the JAX markers miss. :func:`write_oom_report`
writes the report beside the flight ring as ``oom.json``, which ``obs
postmortem`` turns into the ``oom`` verdict.

The ledger itself (the static per-leaf accounting, the live census and
its reconciliation with the allocator, the pre-flight check and the
``obs memory`` report) is not ported: ROADMAP Queue A 6.
"""

from __future__ import annotations

import json
import re
import time
from typing import List, Optional

from tpu_dist_torch.obs import counters as counters_lib

#: Per-rank OOM-report artifact name inside a crash directory (rank 0
#: bare, rank k ``.h<k>``, as the flight ring).
OOM_NAME = "oom.json"


def record_peak_hbm(rec: dict) -> Optional[int]:
    """A ledger snapshot's gating scalar (a ``memory`` history record, of
    either package): the allocator's peak where the record has one, else
    XLA's static ``peak_bytes`` estimate, else the reconciled
    ``bytes_in_use``. None on an empty record."""
    alloc = rec.get("allocator") or {}
    v = alloc.get("peak_bytes_in_use")
    if isinstance(v, (int, float)) and v > 0:
        return int(v)
    xla = rec.get("xla") or {}
    v = xla.get("peak_bytes")
    if isinstance(v, (int, float)) and v > 0:
        return int(v)
    v = (rec.get("reconciliation") or {}).get("bytes_in_use")
    return int(v) if isinstance(v, (int, float)) and v > 0 else None


# -- OOM forensics: an out-of-memory text -> a typed report ------------------

_SIZE_RE = r"(\d+(?:\.\d+)?)\s*([KMGTP]i?B?|B|bytes?)"
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED", "Out of memory", "Ran out of memory",
    "OOM when allocating",
    "CUDA out of memory",  # PyTorch's torch.OutOfMemoryError
)
#: Multiplier per size-prefix letter; the ``iB``/``B`` tail and letter
#: case are normalized away in :func:`_to_bytes` (the size regexes run
#: IGNORECASE, so a lowercase ``2.5g`` must not silently parse as 2 B).
_UNIT_PREFIX = {
    "K": 1024, "M": 1024 ** 2, "G": 1024 ** 3,
    "T": 1024 ** 4, "P": 1024 ** 5,
}

_ALLOCATE_RE = re.compile(
    r"allocat\w+\s+(?:of\s+)?" + _SIZE_RE, re.IGNORECASE
)
_USED_OF_RE = re.compile(
    r"Used\s+" + _SIZE_RE + r"\s+of\s+" + _SIZE_RE, re.IGNORECASE
)
_EXCEEDED_RE = re.compile(
    r"Exceeded\s+\w+\s+capacity\s+by\s+" + _SIZE_RE, re.IGNORECASE
)
# PyTorch's accounting: "GPU 0 has a total capacity of 79.10 GiB of which
# 1.05 GiB is free. ... Of the allocated memory 76.50 GiB is allocated by
# PyTorch, and ..."
_TORCH_LIMIT_RE = re.compile(r"total capacity of\s+" + _SIZE_RE, re.IGNORECASE)
_TORCH_USED_RE = re.compile(
    r"allocated memory\s+" + _SIZE_RE + r"\s+is allocated by PyTorch", re.IGNORECASE
)
_BUFFER_RE = re.compile(r"^\s*(\d+)\.\s+Size:\s*" + _SIZE_RE)
_SHAPE_RE = re.compile(r"^\s*Shape:\s*(\S.*)$")
_OP_RE = re.compile(r'^\s*Operator:\s*op_name="([^"]*)"')
_XLA_LABEL_RE = re.compile(r"^\s*XLA Label:\s*(\S.*)$")


def _to_bytes(num: str, unit: str) -> int:
    u = unit.strip()
    if u.lower() in ("b", "byte", "bytes"):
        return int(float(num))
    return int(float(num) * _UNIT_PREFIX.get(u[0].upper(), 1))


def parse_resource_exhausted(text: str) -> Optional[dict]:
    """Structure an XLA ``RESOURCE_EXHAUSTED`` or a PyTorch CUDA OOM message. Returns None when
    the text carries no OOM marker at all (garbage / a different error);
    otherwise a typed report with whatever the (possibly TRUNCATED —
    flight-ring slots cap messages at 200 chars) text still holds:

    * ``headline`` — the first marker line, trimmed,
    * ``requested_bytes`` — the failed allocation ("while trying to
      allocate 2.50G"),
    * ``used_bytes`` / ``limit_bytes`` / ``excess_bytes`` — XLA's
      "Used X of Y hbm … Exceeded hbm capacity by Z" accounting, or
      PyTorch's "total capacity of Y … X is allocated by PyTorch",
    * ``buffers`` — the "Largest program allocations" table, each entry
      ``{rank, size_bytes, shape?, op?}`` (up to 16),
    * ``buffers_bytes`` — their sum.

    Absent fields were simply not in the text; a report with only a
    headline is still a report (the truncated-ring case)."""
    if not text or not any(m in text for m in _OOM_MARKERS):
        return None
    report: dict = {"kind": "oom"}
    for line in text.splitlines():
        if any(m in line for m in _OOM_MARKERS):
            report["headline"] = line.strip()[:240]
            break
    m = _ALLOCATE_RE.search(text)
    if m:
        report["requested_bytes"] = _to_bytes(m.group(1), m.group(2))
    m = _USED_OF_RE.search(text)
    if m:
        report["used_bytes"] = _to_bytes(m.group(1), m.group(2))
        report["limit_bytes"] = _to_bytes(m.group(3), m.group(4))
    else:
        lim, used = _TORCH_LIMIT_RE.search(text), _TORCH_USED_RE.search(text)
        if lim and used:
            report["used_bytes"] = _to_bytes(used.group(1), used.group(2))
            report["limit_bytes"] = _to_bytes(lim.group(1), lim.group(2))
    m = _EXCEEDED_RE.search(text)
    if m:
        report["excess_bytes"] = _to_bytes(m.group(1), m.group(2))
    buffers: List[dict] = []
    cur: Optional[dict] = None
    for line in text.splitlines():
        bm = _BUFFER_RE.match(line)
        if bm:
            if len(buffers) >= 16:
                break
            cur = {
                "rank": int(bm.group(1)),
                "size_bytes": _to_bytes(bm.group(2), bm.group(3)),
            }
            buffers.append(cur)
            continue
        if cur is None:
            continue
        sm = _SHAPE_RE.match(line)
        if sm:
            cur["shape"] = sm.group(1).strip()[:120]
            continue
        om = _OP_RE.match(line) or _XLA_LABEL_RE.match(line)
        if om and "op" not in cur:
            cur["op"] = om.group(1).strip()[:160]
    if buffers:
        report["buffers"] = buffers
        report["buffers_bytes"] = sum(b["size_bytes"] for b in buffers)
    return report


def oom_summary_line(report: dict) -> str:
    """One human line for the rank-0 warning / tail event / postmortem:
    ``'OOM: requested 2.5GiB, used 15.9GiB of 16.0GiB (3 largest buffers
    account for 12.1GiB)'``."""
    parts = []
    if report.get("requested_bytes"):
        parts.append(f"requested {fmt_bytes(report['requested_bytes'])}")
    if report.get("used_bytes") and report.get("limit_bytes"):
        parts.append(
            f"used {fmt_bytes(report['used_bytes'])} of "
            f"{fmt_bytes(report['limit_bytes'])}"
        )
    elif report.get("excess_bytes"):
        parts.append(f"over capacity by {fmt_bytes(report['excess_bytes'])}")
    if report.get("buffers"):
        parts.append(
            f"{len(report['buffers'])} largest buffers account for "
            f"{fmt_bytes(report.get('buffers_bytes', 0))}"
        )
    return "OOM: " + (", ".join(parts) if parts else
                      report.get("headline", "RESOURCE_EXHAUSTED"))


def write_oom_report(
    path: str, report: dict, snapshot: Optional[dict] = None,
) -> Optional[str]:
    """The crash artifact: the parsed allocation report plus the ledger
    snapshot that was live at the time, as one JSON next to the flight
    ring. Never raises — a full disk must not mask the OOM that is
    already propagating."""
    rec = {"ts": round(time.time(), 3), "oom": report}
    if snapshot:
        rec["ledger"] = snapshot
    try:
      
        # the caller derives one oom.json path per rank (per_rank_path),
        # exactly the flight-ring discipline
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    except OSError:
        counters_lib.inc("mem.oom_report_errors")
        return None
    return path


def read_oom_report(path: str) -> Optional[dict]:
    """Postmortem-side read of :func:`write_oom_report`'s artifact; None
    on a missing/torn file (the expected input after a crash)."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


# -- formatting ------------------------------------------------------------------


def fmt_bytes(n) -> str:
    """Human bytes: ``'1.5GiB'`` / ``'320.0MiB'`` / ``'512B'`` / ``'-'``."""
    if not isinstance(n, (int, float)):
        return "-"
    neg = n < 0
    v = float(abs(n))
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            body = f"{v:.0f}B" if unit == "B" else f"{v:.1f}{unit}"
            return ("-" if neg else "") + body
        v /= 1024
    return str(n)


def summary_line(rec: dict) -> str:
    """One line per ledger snapshot (the trainer's OOM line and the
    postmortem text); the port writes an empty snapshot until the ledger
    is ported, which reads ``memory ledger: (empty)``."""
    static = rec.get("static") or {}
    xla = rec.get("xla") or {}
    rc = rec.get("reconciliation") or {}
    parts = []
    if static.get("bytes_per_device"):
        parts.append(f"static {fmt_bytes(static['bytes_per_device'])}/device")
    if isinstance(xla.get("peak_bytes"), (int, float)):
        parts.append(f"xla peak {fmt_bytes(xla['peak_bytes'])}")
    if rc:
        parts.append(
            f"in use {fmt_bytes(rc.get('bytes_in_use'))} "
            f"(attributed {fmt_bytes(rc.get('attributed_bytes'))} + "
            f"unattributed {fmt_bytes(rc.get('unattributed_bytes'))}, "
            f"{rc.get('source')})"
        )
    return "memory ledger: " + (", ".join(parts) or "(empty)")


def format_oom_text(report: dict) -> str:
    lines = [oom_summary_line(report)]
    if report.get("headline"):
        lines.append(f"  {report['headline']}")
    for b in report.get("buffers") or []:
        lines.append(
            f"  {b['rank']:>3}. {fmt_bytes(b['size_bytes']):>10}"
            + (f"  {b['shape']}" if b.get("shape") else "")
            + (f"  {b['op']}" if b.get("op") else "")
        )
    return "\n".join(lines)
