"""Rank-0 checkpoint / resume in the JAX package's plain format: the port's
copy of ``tpu_dist/ckpt/checkpoint.py`` up to ``restore`` (the sharded
format after it is not ported).

One ``ckpt_{epoch}.npz`` holds the whole ``TrainState`` (parameters, BN
statistics, optimizer state, step, residuals) as flat arrays keyed by the
``jax.tree_util.keystr`` path of the JAX ``TrainState._asdict()``, in JAX
layout (:func:`tpu_dist_torch.bridge.train_state_to_flat`), plus a
``__meta__`` entry: the JSON of the epoch, the step, the caller's extra
meta and a CRC32 per entry. So a checkpoint written by either package
restores in the other. A file is published atomically (write to
``.tmp``, then ``os.replace``), retried on a transient ``OSError``
(:func:`set_io_retries`), and only rank 0 writes; every rank can read. A
state with flat parts over the ranks (ZeRO-1, int8_ef) is gathered first,
so then every rank calls the save.
The ``--fault_plan`` hooks (:mod:`tpu_dist_torch.resilience.faults`) sit
where the JAX writer has them: at the top of each write attempt, inside
the retry ladder, and after the publish.

Where the JAX writer may hold references to immutable arrays, the port's
parameters and momentum are updated in place by the next step, so the
device-to-host snapshot (:func:`_flatten`) always completes before a save
returns; only the npz write runs on :class:`AsyncCheckpointer`'s worker
thread. :func:`restore` returns host arrays; the caller copies them into
its live tensors (:func:`tpu_dist_torch.bridge.load_train_state`).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import time
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_dist_torch import bridge
from tpu_dist_torch.elastic.errors import ConfigMismatchError, ElasticShapeMismatch
from tpu_dist_torch.elastic.remap import classify
from tpu_dist_torch.obs import counters, spans
from tpu_dist_torch.resilience import faults
from tpu_dist_torch.resilience import retry as retry_lib

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
_META = "__meta__"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed integrity verification (torn write, CRC
    mismatch, unreadable archive). The restore ladder quarantines the file
    and falls back to the next older checkpoint."""


#: What a read of a damaged checkpoint raises below the integrity layer;
#: the restore ladder treats these like a CRC failure. (Not ValueError:
#: shape and layout mismatches are configuration errors, which raise.)
CKPT_READ_ERRORS = (OSError, EOFError, zlib.error, zipfile.BadZipFile, json.JSONDecodeError)

# Transient-write retries for every checkpoint write in this module
# (process-global; the Trainer sets it from --ckpt_io_retries).
_IO_RETRIES = 0


def set_io_retries(n: int) -> int:
    """Set the module-wide transient-write retry count; returns the
    previous value."""
    global _IO_RETRIES
    prev, _IO_RETRIES = _IO_RETRIES, max(0, int(n))
    return prev


def _entry_crc(arr: np.ndarray) -> int:
    """The JAX package's stamp (zlib CRC32 of the C-order bytes), read from
    the array's buffer without a copy when it is C-contiguous."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return zlib.crc32(arr.data) & 0xFFFFFFFF


def _flatten(state) -> Optional[Dict[str, np.ndarray]]:
    """The host snapshot of ``state`` on rank 0 (None elsewhere): finished
    when this returns, so the in-place updates of later steps cannot reach
    it. A state with a flat layout is gathered to rank 0 over the group,
    so every rank must call this for it; the others only send their
    parts."""
    return bridge.train_state_to_flat(state, dst=0)


def _write_npz(ckpt_dir: str, name: str, flat: dict, meta: dict,
               keep_last: Optional[int] = None) -> str:
    """Serialize and atomically publish one checkpoint file (host-side
    only, so it may run on a worker thread; ``flat`` holds host copies).
    Stamps a CRC32 per entry into ``__meta__``; transient write failures
    retry (:func:`set_io_retries`); then prunes to the ``keep_last``
    newest epoch checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = dict(flat)
    meta = dict(meta)
    meta["crc32"] = {k: _entry_crc(v) for k, v in flat.items()}
    flat[_META] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = os.path.join(ckpt_dir, name)
    tmp = path + ".tmp"

    def attempt() -> None:
        faults.on_ckpt_write()  # a no-op unless a --fault_plan clause is armed
        with open(tmp, "wb") as f:  # every caller holds the rank-0 guard
            np.savez(f, **flat)
        os.replace(tmp, path)  # atomic: a checkpoint is absent or complete

    with spans.span("ckpt/write", file=name):
        retry_lib.retry_call(attempt, retries=_IO_RETRIES, describe=f"write of {name}")
    counters.inc("ckpt.writes")
    try:
        counters.inc("ckpt.bytes_written", os.path.getsize(path))
    except OSError:  # telemetry only: a racing prune must not fail the publish
        pass
    faults.on_ckpt_published(path)  # the --fault_plan ckpt_corrupt hook (a no-op off)
    if keep_last is not None and keep_last > 0:
        with spans.span("ckpt/prune", keep_last=keep_last):
            sweep_stale_tmp(ckpt_dir)
            epochs = sorted(int(m.group(1)) for m in
                            (_CKPT_RE.search(n) for n in os.listdir(ckpt_dir)) if m)
            for e in epochs[:-keep_last]:
                try:
                    os.remove(os.path.join(ckpt_dir, f"ckpt_{e}.npz"))
                    counters.inc("ckpt.pruned")
                except OSError:  # best-effort: a file already gone must not fail a save
                    pass
    return path


def sweep_stale_tmp(ckpt_dir: str) -> List[str]:
    """Remove the ``*.npz.tmp`` (and the sharded format's
    ``*.manifest.json.tmp``) files that a crash between ``open(tmp)`` and
    ``os.replace`` leaked. Only for the writing rank with no write in
    flight (the prune and the resume start-up). Returns the names."""
    removed: List[str] = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return removed
    for n in names:
        if n.endswith(".npz.tmp") or n.endswith(".manifest.json.tmp"):
            try:
                os.remove(os.path.join(ckpt_dir, n))
                removed.append(n)
            except OSError:  # best-effort sweep
                pass
    return removed


def _epoch_meta(state, epoch: int, extra_meta: Optional[dict]) -> dict:
    meta = {"epoch": epoch, "step": int(state.step)}
    meta.update(extra_meta or {})
    return meta


def save(ckpt_dir: str, state, epoch: int, keep_last: Optional[int] = None,
         extra_meta: Optional[dict] = None, name: Optional[str] = None) -> Optional[str]:
    """Write ``ckpt_{epoch}.npz`` (or ``name``, a file the discovery regex
    never matches, so never resumed or pruned); returns its path, or None
    off rank 0. ``keep_last`` prunes to the N newest checkpoints;
    ``extra_meta`` adds JSON keys to the meta."""
    flat = _flatten(state)
    if flat is None:
        return None
    return _write_npz(ckpt_dir, name or f"ckpt_{epoch}.npz", flat,
                      _epoch_meta(state, epoch, extra_meta), keep_last)


def save_best(ckpt_dir: str, state, epoch: int, metric: float,
              extra_meta: Optional[dict] = None) -> Optional[str]:
    """Write or overwrite ``ckpt_best.npz`` (rank 0, atomic), tagged with
    the metric."""
    flat = _flatten(state)
    if flat is None:
        return None
    meta = {"epoch": epoch, "metric": metric}
    meta.update(extra_meta or {})
    return _write_npz(ckpt_dir, "ckpt_best.npz", flat, meta)


class _AsyncWriter:
    """One background worker that publishes writes in submission order. A
    save never blocks on an earlier write in flight; it only collects the
    errors of writes that already finished. ``wait()`` blocks on every
    outstanding write and re-raises the first error; call it (or
    ``close()``) before the process exits, as the Trainer does at the end
    of ``fit()`` and on an interrupt.

    ``wait``/``close`` take a ``timeout`` in seconds and return False when
    it expires with writes still in flight. A timed-out ``close`` cancels
    writes that have not started (their data is lost, and the caller says
    so); the write already running finishes, so no file is abandoned
    half-published."""

    def __init__(self) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                           thread_name_prefix="ckpt")
        self._pending: list = []

    @property
    def in_flight(self) -> int:
        """Writes submitted and not yet finished."""
        return sum(1 for f in self._pending if not f.done())

    def _harvest(self, block: bool, deadline: Optional[float] = None) -> bool:
        first_err = None
        drained = True
        while self._pending and (block or self._pending[0].done()):
            fut = self._pending[0]
            try:
                if deadline is None:
                    fut.result()
                else:
                    fut.result(max(0.0, deadline - time.monotonic()))
            except concurrent.futures.TimeoutError:
                if not fut.done():  # the drain's timeout, not the write's own error
                    drained = False
                    break
                if first_err is None:
                    first_err = fut.exception()
            except Exception as e:  # keep draining; re-raise the first
                if first_err is None:
                    first_err = e
            self._pending.pop(0)
        if first_err is not None:
            raise first_err
        return drained

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every outstanding write is published (re-raising
        the first writer error), or ``timeout`` seconds pass; False iff the
        timeout expired with writes in flight."""
        deadline = None if timeout is None else time.monotonic() + timeout
        return self._harvest(block=True, deadline=deadline)

    def close(self, timeout: Optional[float] = None) -> bool:
        """``wait(timeout)``, then release the worker thread (the instance
        is dead afterwards). False iff the bounded drain gave up."""
        try:
            drained = self.wait(timeout)
        except Exception:
            self._pool.shutdown(wait=True)
            raise
        if drained:
            self._pool.shutdown(wait=True)
        else:
            self._pool.shutdown(wait=False, cancel_futures=True)
        return drained

    def _submit(self, ckpt_dir: str, name: str, flat: dict, meta: dict,
                keep_last: Optional[int] = None) -> str:
        self._harvest(block=False)  # surface finished writes' errors only
        self._pending.append(self._pool.submit(_write_npz, ckpt_dir, name, flat, meta,
                                               keep_last))
        return os.path.join(ckpt_dir, name)


class AsyncCheckpointer(_AsyncWriter):
    """Checkpoint writes that overlap training. The device-to-host
    snapshot stays synchronous (the next step updates the live tensors in
    place); the npz serialization, atomic rename and prune run on one
    worker thread over the host copies."""

    def save(self, ckpt_dir: str, state, epoch: int, keep_last: Optional[int] = None,
             extra_meta: Optional[dict] = None) -> Optional[str]:
        """Snapshot now, write in the background; returns the EVENTUAL
        path, which exists only after :meth:`wait` or :meth:`close`. Write
        errors surface on the next save, wait or close."""
        flat = _flatten(state)
        if flat is None:
            return None
        return self._submit(ckpt_dir, f"ckpt_{epoch}.npz", flat,
                            _epoch_meta(state, epoch, extra_meta), keep_last)

    def save_best(self, ckpt_dir: str, state, epoch: int, metric: float,
                  extra_meta: Optional[dict] = None) -> Optional[str]:
        """The best-model twin of :meth:`save`, with the same contract."""
        flat = _flatten(state)
        if flat is None:
            return None
        meta = {"epoch": epoch, "metric": metric}
        meta.update(extra_meta or {})
        return self._submit(ckpt_dir, "ckpt_best.npz", flat, meta)


def all_checkpoints(ckpt_dir: str) -> List[Tuple[str, int]]:
    """Every epoch checkpoint in ``ckpt_dir``, newest first: the restore
    ladder's walk order. ``*.tmp`` (torn) and ``*.corrupt`` (quarantined)
    names never match."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.search(name)
        if m:
            found.append((os.path.join(ckpt_dir, name), int(m.group(1))))
    return sorted(found, key=lambda pe: pe[1], reverse=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[str, int]]:
    """``(path, epoch)`` of the newest complete checkpoint, or None."""
    ladder = all_checkpoints(ckpt_dir)
    return ladder[0] if ladder else None


def quarantine(path: str) -> str:
    """Rename a corrupt or unreadable checkpoint to ``*.corrupt`` (made
    unique): kept for forensics, never discovered again."""
    dst = path + ".corrupt"
    i = 1
    while os.path.exists(dst):
        dst = f"{path}.corrupt.{i}"
        i += 1
    os.replace(path, dst)
    counters.inc("ckpt.quarantines")
    return dst


def _read_meta(z) -> dict:
    if _META not in z.files:
        return {}
    return json.loads(bytes(z[_META].tobytes()).decode())


def _read_checked(path: str, z, verify: bool) -> Dict[str, np.ndarray]:
    """Every entry of an open archive but the meta; with ``verify``, each
    checked against its CRC32 stamp as it is read."""
    crcs = _read_meta(z).get("crc32") if verify else None
    if crcs is not None:
        missing = set(crcs) - set(z.files)
        if missing:
            raise CheckpointCorruptError(
                f"{path}: stamped entries missing from archive: {sorted(missing)[:4]}")
    flat = {}
    for k in z.files:
        if k == _META:
            continue
        arr = z[k]  # a full decompression: the zip-level CRC is checked here
        if crcs is not None:
            want = crcs.get(k)
            if want is None:
                raise CheckpointCorruptError(f"{path}: entry {k!r} has no CRC stamp")
            if _entry_crc(arr) != int(want) & 0xFFFFFFFF:
                raise CheckpointCorruptError(
                    f"{path}: CRC32 mismatch on entry {k!r} — silent corruption")
        flat[k] = arr
    return flat


def verify_npz(path: str) -> dict:
    """Integrity-check one plain checkpoint: readable end to end, and every
    entry equal to its CRC32 stamp (a checkpoint without stamps gets the
    structural check only). Returns the meta; raises
    :class:`CheckpointCorruptError`."""
    try:
        with np.load(path) as z:
            _read_checked(path, z, verify=True)
            return _read_meta(z)
    except CheckpointCorruptError:
        raise
    except Exception as e:  # BadZipFile, zlib.error, OSError, EOFError, JSON
        raise CheckpointCorruptError(
            f"unreadable checkpoint {path}: {type(e).__name__}: {e}") from e


def read_meta(path: str) -> dict:
    """The JSON meta of a checkpoint (epoch, step, any extra meta)."""
    with np.load(path) as z:
        return _read_meta(z)


def restore(path: str, verify: bool = False, template: Optional[dict] = None,
            remap=None) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays as host numpy, ``{keystr: array}``; copy them
    into a live state with :func:`tpu_dist_torch.bridge.load_train_state`.
    ``verify=True`` checks each entry against its CRC32 stamp as it is
    read: the coverage of :func:`verify_npz` in the one decompression pass
    the restore makes anyway.

    With ``template`` (``{keystr: leaf}`` in the JAX package's leaf order;
    only each leaf's shape and dtype are read) the result is shaped like
    it, as the JAX ``restore(path, template, remap=)`` shapes its
    ``TrainState``: an entry the template lacks is dropped, a missing
    ``['ef']`` leaf is zeros, each array is cast to its leaf's dtype, and
    a shape mismatch goes through ``remap`` (the elastic hook,
    :class:`~tpu_dist_torch.elastic.remap.Remapper`) or raises."""
    with spans.span("ckpt/restore", file=os.path.basename(path)), np.load(path) as z:
        flat = _read_checked(path, z, verify)
    if template is None:
        return flat
    out = {}
    for key, leaf in template.items():
        if key not in flat:
            if key.startswith("['ef']"):  # zero residuals are the cold start
                out[key] = np.zeros(np.shape(leaf), leaf.dtype)
                continue
            raise KeyError(f"checkpoint missing array for {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            arr = _resolve_shape_mismatch(remap, key, arr, leaf, template)
        out[key] = arr.astype(leaf.dtype)
    return out


def _resolve_shape_mismatch(remap, key: str, arr: np.ndarray, leaf, template: dict):
    """A checkpoint entry's shape disagrees with the template: the elastic
    ``remap`` hook rebuilds it, or the typed error says why not
    (:class:`ElasticShapeMismatch` for a leaf of an elastic family,
    :class:`ConfigMismatchError` for anything else)."""
    want, got = tuple(np.shape(leaf)), tuple(arr.shape)
    if remap is not None:
        out = remap(key, arr, leaf)
        if out is not None:
            if tuple(np.shape(out)) != want:
                raise ConfigMismatchError(
                    f"elastic remap of {key} produced shape {tuple(np.shape(out))}, "
                    f"template wants {want} — remapper/template disagreement")
            return out
    L = sum(int(np.prod(np.shape(v))) for k, v in template.items() if k.startswith("['params']"))
    if L and classify(key, got, want, L) is not None:
        raise ElasticShapeMismatch(key, got, want)
    raise ConfigMismatchError(f"shape mismatch for {key}: ckpt {got} vs state {want}")
