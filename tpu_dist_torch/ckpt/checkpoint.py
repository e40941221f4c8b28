"""Checkpoint / resume in the JAX package's two formats: the port's copy of
``tpu_dist/ckpt/checkpoint.py``, the rank-0 plain format and the sharded
one (the second half of this module).

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
import dataclasses
import json
import os
import re
import time
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_dist_torch import bridge
from tpu_dist_torch.comm import collectives
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
        # tpu-dist: ignore[TD002] — every caller holds the rank-0 guard (callers flatten collectively before it)
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)  # atomic: a checkpoint is absent or complete

    with spans.span("ckpt/write", file=name):
        retry_lib.retry_call(attempt, retries=_IO_RETRIES, describe=f"write of {name}")
    counters.inc("ckpt.writes")
    try:
        counters.inc("ckpt.bytes_written", os.path.getsize(path))
    except OSError:  # tpu-dist: ignore[TD006] — telemetry only: a racing prune must not fail the publish
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
                # tpu-dist: ignore[TD006] — best-effort: a file already gone must not fail a save
                except OSError:
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
            except OSError:  # tpu-dist: ignore[TD006] — best-effort sweep
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


# -- the sharded format (tpu_dist/ckpt/checkpoint.py:605-1195) ---------------------
#
# Every rank writes only the pieces it holds, and rank 0 commits a
# manifest last, so no rank ever holds the whole state:
#
#   {stem}.shard{p}of{n}.npz   one per rank; keys "{leaf}|{starts}|{sizes}"
#                              (the piece's origin and extent in the global
#                              JAX-layout array), so a restore decides overlap
#                              from the zip directory alone; "__crc__" holds
#                              the JSON of each entry's CRC32.
#   {stem}.manifest.json       the commit marker: {"meta", "n_shards",
#                              "shapes"}; a checkpoint without it is
#                              incomplete and invisible.
#
# The pieces are the windows of bridge.shard_windows: JAX layout, JAX keystr
# paths, one writer a distinct piece (JAX's replica_id == 0). A restore reads
# only the pieces that overlap the windows this rank holds. The file names,
# the manifest and the piece keys are JAX's, so a checkpoint crosses both
# ways.

_MANIFEST_RE = re.compile(r"ckpt_(\d+)\.manifest\.json$")
_NUMERIC_CKPT_FILE_RE = re.compile(r"ckpt_(\d+)\.(?:shard|manifest)")
_CRC = "__crc__"


def _shard_key(key: str, origin, shape) -> str:
    """``{key}|{starts}|{sizes}``: JAX's piece name of the window at
    ``origin`` (a tuple of starts) of ``shape``."""
    starts = ",".join(str(int(s)) for s in origin)
    sizes = ",".join(str(int(d)) for d in shape)
    return f"{key}|{starts}|{sizes}"


def _parse_shard_key(skey: str):
    key, starts, sizes = skey.rsplit("|", 2)
    origin = tuple(int(s) for s in starts.split(",")) if starts else ()
    extent = tuple(int(s) for s in sizes.split(",")) if sizes else ()
    return key, origin, extent


class ShardSnapshot:
    """Phase 1 of the two-phase sharded save: this rank's pieces as host
    copies and what phase 2 (serialize, CRC, publish, commit) needs, so
    phase 2 can run on a worker thread with no reference to the live
    state."""

    __slots__ = ("stem", "epoch", "pid", "nproc", "shard_flat", "shapes", "meta")

    def __init__(self, stem, epoch, pid, nproc, shard_flat, shapes, meta):
        self.stem = stem
        self.epoch = epoch
        self.pid = pid
        self.nproc = nproc
        self.shard_flat = shard_flat
        self.shapes = shapes
        self.meta = meta

    @property
    def nbytes(self) -> int:
        return sum(int(v.nbytes) for v in self.shard_flat.values())


def snapshot_sharded(state, epoch: int, extra_meta: Optional[dict] = None,
                     stem: Optional[str] = None) -> ShardSnapshot:
    """Phase 1: the device-to-host copies of the pieces this rank writes
    (:func:`tpu_dist_torch.bridge.shard_pieces`), finished when this
    returns. No file is touched. A state with flat parts (ZeRO-1, int8_ef)
    gathers them to rank 0 here, so every rank must call this then."""
    stem = stem or f"ckpt_{epoch}"
    pieces, shapes = bridge.shard_pieces(state)
    shard_flat = {_shard_key(key, origin, arr.shape): arr for (key, origin), arr in pieces.items()}
    return ShardSnapshot(stem, epoch, collectives.rank(), collectives.world_size(), shard_flat,
                         {k: list(v) for k, v in shapes.items()},
                         _epoch_meta(state, epoch, extra_meta))


def _sharded_uncommit(ckpt_dir: str, stem: str) -> None:
    """Uncommit a checkpoint at ``stem`` before any rank replaces its
    shard file: rank 0 removes the manifest, then a barrier, so a crash
    mid-overwrite leaves an invisible checkpoint, never a committed mixed
    one. Collective: the main thread only."""
    os.makedirs(ckpt_dir, exist_ok=True)
    if collectives.rank() == 0:
        try:
            os.remove(os.path.join(ckpt_dir, f"{stem}.manifest.json"))
        except FileNotFoundError:
            pass
    if collectives.world_size() > 1:
        collectives.barrier()


def _write_shard_file(ckpt_dir: str, snap: ShardSnapshot) -> str:
    """Phase 2a: serialize, CRC32-stamp, retry and atomically publish this
    rank's shard file. Host-side only: safe on a worker thread."""
    shard_flat = dict(snap.shard_flat)
    shard_flat[_CRC] = np.frombuffer(
        json.dumps({k: _entry_crc(v) for k, v in shard_flat.items()}).encode(), dtype=np.uint8)
    name = f"{snap.stem}.shard{snap.pid}of{snap.nproc}.npz"
    tmp = os.path.join(ckpt_dir, name + ".tmp")

    def write_shard() -> None:
        faults.on_ckpt_write()  # the --fault_plan injection point (a no-op off)
        # tpu-dist: ignore[TD002] — sharded format: every rank writes its own shard file by design
        with open(tmp, "wb") as f:
            np.savez(f, **shard_flat)
        os.replace(tmp, os.path.join(ckpt_dir, name))

    with spans.span("ckpt/write_shard", file=name):
        retry_lib.retry_call(write_shard, retries=_IO_RETRIES, describe=f"write of {name}")
    counters.inc("ckpt.writes")
    try:
        counters.inc("ckpt.bytes_written", os.path.getsize(os.path.join(ckpt_dir, name)))
    except OSError:  # tpu-dist: ignore[TD006] — telemetry only (see _write_npz)
        pass
    return os.path.join(ckpt_dir, name)


def _await_shard_files(ckpt_dir: str, snap: ShardSnapshot, timeout_s: float) -> None:
    """The filesystem commit barrier of the background path: rank 0's
    writer thread commits the manifest only once every rank's shard file
    is published (they appear atomically, so existence means complete). A
    collective must never run on the worker thread."""
    names = [f"{snap.stem}.shard{p}of{snap.nproc}.npz" for p in range(snap.nproc)]
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [n for n in names if not os.path.exists(os.path.join(ckpt_dir, n))]
        if not missing:
            return
        if time.monotonic() >= deadline:
            raise RuntimeError(
                f"sharded-ckpt commit barrier: {len(missing)} of {snap.nproc} shard files still "
                f"missing after {timeout_s:.0f}s ({missing[:3]}) — refusing to commit manifest "
                f"{snap.stem} over an incomplete shard set")
        time.sleep(0.05)


def _commit_manifest(ckpt_dir: str, snap: ShardSnapshot, keep_last: Optional[int] = None) -> str:
    """Phase 2b (rank 0): write the manifest, the commit marker, then
    prune: old manifests first (uncommit), then their shard files and the
    shard files of epochs never committed; ``*.corrupt`` files are kept."""
    mpath = os.path.join(ckpt_dir, f"{snap.stem}.manifest.json")
    manifest = {"meta": snap.meta, "n_shards": snap.nproc, "shapes": snap.shapes}
    tmp = mpath + ".tmp"

    def write_manifest() -> None:
        faults.on_ckpt_write()
        # tpu-dist: ignore[TD002] — callers gate on the snapshot's rank 0; the manifest commit is rank 0's alone
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, mpath)

    with spans.span("ckpt/write_manifest", file=os.path.basename(mpath)):
        retry_lib.retry_call(write_manifest, retries=_IO_RETRIES,
                             describe=f"commit of {snap.stem}")
    counters.inc("ckpt.writes")
    faults.on_ckpt_published(mpath)
    if keep_last is not None and keep_last > 0:
        sweep_stale_tmp(ckpt_dir)  # after the commit barrier: no write in flight
        committed = sorted(int(m.group(1)) for m in
                           (_MANIFEST_RE.search(n) for n in os.listdir(ckpt_dir)) if m)
        kept = set(committed[-keep_last:]) | {snap.epoch}
        names = sorted(os.listdir(ckpt_dir),
                       key=lambda n: (0 if n.endswith(".manifest.json") else 1, n))
        for n in names:
            if n.endswith(".corrupt") or ".corrupt." in n:
                continue  # quarantined files stay for forensics
            m = _NUMERIC_CKPT_FILE_RE.match(n)
            if m and int(m.group(1)) not in kept:
                try:
                    os.remove(os.path.join(ckpt_dir, n))
                except OSError:  # tpu-dist: ignore[TD006] — best-effort prune
                    pass
    return mpath


def publish_sharded_snapshot(ckpt_dir: str, snap: ShardSnapshot, keep_last: Optional[int] = None,
                             commit_timeout_s: float = 600.0) -> Optional[str]:
    """Phase 2 of the background path: publish this rank's shard file,
    then on rank 0 wait for the full set (the filesystem barrier) and
    commit the manifest. Host-side only: what
    :class:`AsyncShardedCheckpointer` runs on its worker thread."""
    _write_shard_file(ckpt_dir, snap)
    if snap.pid != 0:
        return None
    if snap.nproc > 1:
        _await_shard_files(ckpt_dir, snap, commit_timeout_s)
    return _commit_manifest(ckpt_dir, snap, keep_last)


def save_sharded(ckpt_dir: str, state, epoch: int, keep_last: Optional[int] = None,
                 extra_meta: Optional[dict] = None, stem: Optional[str] = None) -> Optional[str]:
    """Every rank writes its own shard file; rank 0 commits the manifest
    last and returns its path (None elsewhere). ``stem`` overrides
    ``ckpt_{epoch}`` (``ckpt_best``, the anomaly snapshots); ``keep_last``
    prunes old epochs. The synchronous composition: uncommit, snapshot,
    write, barrier, commit."""
    stem = stem or f"ckpt_{epoch}"
    _sharded_uncommit(ckpt_dir, stem)
    snap = snapshot_sharded(state, epoch, extra_meta=extra_meta, stem=stem)
    _write_shard_file(ckpt_dir, snap)
    if snap.nproc > 1:  # the manifest commits a complete shard set
        collectives.barrier()
    if snap.pid != 0:
        return None
    return _commit_manifest(ckpt_dir, snap, keep_last)


class ShardedCheckpointer:
    """The module's ``save``/``save_best`` in the sharded format (the
    Trainer's ``--sharded_ckpt``)."""

    @staticmethod
    def save(ckpt_dir, state, epoch, keep_last=None, extra_meta=None):
        return save_sharded(ckpt_dir, state, epoch, keep_last=keep_last, extra_meta=extra_meta)

    @staticmethod
    def save_best(ckpt_dir, state, epoch, metric, extra_meta=None):
        em = dict(extra_meta or {})
        em["metric"] = metric
        return save_sharded(ckpt_dir, state, epoch, extra_meta=em, stem="ckpt_best")


class AsyncShardedCheckpointer(_AsyncWriter):
    """Snapshot-then-write sharded checkpoints (``--sharded_ckpt
    --async_ckpt``): the step loop blocks only for the uncommit barrier
    and :func:`snapshot_sharded`; serialization, CRC32, retries, the
    publish and the manifest commit run on the worker thread
    (:func:`publish_sharded_snapshot`), whose commit barrier polls the
    filesystem. No collective runs on the worker thread. The returned
    manifest path is valid after ``wait``/``close``; write errors surface
    on the next save, wait or close."""

    def __init__(self, commit_timeout_s: float = 600.0) -> None:
        super().__init__()
        self._commit_timeout_s = commit_timeout_s

    def _submit_sharded(self, ckpt_dir, state, epoch, keep_last, extra_meta,
                        stem) -> Optional[str]:
        if any(getattr(f, "_stem", None) == stem for f in self._pending):
            # a publish of this stem in flight (ckpt_best, a replayed epoch):
            # drain it, or the uncommit below races its manifest commit
            self.wait()
        _sharded_uncommit(ckpt_dir, stem)
        snap = snapshot_sharded(state, epoch, extra_meta=extra_meta, stem=stem)
        self._harvest(block=False)  # surface finished writes' errors only
        fut = self._pool.submit(publish_sharded_snapshot, ckpt_dir, snap, keep_last,
                                self._commit_timeout_s)
        fut._stem = stem  # for the same-stem drain guard above
        self._pending.append(fut)
        if snap.pid != 0:
            return None
        return os.path.join(ckpt_dir, f"{stem}.manifest.json")

    def save(self, ckpt_dir, state, epoch, keep_last=None, extra_meta=None) -> Optional[str]:
        return self._submit_sharded(ckpt_dir, state, epoch, keep_last, extra_meta,
                                    f"ckpt_{epoch}")

    def save_best(self, ckpt_dir, state, epoch, metric, extra_meta=None) -> Optional[str]:
        em = dict(extra_meta or {})
        em["metric"] = metric
        return self._submit_sharded(ckpt_dir, state, epoch, None, em, "ckpt_best")


def all_sharded_checkpoints(ckpt_dir: str) -> List[Tuple[str, int]]:
    """Every committed sharded checkpoint, newest first (manifest paths)."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _MANIFEST_RE.search(name)
        if m:
            found.append((os.path.join(ckpt_dir, name), int(m.group(1))))
    return sorted(found, key=lambda pe: pe[1], reverse=True)


def latest_sharded_checkpoint(ckpt_dir: str) -> Optional[Tuple[str, int]]:
    """``(manifest path, epoch)`` of the newest committed sharded
    checkpoint, or None."""
    ladder = all_sharded_checkpoints(ckpt_dir)
    return ladder[0] if ladder else None


def _shard_names(ckpt_dir: str, stem: str, n: int) -> list:
    return sorted(name for name in os.listdir(ckpt_dir)
                  if name.startswith(f"{stem}.shard") and name.endswith(f"of{n}.npz"))


def verify_sharded(manifest_path: str, deep: bool = True) -> dict:
    """Integrity-check a committed sharded checkpoint: a readable manifest,
    the full shard-file set, every archive readable, every stamped entry
    present and (``deep``) equal to its shard's ``__crc__`` stamp.
    ``deep=False`` stops at the zip directories (the multi-rank choice:
    every rank would otherwise decompress the whole checkpoint). Returns
    the manifest's meta; raises :class:`CheckpointCorruptError`."""
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        n = manifest["n_shards"]
        ckpt_dir = os.path.dirname(manifest_path)
        stem = os.path.basename(manifest_path)[: -len(".manifest.json")]
        names = _shard_names(ckpt_dir, stem, n)
        if len(names) != n:
            raise CheckpointCorruptError(
                f"{manifest_path}: expects {n} shard files, found {len(names)} — torn or "
                "partially-pruned checkpoint")
        for name in names:
            spath = os.path.join(ckpt_dir, name)
            with np.load(spath) as z:
                crcs = json.loads(bytes(z[_CRC].tobytes()).decode()) if _CRC in z.files else None
                if crcs is not None:
                    missing = set(crcs) - set(z.files) - {_CRC}
                    if missing:
                        raise CheckpointCorruptError(
                            f"{spath}: stamped entries missing from archive: "
                            f"{sorted(missing)[:4]}")
                if not deep:
                    continue  # the zip directory read above is the cheap check
                for k in z.files:
                    if k == _CRC:
                        continue
                    arr = z[k]
                    if crcs is not None:
                        want = crcs.get(k)
                        if want is None or _entry_crc(arr) != int(want) & 0xFFFFFFFF:
                            raise CheckpointCorruptError(f"{spath}: CRC32 mismatch on {k!r}")
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"unreadable sharded checkpoint {manifest_path}: {type(e).__name__}: {e}") from e
    return manifest["meta"]


def read_sharded_meta(manifest_path: str) -> dict:
    with open(manifest_path) as f:
        return json.load(f)["meta"]


def restore_sharded(manifest_path: str, state, remap=None):
    """Copy a sharded checkpoint into the live ``state`` in place and return
    it with the saved ``step``: the counterpart of JAX's
    ``restore_sharded(path, template)``, the template being the state
    itself (:func:`tpu_dist_torch.bridge.shard_windows`: the windows this
    rank holds).

    Overlap-only reads: each window decompresses only the pieces that
    intersect it, so the memory a rank needs follows its own part. A leaf
    the shards do not cover is :class:`CheckpointCorruptError`; a missing
    ``['ef']`` leaf is zeros (the cold start). A leaf whose global shape
    bakes in the data extent (ZeRO-1's flat state, the residuals) saved
    at another extent is assembled whole and laid onto this run's through
    ``remap`` (the elastic hook); without one, or for any other leaf, a
    shape mismatch raises (:class:`ElasticShapeMismatch`,
    :class:`ConfigMismatchError`). Everything is read and checked before
    anything is copied."""
    with open(manifest_path) as f:
        manifest = json.load(f)
    ckpt_dir = os.path.dirname(manifest_path)
    stem = os.path.basename(manifest_path)[: -len(".manifest.json")]
    n = manifest["n_shards"]
    shapes = manifest["shapes"]
    zips = [np.load(os.path.join(ckpt_dir, name)) for name in _shard_names(ckpt_dir, stem, n)]
    if len(zips) != n:
        for z in zips:
            z.close()
        raise FileNotFoundError(f"sharded checkpoint {stem} expects {n} shard files, found "
                                f"{len(zips)} — incomplete or mixed ckpt_dir")
    try:
        pieces: dict = {}
        for z in zips:
            for skey in z.files:
                if skey == _CRC:  # the shard's integrity stamp, not a piece
                    continue
                key, origin, extent = _parse_shard_key(skey)
                if key not in shapes:
                    # a shard/manifest mismatch is corruption, not a config one
                    raise CheckpointCorruptError(f"shard key {key} not in manifest {manifest_path}")
                pieces.setdefault(key, []).append((origin, extent, z, skey))

        def assemble(key, origin, extent, dtype):
            """The host buffer of the ``[origin, origin + extent)`` window."""
            buf, covered = None, 0
            for p_org, p_ext, z, skey in pieces[key]:
                lo = tuple(max(a, b) for a, b in zip(origin, p_org))
                hi = tuple(min(a + da, b + db) for a, da, b, db in
                           zip(origin, extent, p_org, p_ext))
                if any(a >= b for a, b in zip(lo, hi)):
                    continue
                if buf is None:
                    buf = np.zeros(extent, dtype)
                data = z[skey]  # decompress only the overlapping pieces
                src = tuple(slice(a - b, c - b) for a, c, b in zip(lo, hi, p_org))
                dst = tuple(slice(a - o, c - o) for a, c, o in zip(lo, hi, origin))
                buf[dst] = data[src]
                covered += int(np.prod([c - a for a, c in zip(lo, hi)]))
            if buf is None or covered < int(np.prod(extent)):
                raise CheckpointCorruptError(
                    f"sharded checkpoint does not cover {key}[{origin}:+{extent}] "
                    f"(covered {covered} elements)")
            return buf

        windows, want = bridge.shard_windows(state)
        template = None
        staged, step = [], 0
        for w in windows:
            if w.key not in pieces:
                if not w.key.startswith("['ef']"):
                    raise KeyError(f"checkpoint missing array for {w.key}")
                staged.append((w, np.zeros(w.extent, w.dtype)))
                continue
            gshape = tuple(shapes[w.key])
            if gshape != tuple(want[w.key]):
                # a data-extent-dependent leaf of another extent: the whole
                # checkpoint value, laid onto this run's by the hook
                if template is None:
                    template = bridge.restore_template(state)
                full = assemble(w.key, (0,) * len(gshape), gshape, w.dtype)
                buf = np.asarray(_resolve_shape_mismatch(remap, w.key, full, template[w.key],
                                                         template)).astype(w.dtype)
            else:
                buf = assemble(w.key, w.origin, w.extent, w.dtype)
            if w.key == "['step']":
                step = int(buf)
            staged.append((w, buf))
    finally:
        for z in zips:
            z.close()
    for w, buf in staged:
        w.write(buf)
    return dataclasses.replace(state, step=step)
