"""A supervised serving replica process: the port's counterpart of
``tpu_dist/serve/replica.py`` (``python -m tpu_dist_torch.serve
replica``).

The process :class:`~tpu_dist_torch.serve.supervisor.ReplicaSupervisor`
spawns: it loads weights through the CRC-verified restore ladder
(:func:`~tpu_dist_torch.serve.engine.load_serving_state`), warms the
bucket ladder, and serves a paced synthetic load with the forensic kit
armed (the per-rank heartbeat the engine's pump beats, the flight ring,
the OpenMetrics textfile, the history JSONL), so a SIGKILL leaves the
evidence ``obs postmortem`` bundles, and a SIGTERM runs the vacate:
shed, drain what was admitted, close the window, sweep the heartbeat,
exit 0.

Every incarnation appends lines to a status JSONL (``--status_file``):
``ready`` carries the CRC32 digest of the loaded weights
(:func:`weights_digest`, equal to the JAX package's digest of the same
checkpoint, so two incarnations' digests prove the relaunch restored the
same bits), the checkpoint served and the warmup's bucket count
(``warmup_compiles``); ``serving`` and ``drained`` carry the completions
and the post-warmup retraces (0: eager PyTorch compiles nothing per
shape). The payloads are one seeded pool, so incarnations serve the same
work.

:func:`serve` is the body, for any model and payload shape; :func:`main`
runs it with the drill's narrow ResNet and ``IMAGE_SHAPE``, as the JAX
entry point does, or with ``--model vit_b16`` (not in the JAX replica)
ViT-B/16 on 224x224 images, its attention through the flash forward
kernel. After a clean exit :func:`main` appends a ``launches`` line: the
flash forward's launches (and those on the tensor cores) and the
forwards served, which a chip run reads back.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib
from typing import Optional, Sequence

import numpy as np

#: The JAX replica's payload and batch defaults (the drill's model).
IMAGE_SHAPE = (16, 16, 3)
MAX_BATCH = 4


def weights_digest(params, bn_state) -> str:
    """CRC32 over every leaf in key order: each tree's JAX keystr paths
    (relative to ``params`` and to ``bn_state``, sorted) and the leaves'
    bytes in the JAX layout. Equal to ``tpu_dist.serve.replica.
    weights_digest`` on the same trees."""
    from tpu_dist_torch import bridge  # noqa: PLC0415

    crc = 0
    for tree in (params, bn_state):
        flat = bridge.keystr_flatten(tree)
        for key in sorted(flat):
            crc = zlib.crc32(key.encode(), crc)
            crc = zlib.crc32(np.ascontiguousarray(np.asarray(flat[key])).tobytes(), crc)
    return f"{crc:08x}"


def _status(path: Optional[str], **fields) -> None:
    if not path:
        return
    fields.setdefault("ts", round(time.time(), 3))
    fields.setdefault("pid", os.getpid())
    with open(path, "a") as f:
        f.write(json.dumps(fields) + "\n")


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.serve replica",
        description="one supervised serving replica (drill-sized model)",
    )
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint file or checkpoint directory (restore ladder)")
    ap.add_argument("--workdir", required=True,
                    help="heartbeat/ring/exposition/history live here")
    ap.add_argument("--status_file", default=None,
                    help="append ready/serving/drained JSONL lines here")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--max_batch", type=int, default=MAX_BATCH)
    ap.add_argument("--deadline_ms", type=float, default=500.0)
    ap.add_argument("--max_queue", type=int, default=64)
    ap.add_argument("--serve_n", type=int, default=0,
                    help="exit 0 after N completions (0 = until SIGTERM)")
    ap.add_argument("--pace_s", type=float, default=0.0,
                    help="sleep between submits (0 = as fast as possible)")
    ap.add_argument("--window_every", type=int, default=16,
                    help="record_window every N pumps")
    ap.add_argument("--wedge_after", type=int, default=0,
                    help="test hook: stop pumping (but stay alive) after N "
                         "completions, a wedged pump loop")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (default cuda)")
    ap.add_argument("--model", choices=("drill", "vit_b16"), default="drill",
                    help="the drill's narrow ResNet on 16x16 images (default), or ViT-B/16 "
                         "on 224x224 images with the flash attention kernel")
    return ap.parse_args(argv)


def serve(model, payload_shape: Sequence[int], args: argparse.Namespace) -> int:
    """The replica's body for ``model`` (an ``nn.Module`` whose shapes
    give the restore template; its weights are replaced by the
    checkpoint's) serving payloads of ``payload_shape``. Returns the exit
    code (0 after ``--serve_n`` completions or a SIGTERM's vacate)."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.metrics.history import MetricsHistory  # noqa: PLC0415
    from tpu_dist_torch.obs import counters as counters_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import export as export_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import flight as flight_lib  # noqa: PLC0415
    from tpu_dist_torch.obs import heartbeat as heartbeat_lib  # noqa: PLC0415
    from tpu_dist_torch.resilience import preemption  # noqa: PLC0415
    from tpu_dist_torch.serve import slo as slo_lib  # noqa: PLC0415
    from tpu_dist_torch.serve.engine import ServingEngine, load_serving_state  # noqa: PLC0415

    os.makedirs(args.workdir, exist_ok=True)
    status = args.status_file or os.path.join(args.workdir, "replica_status.jsonl")
    counters_lib.reset()
    token = preemption.install()  # SIGTERM -> the cooperative vacate flag
    ring = flight_lib.FlightRecorder(
        heartbeat_lib.per_rank_path(os.path.join(args.workdir, flight_lib.RING_NAME),
                                    args.rank),
        rank=args.rank, run_id="serve-replica",
    )
    ring.install_excepthooks()
    history = MetricsHistory(os.path.join(args.workdir, "replica.jsonl"),
                             run_id="serve-replica")
    exporter = export_lib.MetricsExporter(
        textfile=heartbeat_lib.per_rank_path(os.path.join(args.workdir, "metrics.prom"),
                                             args.rank),
        rank=args.rank,
    )
    loaded = load_serving_state(args.ckpt, model)
    digest = weights_digest(loaded["params"], loaded["bn_state"])
    bridge.load_jax_params(model, loaded["params"], loaded["bn_state"])
    engine = ServingEngine(
        model,
        max_batch=args.max_batch,
        deadline_s=args.deadline_ms / 1e3,
        slo_rules=slo_lib.load_slo_rules("default"),
        history=history,
        exporter=exporter,
        heartbeat_file=os.path.join(args.workdir, "hb.json"),
        rank=args.rank,
        max_queue=args.max_queue,
        device=args.device,
    )
    compiles = engine.warmup(tuple(payload_shape))
    retraces_baseline = counters_lib.get("compile.retraces")
    _status(status, event="ready", weights_digest=digest, ckpt=loaded["path"],
            warmup_compiles=compiles, remapped=bool(loaded["remapped"]))

    # one seeded payload pool used round-robin: incarnation k and k + 1
    # serve the same work
    rng = np.random.default_rng(1234)
    pool = rng.standard_normal((64,) + tuple(payload_shape)).astype(np.float32)
    served = 0
    pumps = 0
    try:
        while True:
            if preemption.requested():
                # the vacate: refuse new work, drain what was admitted,
                # close the books, sweep the beat, exit 0
                engine.set_shedding(True, "vacate (SIGTERM)")
                engine.drain()
                scalars = engine.record_window()
                _status(status, event="drained", served=served,
                        retraces=counters_lib.get("compile.retraces") - retraces_baseline,
                        shed=int(scalars.get("serve.shed", 0)))
                return 0
            if args.serve_n and served >= args.serve_n:
                _status(status, event="serving", served=served,
                        retraces=counters_lib.get("compile.retraces") - retraces_baseline)
                if args.wedge_after and served >= args.wedge_after:
                    # a wedge: alive, beating nothing, pumping nothing;
                    # the supervisor's staleness check is what this hook
                    # exercises
                    while not preemption.requested():
                        time.sleep(0.05)
                return 0
            engine.submit(pool[served % len(pool)], id=served)
            done = engine.pump()
            served += len(done)
            pumps += 1
            if args.window_every and pumps % args.window_every == 0:
                engine.record_window()
            if args.pace_s:
                time.sleep(args.pace_s)
    finally:
        engine.record_window()
        engine.sweep_heartbeat()
        history.close()
        exporter.close()
        ring.close()
        preemption.restore(token)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from tpu_dist_torch.obs import counters as counters_lib  # noqa: PLC0415
    from tpu_dist_torch.ops import flash_attention as fa  # noqa: PLC0415

    args = parse(argv)
    if args.model == "vit_b16":
        from tpu_dist_torch.nn.vit import vit_b16  # noqa: PLC0415

        model, shape = vit_b16(attn_impl="flash", device=args.device), (224, 224, 3)
    else:
        from tpu_dist_torch.serve.drill import _drill_model  # noqa: PLC0415

        model, shape = _drill_model(args.device), IMAGE_SHAPE
    rc = serve(model, shape, args)
    _status(args.status_file or os.path.join(args.workdir, "replica_status.jsonl"),
            event="launches", flash=fa.flash_fwd.launches, flash_mma=fa.flash_fwd.launches_mma,
            forwards=counters_lib.get("serve.forwards"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
