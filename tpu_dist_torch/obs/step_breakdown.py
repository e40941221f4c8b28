"""Where the time of a ResNet-18 training step goes on one CUDA card.

Runs the port's data-parallel step for ``resnet18_cifar100`` (global batch
256, random weights and one fixed random batch, so no input pipeline) in
variants that each take one piece away, and prints for each: the step
time ended by ``synchronize`` (median), the host's time to enqueue the
step (the call returning, before any sync), the device's busy time in one
profiled step (``torch.profiler``, kernel rows only), the kernels and the
top-level ATen calls of that step, and the loss. When the enqueue time
equals the step time, the host sets the pace. Run from the root of a
checkout, with one card::

    python -m tpu_dist_torch.obs.step_breakdown

The variants: the smoke's main path (bf16, SyncBN over a 1-rank NCCL
group, fused SGD); plain SGD; per-rank BN; BatchNorm through
``F.batch_norm`` (cuDNN; not the JAX formula, a yardstick only); f32;
then without a process group (no NCCL at all), again with cuDNN's
BatchNorm, and with ``torch.backends.cudnn.benchmark``.
"""

from __future__ import annotations

import socket
import statistics
import time

import torch
import torch.nn.functional as F

from tpu_dist_torch.comm import mesh
from tpu_dist_torch.nn import layers, resnet
from tpu_dist_torch.train import optim, state, step


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cudnn_bn(weight, bias, mean, var, x, *, train, group=None, momentum=0.1, eps=1e-5):
    """``layers.bn_apply``'s signature over ``F.batch_norm`` (per-rank
    statistics, another variance formula): the yardstick variant."""
    rm, rv = mean.clone(), var.clone()
    y = F.batch_norm(x, rm, rv, weight, bias, train, momentum, eps)
    return y, rm, rv


def measure(label, sync_bn=True, dtype=torch.bfloat16, fused=True, n=15, bn=None):
    orig = layers.bn_apply
    if bn is not None:
        layers.bn_apply = bn
    try:
        model = resnet.resnet18(device="cuda")
        opt = optim.SGD(fused=fused)
        st = state.TrainState.create(model, opt)
        train_step = step.make_train_step(opt, sync_bn=sync_bn, compute_dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(256, 32, 32, 3, device="cuda", generator=gen)
        y = torch.randint(0, 100, (256,), device="cuda", generator=gen)
        lr = torch.full((), 0.1, device="cuda")
        for _ in range(3):
            st, m = train_step(st, x, y, lr)
        total, host = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = train_step(st, x, y, lr)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            st, m = train_step(st, x, y, lr)
            torch.cuda.synchronize()
        events = prof.events()
        ops = sum(1 for e in events if e.name.startswith("aten::") and e.cpu_parent is None)
        kernels = sum(1 for e in events if str(e.device_type).endswith("CUDA"))
        busy = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                   for e in prof.key_averages() if str(e.device_type).endswith("CUDA")) / 1e3
        print(f"{label:44s} step {statistics.median(total):7.2f} ms  host enqueue "
              f"{statistics.median(host):7.2f} ms  device busy (profiled) {busy:7.2f} ms  "
              f"kernels {kernels}  top-level aten ops {ops}  loss {m['loss'].item():.4f}",
              flush=True)
    finally:
        layers.bn_apply = orig


def main() -> None:
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    mesh.initialize_distributed("cuda", master_port=_free_port())
    measure("main path: bf16, SyncBN (NCCL), fused SGD")
    measure("bf16, SyncBN, plain SGD", fused=False)
    measure("bf16, per-rank BN (+ bn_state all-reduce)", sync_bn=False)
    measure("bf16, SyncBN, torch BN formula (cuDNN)", bn=cudnn_bn)
    measure("f32, SyncBN, fused SGD", dtype=torch.float32)
    torch.distributed.destroy_process_group()
    measure("bf16, no process group (no NCCL at all)")
    measure("bf16, no group, torch BN formula (cuDNN)", bn=cudnn_bn)
    torch.backends.cudnn.benchmark = True
    measure("bf16, no group, cudnn.benchmark on")


if __name__ == "__main__":
    main()
