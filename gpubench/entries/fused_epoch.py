"""The fused epoch: ``tpu_dist_torch.train.epoch.make_fused_epoch`` and its
runner's ``FusedEpoch.run(state, images_u8, labels, lr, order, offsets)``,
the path ``Trainer.fit --fused_epoch --fused_optimizer`` takes on one card
(a process group of one, SyncBN over it). The dataset lives on the device
as uint8; the benchmark draws each epoch's order and crop offsets itself,
so that the reference is handed the same batches and crops. The runner
runs its first steps eagerly, then captures one step in a CUDA graph and
replays it; a window call is one epoch of ``steps_per_call`` steps.

The compared steps: the first call runs one step (eager), the second the
next ``n - 1`` (three more eager, the capture, then replays), so that the
reference follows the eager steps and the first replays alike."""

from __future__ import annotations

import torch

from gpubench import check, traffic as gen
from gpubench.entries import join_group, leave_group, load_weights, optimizer


class System:
    def __init__(self, model, cfg: dict, traffic: dict, seed: int, device):
        from tpu_dist_torch.train.epoch import make_fused_epoch  # noqa: PLC0415
        from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

        self.device = torch.device(device)
        self._group = join_group(self.device)
        self.model = model.port_model(cfg, traffic, self.device)
        self.names = load_weights(self.model, gen.weights(model.weight_specs(cfg, traffic), seed,
                                                          self.device))
        self.optimizer = optimizer(cfg)
        self.lr = cfg["optimizer"]["lr"]
        self.state = TrainState.create(self.model, self.optimizer)
        data = cfg["data"]
        self.runner = make_fused_epoch(
            self.optimizer, batch_per_device=traffic["batch"], sync_bn=cfg["sync_bn"],
            compute_dtype=getattr(torch, cfg["compute_dtype"]), pad=data["pad"],
            mean=data["mean"], std=data["std"])
        self.images, self.labels = gen.dataset(cfg, seed, self.device)
        self.epochs = gen.epochs(cfg, traffic, seed, self.device)
        self.steps_per_call = traffic["steps_per_call"]
        self.images_per_call = self.steps_per_call * traffic["batch"]
        self.warmup_calls = traffic["warmup_calls"]

    def params(self) -> list:
        return list(self.model.parameters())

    def _run(self, order, offsets) -> torch.Tensor:
        self.state, _ = self.runner.run(self.state, self.images, self.labels, self.lr, order,
                                        offsets)
        return self.runner.step_metrics[:, 0]

    def call(self, i: int, steps=None) -> torch.Tensor:
        order, offsets = self.epochs[i % len(self.epochs)]
        return self._run(order[:steps], offsets[:steps])

    def first_steps(self, n: int) -> dict:
        """Steps 1 to ``n`` on rows 0 to n-1 of the first drawn epoch."""
        order, offsets = self.epochs[0]
        start = check.flat_copy(self.params())
        losses = [self._run(order[:1], offsets[:1])]
        grads = check.grad_norms(self.names, self.state.opt_state, start,
                                 self.optimizer.weight_decay)
        losses.append(self._run(order[1:n], offsets[1:n]))
        delta = check.delta_norms(self.names, self.params(), start)
        return {"losses": [float(v) for v in torch.cat(losses)], "grad_norms": grads,
                "delta_norms": delta}

    def warm_up(self) -> None:
        for i in range(self.warmup_calls):
            self.call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        self.state = self.runner = self.model = self.images = self.labels = None
        leave_group(self._group)


def reference_batches(cfg: dict, traffic: dict, seed: int, device, n: int) -> list:
    """The first ``n`` batches of the first drawn epoch, cropped and
    normalised by the reference from the dataset drawn again."""
    from gpubench.reference.train import augment  # noqa: PLC0415

    images, labels = gen.dataset(cfg, seed, device)
    order, offsets = gen.epochs(cfg, dict(traffic, epochs_drawn=1), seed, device)[0]
    data = cfg["data"]
    return [lambda i=i: (augment(images, order[i], offsets[i], data["pad"], data["mean"],
                                 data["std"]), labels[order[i]])
            for i in range(n)]
