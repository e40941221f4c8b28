"""The streaming training step: ``tpu_dist_torch.train.step.make_train_step``
over the configuration's model and optimizer in its compute dtype, the step
``Trainer.fit`` runs on one card (a process group of one) without the fused
epoch. The window dispatches steps back to back over a pool of distinct
batches on the device; the losses stay there until the window closes."""

from __future__ import annotations

import torch

from gpubench import check, traffic as gen
from gpubench.entries import join_group, leave_group, load_weights, optimizer


class System:
    steps_per_call = 1

    def __init__(self, model, cfg: dict, traffic: dict, seed: int, device):
        from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415
        from tpu_dist_torch.train.step import make_train_step  # noqa: PLC0415

        self.device = torch.device(device)
        self._group = join_group(self.device)
        self.model = model.port_model(cfg, traffic, self.device)
        self.names = load_weights(self.model, gen.weights(model.weight_specs(cfg, traffic), seed,
                                                          self.device))
        self.optimizer = optimizer(cfg)
        self.lr = cfg["optimizer"]["lr"]
        self.state = TrainState.create(self.model, self.optimizer)
        self.step = make_train_step(self.optimizer,
                                    compute_dtype=getattr(torch, cfg["compute_dtype"]))
        self.pool = gen.pool(cfg, traffic, seed, self.device)
        self.images_per_call = traffic["batch"]
        self.warmup_steps = traffic["warmup_steps"]

    def params(self) -> list:
        return list(self.model.parameters())

    def call(self, i: int, steps=None) -> torch.Tensor:
        del steps
        x, y = self.pool[i % len(self.pool)]
        self.state, metrics = self.step(self.state, x, y, self.lr)
        return metrics["loss"].reshape(1)

    def first_steps(self, n: int) -> dict:
        """Steps 1 to ``n`` on pool batches 0 to n-1 (``n`` at most the
        pool)."""
        if n > len(self.pool):
            raise ValueError(f"{n} compared steps need {n} distinct batches, the pool has "
                             f"{len(self.pool)}")
        start = check.flat_copy(self.params())
        losses = [self.call(0)]
        grads = check.grad_norms(self.names, self.state.opt_state, start,
                                 self.optimizer.weight_decay)
        losses += [self.call(i) for i in range(1, n)]
        delta = check.delta_norms(self.names, self.params(), start)
        return {"losses": [float(v) for v in torch.cat(losses)], "grad_norms": grads,
                "delta_norms": delta}

    def warm_up(self) -> None:
        for i in range(self.warmup_steps):
            self.call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        self.state = self.step = self.model = self.pool = None
        leave_group(self._group)


def reference_batches(cfg: dict, traffic: dict, seed: int, device, n: int) -> list:
    """The first ``n`` pool batches, drawn again."""
    batches = gen.pool(cfg, dict(traffic, pool=n), seed, device)
    return [lambda b=b: b for b in batches]
