"""The training forensics drill (``python -m tpu_dist_torch.obs.drill``), the
counterpart of ``tests/test_flight.py:776``.

* One round on the CPU with ``vit_tiny`` (the JAX drill's model) at batch
  16: the real trainer wedged by ``hang@epoch=0:step=3`` under the real
  launcher is found, dumped, killed and bundled, and the drill exits 0
  with its timings. Its watchdog timeout stays well above the child's
  start-up on a loaded host.
* The ring's last step for a ``hang@`` plan is the one the JAX trainer's
  ring ends at for the same plan (which the JAX drill requires): both
  trainers run in-process with the hang site raising where it would
  sleep, and their rings are decoded.
* Without a GPU the drill's default device raises before it starts
  anything.
"""

import json
import os

import pytest
import torch
from torch_ranks import free_port, narrow_resnet

from tests.helpers import TinyMLP
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.obs import flight as jax_flight
from tpu_dist.resilience import faults as jax_faults
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.obs import drill, flight
from tpu_dist_torch.resilience import faults
from tpu_dist_torch.train import trainer

jax_trainer.register_model("tiny_mlp_drill",
                           lambda num_classes=10: TinyMLP(num_classes, width=16, in_dim=3072))
trainer.register_model("narrow_resnet", narrow_resnet)

RUN = dict(dataset="synthetic", num_classes=10, batch_size=64, epochs=2, steps_per_epoch=6,
           log_every=2, eval_every=0, synthetic_n=512, seed=0, num_workers=1)


def test_the_drill_passes_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the drill's trainer children
    work = str(tmp_path / "drill")
    rc = drill.main(["--device", "cpu", "--workdir", work, "--batch_size", "16",
                     "--watchdog_timeout", "15", "--watchdog_dump_grace", "5",
                     "--watchdog_grace", "1", "--round_timeout", "240"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS: wedge detected" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("postmortem-drill: timings "))
    timings = json.loads(line.removeprefix("postmortem-drill: timings "))
    # the watchdog polls every 0.25 s, and the beat is throttled to 1 s
    assert 15.0 <= timings["detect_s"] <= 15.0 + 1.0 + 2 * 0.25 + 1.0
    assert 0 < timings["dump_wait_s"] <= 5.0
    assert 0 < timings["sigterm_to_exit_s"] <= 1.0 + 1.0  # the grace, then polls
    with open(os.path.join(work, "postmortem.json")) as f:
        rank0 = json.load(f)["ranks"][0]
    assert rank0["flight"]["last_step"]["epoch"] == 0 and rank0["flight"]["last_step"]["step"] == 3
    assert "_hang" in rank0["stack"]["stuck_frame"]


class _Wedged(Exception):
    """Raised where the hang would sleep, to end the in-process run there."""


@pytest.mark.parametrize("plan", ["hang@epoch=0:step=3", "hang@epoch=1:step=0"])
def test_the_ring_ends_where_the_jax_trainers_does(tmp_path, monkeypatch, plan):
    def wedge(seconds=0):
        raise _Wedged(seconds)

    rings = {}
    for name, mod, make, fl in (
            ("jax", jax_faults,
             lambda c: jax_trainer.Trainer(JaxConfig(model="tiny_mlp_drill", **c)), jax_flight),
            ("port", faults,
             lambda c: trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu",
                                                   port=free_port(), **c)), flight)):
        monkeypatch.setattr(mod, "_hang", wedge)
        crash = str(tmp_path / name)
        t = make({**RUN, "crash_dir": crash, "fault_plan": plan})
        try:
            with pytest.raises(_Wedged):
                t.fit()
        finally:
            if name == "port":
                t.close()
            mod.clear()
        rings[name] = fl.last_step(fl.decode(os.path.join(crash, flight.RING_NAME)))
    epoch, step = (int(kv.split("=")[1]) for kv in plan.split("@")[1].split(":"))
    assert (rings["port"]["epoch"], rings["port"]["step"]) == (
        rings["jax"]["epoch"], rings["jax"]["step"]) == (epoch, step)


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal without a GPU")
def test_the_drill_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill.main(["--workdir", str(tmp_path / "d")])
    assert not (tmp_path / "d").exists()  # nothing started


def test_a_hang_step_past_the_epoch_is_a_parser_error(tmp_path):
    # the epoch holds --steps_per_epoch steps, 0 to 5: a hang at step 6 never fires
    with pytest.raises(SystemExit) as info:
        drill.main(["--device", "cpu", "--workdir", str(tmp_path / "d"), "--hang_step", "6"])
    assert info.value.code == 2
    assert not (tmp_path / "d").exists()  # nothing started
