"""The fleet decision on the trainer's side (``tpu_dist_torch/train/
trainer.py``, which reads it through ``elastic/supervisor.py::
decision_from_env``) held against the JAX trainer's
(``tpu_dist/train/trainer.py:2709-2744``).

The launcher stamps ``TPU_DIST_FLEET_DECISION_ID`` and ``_CAUSE`` into a
relaunched child's environment when the allocation file carries them. A
run that resumes under them must name the decision in its ``resume``
history record (``decision_id``, ``decision_cause``), its
``fleet.decision_id`` gauge and its flight ring's ``resume`` entry; a
relaunch with no decision (a lost card) carries none, nor does an id
that is not an integer. Each case resumes the same one-epoch checkpoint
of each package under the same environment, and the decision fields of
the two trainers' records must be equal.
"""

import json
import os
import shutil

import pytest
from torch_ranks import free_port, narrow_resnet

from tests.helpers import TinyMLP
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.obs import counters as jax_counters
from tpu_dist.obs import flight as jax_flight
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.obs import counters, flight
from tpu_dist_torch.train import trainer

jax_trainer.register_model("tiny_mlp_trace",
                           lambda num_classes=10: TinyMLP(num_classes, width=16, in_dim=3072))
trainer.register_model("narrow_resnet", narrow_resnet)

RUN = dict(dataset="synthetic", num_classes=10, batch_size=64, epochs=1, steps_per_epoch=2,
           log_every=50, eval_every=0, save_every=1, synthetic_n=256, seed=0, num_workers=1)
ENVS = {
    "goodput": {"TPU_DIST_FLEET_DECISION_ID": "7", "TPU_DIST_FLEET_DECISION_CAUSE": "goodput"},
    "id_only": {"TPU_DIST_FLEET_DECISION_ID": "12"},
    "none": {},
    "not_an_int": {"TPU_DIST_FLEET_DECISION_ID": "x7", "TPU_DIST_FLEET_DECISION_CAUSE": "goodput"},
}
KEYS = ("decision_id", "decision_cause")


def _port_fit(**kw):
    t = trainer.Trainer(TrainConfig(model="narrow_resnet", device="cpu", port=free_port(),
                                    **{**RUN, **kw}))
    try:
        t.fit()
    finally:
        t.close()


def _jax_fit(**kw):
    jax_trainer.Trainer(JaxConfig(model="tiny_mlp_trace", **{**RUN, **kw})).fit()


PACKAGES = {"port": (_port_fit, counters, flight), "jax": (_jax_fit, jax_counters, jax_flight)}


@pytest.fixture(scope="module")
def first_epochs(tmp_path_factory):
    """One epoch of each package, checkpointed: what every case resumes."""
    out = {}
    for name, (fit, _, _) in PACKAGES.items():
        d = str(tmp_path_factory.mktemp(name) / "ck")
        fit(ckpt_dir=d)
        out[name] = d
    return out


def _resume(name, first, d, monkeypatch, env):
    fit, reg, fl = PACKAGES[name]
    ck = os.path.join(d, "ck")
    shutil.copytree(first[name], ck)
    for key in ("TPU_DIST_FLEET_DECISION_ID", "TPU_DIST_FLEET_DECISION_CAUSE"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setenv("TPU_DIST_ELASTIC_RESTARTS", "1")
    reg.reset()
    log, crash = os.path.join(d, "h.jsonl"), os.path.join(d, "crash")
    fit(ckpt_dir=ck, resume=True, epochs=2, log_file=log, crash_dir=crash)
    with open(log) as f:
        [rec] = [r for r in map(json.loads, f) if r.get("kind") == "resume"]
    ring = fl.decode(os.path.join(crash, fl.RING_NAME))
    [slot] = [r for r in ring["records"] if r.get("kind") == "resume"]
    return {"record": {k: rec.get(k, "absent") for k in KEYS + ("restarts", "epoch")},
            "ring": {k: slot.get(k, "absent") for k in KEYS},
            "gauge": reg.snapshot().get("fleet.decision_id", "absent")}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_the_resume_record_gauge_and_ring_name_the_decision_as_jax(
        tmp_path, monkeypatch, first_epochs, case):
    got = {name: _resume(name, first_epochs, str(tmp_path / name), monkeypatch, ENVS[case])
           for name in PACKAGES}
    assert got["port"] == got["jax"]
    want = {"goodput": (7, "goodput"), "id_only": (12, "absent")}.get(case, ("absent", "absent"))
    assert tuple(got["port"]["record"][k] for k in KEYS) == want
    assert tuple(got["port"]["ring"][k] for k in KEYS) == want
    assert got["port"]["gauge"] == want[0]
    assert got["port"]["record"]["restarts"] == 1
