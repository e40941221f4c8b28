"""The port's ``--fault_plan`` (``tpu_dist_torch/resilience/faults.py`` and
its hooks in the checkpoint writer, the loader and the trainer) held
against the JAX package's ``tpu_dist/resilience/faults.py``.

* The grammar on the same strings: the parsed clauses, the malformed specs
  both refuse, one-shot firing, the environment fallback; ``truncate_file``
  and ``bitflip_file`` byte for byte; a bounded ``hang`` (a SIGTERM
  during it ends the port's, a deliberate difference); a rank-pinned
  clause never fires without a rank.
* The hooks: a ``ckpt_write`` EIO retried to a complete file (the JAX
  backoff schedule), retry exhaustion leaving no checkpoint, a
  ``ckpt_corrupt`` file quarantined by the restore ladder, ``nan_loss``
  through the NaN guard with and without ``auto_recover``, ``loader_stall``
  raising instead of hanging, the fused path refusing step-grain sites.
* ``sigterm@`` stops the port's trainer at the ``mid_epoch_step`` the JAX
  trainer stops at (a world of one, and of two gloo ranks, where the
  port's stop vote rides the step's all-reduce); the JAX composite chaos
  plan (``tests/test_resilience.py:560``) ends bit-identical to the port's
  own unfaulted run.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch
from torch_ranks import free_port, narrow_resnet, run_ranks

from tests.helpers import TinyMLP
from tpu_dist import ckpt as jax_ckpt
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.resilience import faults as jax_faults
from tpu_dist.resilience import preemption as jax_preemption
from tpu_dist.train import trainer as jax_trainer
from tpu_dist_torch import ckpt
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.data import synthetic
from tpu_dist_torch.data.loader import DataLoader, LoaderProducerDiedError
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.resilience import FaultPlan, FaultPlanError, faults, preemption, retry
from tpu_dist_torch.resilience.preemption import PreemptedError
from tpu_dist_torch.train import optim, state as state_lib, trainer

jax_trainer.register_model("tiny_mlp_faults",
                           lambda num_classes=10: TinyMLP(num_classes, width=16, in_dim=3072))
trainer.register_model("narrow_resnet", narrow_resnet)

# the JAX chaos tests' run (tests/test_resilience.py::_cfg): 2 epochs of 3 steps
RUN = dict(dataset="synthetic", num_classes=10, batch_size=64, epochs=2, steps_per_epoch=3,
           log_every=50, eval_every=0, save_every=1, synthetic_n=256, seed=0, num_workers=1)


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """No plan, no pending SIGTERM flag and no retries, before and after
    every test, in both packages."""
    for mod in (faults, jax_faults):
        mod.clear()
    preemption.clear()
    jax_preemption.clear()
    prev = ckpt.set_io_retries(0)
    yield
    for mod in (faults, jax_faults):
        mod.clear()
    preemption.clear()
    jax_preemption.clear()
    ckpt.set_io_retries(prev)


def _port_cfg(ckpt_dir, **kw):
    return TrainConfig(**{**RUN, "model": "narrow_resnet", "device": "cpu", "port": free_port(),
                          "ckpt_dir": ckpt_dir, **kw})


def _fit(cfg):
    """``Trainer(cfg).fit()``; returns the trainer (closed) and the error
    type ``fit`` raised, if any."""
    t = trainer.Trainer(cfg)
    try:
        t.fit()
        return t, None
    except (PreemptedError, trainer.TrainingDivergedError) as e:
        return t, type(e).__name__
    finally:
        t.close()


def _clauses(plan):
    return [(c.site, c.params) for c in plan.clauses]


# -- the grammar, on the same strings -------------------------------------------------

SPECS = [
    "ckpt_write@call=2:times=3;sigterm@epoch=1:step=5;"
    "ckpt_corrupt@epoch=0:mode=bitflip:seed=7;loader_stall@batch=4",
    "nan_loss@step=3; hang@step=2:epoch=1:rank=0:seconds=1.5 ;rank_kill@step=1:rank=3",
    "ckpt_corrupt@epoch=2:frac=0.25:times=2;ckpt_write@call=1:errno=28",
]


@pytest.mark.parametrize("spec", SPECS)
def test_a_spec_parses_to_the_jax_clauses(spec):
    ours = FaultPlan.parse(spec)
    assert _clauses(ours) == _clauses(jax_faults.FaultPlan.parse(spec))
    assert ours.spec == spec


@pytest.mark.parametrize("bad", [
    "nosuchsite@x=1", "sigterm@", "ckpt_write@call=abc", "ckpt_corrupt@epoch=0:mode=banana",
    "sigterm@step=1:frac=0.5", "sigterm", "  ;  ", "hang@epoch=1", "rank_kill@step=1",
])
def test_both_packages_refuse_a_malformed_spec(bad):
    with pytest.raises(jax_faults.FaultPlanError):
        jax_faults.FaultPlan.parse(bad)
    with pytest.raises(FaultPlanError):
        FaultPlan.parse(bad)


def test_clauses_fire_once_and_on_the_same_steps_as_jax():
    spec = "nan_loss@step=2;nan_loss@epoch=1:step=0:times=2"
    for mod in (faults, jax_faults):
        mod.install(spec)
    coords = [(e, s) for e in range(3) for s in range(4)] * 2
    ours = [sorted(faults.on_step(e, s)) for e, s in coords]
    assert ours == [sorted(jax_faults.on_step(e, s)) for e, s in coords]
    assert sum(map(bool, ours)) == 3  # step 2 once, epoch 1 step 0 twice


def test_the_environment_variable_is_the_jax_one(monkeypatch):
    assert faults.ENV_VAR == jax_faults.ENV_VAR
    monkeypatch.setenv(faults.ENV_VAR, "nan_loss@step=3")
    for mod in (faults, jax_faults):
        plan = mod.configure(None)
        assert plan is not None and plan.clauses[0].site == "nan_loss"
    assert faults.configure("sigterm@step=1").clauses[0].site == "sigterm"  # the flag wins
    monkeypatch.delenv(faults.ENV_VAR)
    for mod in (faults, jax_faults):
        assert mod.configure(None) is None and mod.active() is None


def test_the_step_grain_sites_are_the_jax_ones():
    assert faults.STEPWISE_SITES == jax_faults.STEPWISE_SITES
    assert faults.SITES == jax_faults.SITES


@pytest.mark.parametrize("frac", [0.0, 0.4, 0.5, 0.999])
def test_truncate_file_cuts_the_bytes_jax_cuts(tmp_path, frac):
    data = np.random.default_rng(1).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    for name, fn in (("ours", faults.truncate_file), ("jax", jax_faults.truncate_file)):
        (tmp_path / name).write_bytes(data)
        fn(str(tmp_path / name), frac=frac)
    assert (tmp_path / "ours").read_bytes() == (tmp_path / "jax").read_bytes()


@pytest.mark.parametrize("seed,size", [(0, 1000), (7, 1000), (3, 65), (11, 1)])
def test_bitflip_file_flips_the_bits_jax_flips(tmp_path, seed, size):
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    for name, fn in (("ours", faults.bitflip_file), ("jax", jax_faults.bitflip_file)):
        (tmp_path / name).write_bytes(data)
        fn(str(tmp_path / name), seed=seed)
    ours = (tmp_path / "ours").read_bytes()
    assert ours == (tmp_path / "jax").read_bytes()
    assert size == 1 or ours != data


def test_a_bounded_hang_returns_and_a_rank_pinned_clause_needs_a_rank():
    faults.install("hang@step=2:seconds=0.3;hang@step=1:rank=0")
    t0 = time.monotonic()
    assert faults.on_step(0, 2) == {faults.HANG}
    assert time.monotonic() - t0 >= 0.3
    assert faults.on_step(0, 1) == frozenset()  # no rank: the pinned clause never fires
    assert faults.on_step(0, 1, rank=1) == frozenset()
    t0 = time.monotonic()
    assert faults.on_step(0, 2, rank=0) == frozenset()  # the bounded clause is spent
    assert time.monotonic() - t0 < 0.2
    # a rank_kill clause of another rank (or of no rank) never fires here
    faults.install("rank_kill@step=1:rank=3")
    assert faults.on_step(0, 1) == frozenset() and faults.on_step(0, 1, rank=0) == frozenset()
    assert faults.active().clauses[0].fired == 0


@pytest.mark.parametrize("when", ["during", "before"])
def test_a_sigterm_during_a_bounded_hang_ends_it(when):
    """A deliberate difference from the JAX package: the port's bounded
    hang is a hold that a SIGTERM landing while it holds ends (the
    trainer's cooperative flag; the fleet drill holds its shrunken world
    so), where JAX's runs to its bound. A flag already set before the hold
    does not end it."""
    import signal
    import threading

    for mod, flag in ((faults, preemption), (jax_faults, jax_preemption)):
        token = flag.install()
        try:
            if when == "before":
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(0.05)
                timer = None
            else:
                timer = threading.Timer(0.1, os.kill, (os.getpid(), signal.SIGTERM))
                timer.start()
            mod.install("hang@step=1:seconds=0.8")
            t0 = time.monotonic()
            assert mod.on_step(0, 1) == {mod.HANG}
            took = time.monotonic() - t0
            if timer is not None:
                timer.join()
            assert flag.requested()
            if mod is faults and when == "during":
                assert took < 0.6, took  # the SIGTERM at 0.1 s ended it
            else:
                assert took >= 0.8, took
        finally:
            flag.restore(token)
            flag.clear()
            mod.clear()


# -- the hooks ------------------------------------------------------------------------


def _state(seed=0):
    model = narrow_resnet(10, "cpu", seed)
    return state_lib.TrainState.create(model, optim.SGD())


def test_transient_ckpt_write_failures_retry_to_a_complete_file(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(retry.time, "sleep", sleeps.append)
    ckpt.set_io_retries(2)
    faults.install("ckpt_write@call=1:times=2")  # the first two attempts fail
    st = _state()
    path = ckpt.save(str(tmp_path), st, epoch=0)
    ckpt.verify_npz(path)  # complete and CRC-clean after the retries
    assert sleeps == [0.05, 0.1]  # tests/test_resilience.py's schedule
    assert faults.active().clauses[0].fired == 2
    from tpu_dist_torch import bridge

    flat = ckpt.restore(path)
    want = bridge.train_state_to_flat(st)
    assert set(flat) == set(want)
    assert all(np.array_equal(flat[k], want[k]) for k in want)


def test_ckpt_write_retry_exhaustion_raises_and_leaves_no_checkpoint(tmp_path):
    ckpt.set_io_retries(1)
    faults.install("ckpt_write@call=1:times=5")
    with pytest.raises(OSError, match="fault-injected"):
        ckpt.save(str(tmp_path), _state(), epoch=0)
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_a_corrupted_newest_checkpoint_is_quarantined_by_the_ladder(tmp_path, mode):
    d = str(tmp_path)
    # ckpt_1 is written twice, at the end of epoch 1 and at the end of fit
    _, err = _fit(_port_cfg(d, fault_plan=f"ckpt_corrupt@epoch=1:mode={mode}:seed=3:times=2"))
    assert err is None and faults.active().clauses[0].fired == 2
    t = trainer.Trainer(_port_cfg(d, resume=True))
    t.close()
    assert t.start_epoch == 1  # fell back to ckpt_0
    assert os.path.exists(os.path.join(d, "ckpt_1.npz.corrupt"))
    assert ckpt.latest_checkpoint(d)[1] == 0


def test_nan_loss_raises_divergence_without_auto_recover(tmp_path):
    _, err = _fit(_port_cfg(str(tmp_path), fault_plan="nan_loss@epoch=0:step=1"))
    assert err == "TrainingDivergedError"
    t = trainer.Trainer(_port_cfg(str(tmp_path / "b"), fault_plan="nan_loss@step=0"))
    try:
        with pytest.raises(trainer.TrainingDivergedError, match="fault-injected"):
            t.fit()
    finally:
        t.close()  # its process group: a later test of this worker must not inherit it


def test_nan_loss_fires_auto_recover_and_the_run_completes(tmp_path):
    d = str(tmp_path)
    log = os.path.join(d, "hist.jsonl")
    t, err = _fit(_port_cfg(d, fault_plan="nan_loss@epoch=1:step=0", auto_recover=1,
                            log_file=log))
    assert err is None
    assert t._lr_scale == t.cfg.recover_lr_factor
    with open(log) as f:
        assert any('"auto_recover"' in line for line in f)
    assert ckpt.latest_checkpoint(d)[1] == 1


def test_a_stalled_loader_raises_instead_of_hanging():
    images, labels = synthetic.synthetic_cifar(128, 10, seed=1)
    faults.install("loader_stall@batch=1")
    dl = DataLoader(images, labels, 32, DistributedSampler(128, 1, 0), watchdog_timeout=0.2)
    seen = 0
    t0 = time.monotonic()
    with pytest.raises(LoaderProducerDiedError):
        for _ in dl:
            seen += 1
    assert seen == 1 and time.monotonic() - t0 < 10
    # disarmed, the next epoch completes
    assert sum(1 for _ in dl) == len(dl) == 4


def test_the_fused_path_refuses_step_grain_sites(tmp_path):
    cfg = _port_cfg(str(tmp_path), fused_epoch=True, steps_per_epoch=None,
                    fault_plan="sigterm@epoch=1:step=0")
    with pytest.raises(ValueError, match="fused_epoch"):
        trainer.Trainer(cfg)
    for site in sorted(faults.STEPWISE_SITES - {"sigterm"}):
        spec = {"loader_stall": "loader_stall@batch=0", "rank_kill": "rank_kill@step=0:rank=1"
                }.get(site, f"{site}@step=0")
        with pytest.raises(ValueError, match=site):
            trainer.install_fault_plan(cfg.replace(fault_plan=spec))
    t = trainer.Trainer(cfg.replace(fault_plan="ckpt_corrupt@epoch=7;ckpt_write@call=9"))
    t.close()
    assert faults.active() is not None


# -- sigterm@ stops where the JAX trainer stops ---------------------------------------


@pytest.fixture(scope="module")
def jax_stops(tmp_path_factory):
    """The JAX trainer's emergency snapshot position for each plan."""
    out = {}
    for step in (0, 1, 2):
        d = str(tmp_path_factory.mktemp(f"jax_sigterm_{step}"))
        plan = f"sigterm@epoch=1:step={step}"
        t = jax_trainer.Trainer(JaxConfig(**RUN, model="tiny_mlp_faults", ckpt_dir=d,
                                          fault_plan=plan))
        with pytest.raises(jax_preemption.PreemptedError):
            t.fit()
        path, epoch = jax_ckpt.latest_checkpoint(d)
        out[plan] = (epoch, jax_ckpt.read_meta(path).get("mid_epoch_step"))
        jax_faults.clear()
        jax_preemption.clear()
    return out


def _stop_position(d):
    path, epoch = ckpt.latest_checkpoint(d)
    return epoch, ckpt.read_meta(path).get("mid_epoch_step")


@pytest.mark.parametrize("step", [0, 1, 2])
def test_sigterm_stops_at_the_jax_trainers_step(tmp_path, jax_stops, step):
    plan = f"sigterm@epoch=1:step={step}"
    _, err = _fit(_port_cfg(str(tmp_path), fault_plan=plan))
    assert err == "PreemptedError"
    assert _stop_position(str(tmp_path)) == jax_stops[plan] == (1, step + 1)


def _sigterm_rank(rank, world, root, plan):
    from tpu_dist_torch.resilience import faults as f  # noqa: PLC0415
    from tpu_dist_torch.train import trainer as tr  # noqa: PLC0415

    from torch_ranks import fit_run  # noqa: PLC0415

    cfg = {**RUN, "model": "narrow_resnet", "device": "cpu", "ckpt_dir": root,
           "fault_plan": plan}
    out = fit_run(cfg)
    assert tr.faults is f
    return out["error"], len(out["losses"])


def test_two_ranks_stop_together_at_the_jax_trainers_step(tmp_path, jax_stops):
    plan = "sigterm@epoch=1:step=1"
    got = run_ranks(_sigterm_rank, 2, str(tmp_path), plan, timeout=120)
    assert got == [("PreemptedError", 5)] * 2  # 3 steps of epoch 0, 2 of epoch 1
    assert _stop_position(str(tmp_path)) == jax_stops[plan]


# -- the JAX composite chaos plan -------------------------------------------------------


def test_the_composite_chaos_plan_ends_bit_identical_to_the_unfaulted_run(tmp_path):
    from tpu_dist_torch import bridge

    golden, glast = _fit_state(_port_cfg(str(tmp_path / "golden")))
    d = str(tmp_path / "chaos")
    plan = ("ckpt_write@call=1:times=1;"        # EIO on the first write attempt
            "sigterm@epoch=1:step=0;"           # preempted mid-epoch 1
            "ckpt_corrupt@epoch=1:mode=truncate")  # and the emergency snapshot tears
    cfg = _port_cfg(d, fault_plan=plan, ckpt_io_retries=2)
    _, err = _fit(cfg)
    assert err == "PreemptedError"
    ckpt.verify_npz(os.path.join(d, "ckpt_0.npz"))  # the EIO was retried
    t2 = trainer.Trainer(cfg.replace(fault_plan=None, resume=True))
    try:
        assert os.path.exists(os.path.join(d, "ckpt_1.npz.corrupt"))
        assert t2.start_epoch == 1 and t2._resume_step == 0
        last = t2.fit()  # epoch 1 again, from the clean boundary
    finally:
        t2.close()
    assert last["loss"] == glast["loss"]
    state = bridge.train_state_to_flat(t2.state)
    assert set(state) == set(golden)
    assert all(np.array_equal(state[k], golden[k]) for k in golden)
    shutil.rmtree(d)


def _fit_state(cfg):
    from tpu_dist_torch import bridge

    t = trainer.Trainer(cfg)
    try:
        last = t.fit()
    finally:
        t.close()
    return bridge.train_state_to_flat(t.state), last
