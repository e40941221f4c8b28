"""``--debug_replica_check`` in the port (``metrics/consistency.py``) against
the JAX package's ``check_replicated``: on 4 gloo ranks, equal replicas
pass; a perturbed one raises JAX's message (the leaf's JAX key, the two
ranks where JAX names devices, the max abs difference), whose JAX
counterpart comes from a 2-device array with one shard moved the same;
BN statistics are checked under their JAX keys; under ``--tp`` only the
ranks that hold the same shards are compared. Then the flag through
``Trainer.fit`` on 2 ranks, and the trainer's replica group.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_ranks import fit_rank, replica_check_rank, run_ranks

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.metrics.consistency import check_replicated as jax_check
from tpu_dist_torch import bridge
from tpu_dist_torch.nn import vit

DELTA = 1e-3


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(replica_check_rank, 4, DELTA, timeout=120)


def _jax_message() -> str:
    """JAX's message for ``vit_tiny``'s head weight with one element moved
    by DELTA on the second of 2 devices."""
    w = bridge.vit_params_to_jax(vit.vit_tiny(device="cpu", seed=0))["head"]["w"]
    w = np.asarray(w, np.float32)
    moved = w.copy()
    # head.weight[0, 0] is JAX's w[0, 0] (the transpose keeps the corner)
    moved[0, 0] += np.float32(DELTA)
    mesh = mesh_lib.device_mesh([2], ["data"], jax.devices()[:2])
    arr = jax.make_array_from_single_device_arrays(
        w.shape, NamedSharding(mesh, P()),
        [jax.device_put(jnp.asarray(a), d) for a, d in zip((w, moved), jax.devices()[:2])])
    with pytest.raises(AssertionError) as info:
        jax_check({"head": {"w": arr}}, "params")
    return str(info.value)


def test_equal_replicas_pass(ranks):
    assert all(r["equal"] is None and r["within_atol"] is None for r in ranks)


def test_a_perturbed_replica_names_the_leaf_and_ranks_as_jax_does(ranks):
    want = re.sub(r"device (\S+) vs (\S+) ", "rank 0 vs 1 ", _jax_message())
    assert want.startswith("replica divergence in params['head']['w']: rank 0 vs 1 (max abs")
    # every rank compares the same gathered copies: all raise the same
    for r in ranks:
        got = r["perturbed"]
        # the difference of f32 values near 0.02, held to 3 significant
        # digits in the message: the same on both sides
        assert got == want, (got, want)


def test_bn_statistics_are_checked_under_their_jax_keys(ranks):
    msg = ranks[0]["bn"]
    assert msg.startswith("replica divergence in bn_state['") and "['var']: rank 0 vs 3" in msg
    assert "(max abs diff 5.000e-01)" in msg


def test_under_tp_only_the_replicas_are_compared(ranks):
    """The ranks of a model index hold the same shard: equal over the
    replicas; over the world a model rank's shard differs from another's,
    which the check must never compare."""
    for r in ranks:
        assert r["tp_replicas"] is None
        assert r["tp_world"] is not None and "rank 0 vs 1" in r["tp_world"]
    # rank 3 (data 1, model 1) moved its first shard: its replica group is
    # ranks 1 and 3; ranks 0 and 2 hold the other shard, still equal
    assert ranks[1]["tp_perturbed"] == ranks[3]["tp_perturbed"]
    assert "rank 1 vs 3 (max abs diff 1.000e-03)" in ranks[3]["tp_perturbed"]
    assert ranks[0]["tp_perturbed"] is None and ranks[2]["tp_perturbed"] is None


def test_the_flag_runs_through_fit_on_2_ranks(tmp_path):
    """``Trainer.fit --debug_replica_check`` at each epoch's end, with
    TensorBoard on rank 0 only: no divergence, one event file."""
    cfg = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=64,
               batch_size=16, epochs=2, steps_per_epoch=2, lr=0.05, log_every=1,
               eval_every=1, seed=0, device="cpu", debug_replica_check=True,
               tensorboard_dir=str(tmp_path / "tb"))
    errors = run_ranks(fit_rank, 2, cfg, timeout=120)
    assert errors == [None, None]
    assert len(list((tmp_path / "tb").iterdir())) == 1
