"""``--sp 2 --sp_mode ring`` through the port's ``Trainer.fit`` on 4 gloo
ranks (``tests/torch_ranks.py::seq_fit_rank``) held against the JAX
package's ``Trainer`` given a ``[2, 2]`` data x seq mesh
(``tests/seq_parallel_jax.py::jax_fit``): ``vit_tiny`` from the JAX
trainer's initial weights, synthetic data, 2 epochs of 2 steps and an eval
after each; the per-epoch train loss and accuracy and the eval numbers.
Both trainers' augmentation is held to the numpy path without the random
crop and flip (``torch_ranks.unaugmented``): the JAX loader keys a batch's
crops by its one process's shard, the port's by the data index, so only
unaugmented inputs are the same batch on both sides (the examples of a
global batch are the same either way). Ulysses is
``test_torch_seq_parallel_fit.py``, the trainer's refusals of ``sp``
``test_torch_seq_parallel_refusals.py``.
"""

from seq_parallel_jax import FIT_RUN, assert_fit_matches, jax_fit
from torch_ranks import run_ranks, seq_fit_rank


def test_fit_matches_the_jax_trainer_on_a_2x2_mesh():
    params, jax_epochs = jax_fit("ring")
    fits = run_ranks(seq_fit_rank, 4, [dict(FIT_RUN, sp_mode="ring", device="cpu")], params,
                     timeout=120)
    assert_fit_matches(jax_epochs, [f[0] for f in fits])
