"""``--sp 2 --sp_mode ulysses`` through the port's ``Trainer.fit`` on 4
gloo ranks held against the JAX package's ``Trainer`` on a ``[2, 2]`` data
x seq mesh, as ``test_torch_seq_parallel_trainer.py`` holds the ring
(``tests/seq_parallel_jax.py::jax_fit``, unaugmented inputs); and the
first dispatch's step cost, which does not depend on the sp mode nor, for
the ring, on the attention's implementation.
"""

import pytest
from seq_parallel_jax import FIT_RUN, assert_fit_matches, jax_fit
from torch_ranks import run_ranks, seq_fit_rank

MODES = (("ulysses", False), ("ring", False), ("ring", True))


@pytest.fixture(scope="module")
def runs():
    params, jax_epochs = jax_fit("ulysses")
    cfgs = [dict(FIT_RUN, sp_mode=m, flash_attention=f, device="cpu") for m, f in MODES]
    return jax_epochs, run_ranks(seq_fit_rank, 4, cfgs, params, timeout=120)


def test_fit_matches_the_jax_trainer_on_a_2x2_mesh(runs):
    jax_epochs, fits = runs
    assert_fit_matches(jax_epochs, [f[0] for f in fits])


def test_the_step_cost_does_not_depend_on_the_sp_mode_or_the_attention(runs):
    """The first dispatch's FLOPs: Ulysses' attention over the whole
    sequence for H/n heads, the ring's einsums over its n rotations, and
    the ring flash composition's booking (n rotations, masked ones
    included) are the same count."""
    _, fits = runs
    uly, ring, flash = (c["cost"]["flops_per_step"] for c in fits[0])
    assert uly == ring == flash > 0
