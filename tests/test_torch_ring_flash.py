"""The ring flash composition (``ops/flash_attention.py::
ring_flash_attention``, kernels #1-#3 around a K/V ring) held against the
JAX package's ``ring_flash_attention`` in Pallas interpret mode, 4-way on
4 gloo ranks (``tests/torch_ranks.py::seq_attention_rank``) against a
4-device ``seq`` mesh (``tests/seq_parallel_jax.py``): forward and
gradients, causal and not, bf16 causal included. Then the one-process
lockstep ring of ``chip_smoke.py`` phase 15 (a): bit for bit the gloo
ring, the flash attention of the gathered sequence, and no launch on a
masked rotation.
"""

import functools

import numpy as np
import pytest
import torch
from seq_parallel_jax import (F32_TOL, N, assert_matches_jax, blocks, case_id, inputs,
                              unblock)
from torch_ranks import run_ranks, seq_attention_rank

from tpu_dist_torch.ops import flash_attention as fa

CASES = (("ring_flash", False, None), ("ring_flash", True, None),
         ("ring_flash", True, "bfloat16"))


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(seq_attention_rank, N, CASES, *inputs(), timeout=120)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_matches_the_jax_function_forward_and_gradients(ranks, i):
    assert_matches_jax(ranks, CASES, i)


def test_the_kv_blocks_go_round_and_their_gradients_come_home(ranks):
    """The forward sends the K/V blocks n - 1 times; the backward sends
    them with their dK/dV accumulators n - 1 times and the accumulators
    home an n-th time."""
    for r in ranks[0]:
        assert r["counts"] == {"comm.ppermute.ring_kv": N - 1,
                               "comm.ppermute.ring_kv_grad": N}


@pytest.mark.parametrize("i", [1, 2], ids=["f32-causal", "bf16-causal"])
def test_the_lockstep_ring_is_the_gloo_ring_bit_for_bit(ranks, i):
    """``ring_flash_lockstep``, the one-process loop of chip_smoke.py
    phase 15 (a), gives each rank exactly what the composition gave it on
    the gloo ring (the same rotation bodies, the blocks handed on in place
    of the P2P)."""
    _, causal, dtype = CASES[i]
    dt = getattr(torch, dtype) if dtype else torch.float32
    q, k, v, ct = inputs()
    got = fa.ring_flash_lockstep(blocks(q, dt), blocks(k, dt), blocks(v, dt),
                                 blocks(ct, dt), causal=causal)
    assert set(got) == {"out", "m", "l", "dq", "dk", "dv"}
    for p, r in enumerate(ranks):
        shape = r[i]["out"].shape
        assert np.array_equal(unblock(got["out"][p], shape), r[i]["out"])
        for key, g in zip(("dq", "dk", "dv"), r[i]["grads"]):
            assert np.array_equal(unblock(got[key][p], shape), g), (p, key)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_the_lockstep_ring_is_flash_attention_on_the_whole_sequence(causal):
    """On one process, the n ranks' blocks end to end are the flash
    attention of the gathered sequence: forward, and the gradients the
    global (m, l) and delta give."""
    q, k, v, ct = inputs()
    got = fa.ring_flash_lockstep(blocks(q), blocks(k), blocks(v), blocks(ct), causal=causal)
    whole = [torch.cat(blocks(a), dim=1) for a in (q, k, v, ct)]
    out, m, l = fa.flash_fwd(*whole[:3], causal)
    dq, dk, dv = fa.flash_bwd(*whole[:3], out, m, l, whole[3], causal)
    for key, want in (("out", out), ("m", m), ("l", l), ("dq", dq), ("dk", dk), ("dv", dv)):
        # f32, another summation order (per-block partials merged by their
        # (m, l)): a few ulps of the values' size
        torch.testing.assert_close(torch.cat(got[key], dim=1), want, **F32_TOL)


def test_a_masked_rotation_launches_nothing():
    """Causal over 4 ranks: rank p computes p + 1 of its 4 rotations (p
    full, one diagonal), 10 a pass in all; non-causal all 16."""
    q, k, v, ct = inputs()
    calls = {}

    def counted(name, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    ops = fa.RingOps(*(counted(n, f) for n, f in zip(("fwd", "dkdv", "dq"), fa.KERNEL_OPS)))
    for causal, want in ((True, 10), (False, 16)):
        calls.update(fwd=0, dkdv=0, dq=0)
        fa.ring_flash_lockstep(blocks(q), blocks(k), blocks(v), blocks(ct), causal, ops)
        assert calls == {"fwd": want, "dkdv": want, "dq": want}


def test_the_ring_cases():
    """Which rotations of a causal ring compute: the blocks before the
    rank's own in full, its own with the kernels' causal mask, the ones
    after it not at all; without causality every block in full."""
    assert [fa.ring_case(2, j, True) for j in range(4)] == ["full", "full", "diag", "masked"]
    assert {fa.ring_case(2, j, False) for j in range(4)} == {"full"}
