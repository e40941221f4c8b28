"""The port's chip-second audit (``tpu_dist_torch/fleet/scheduler.py::
audit_chip_seconds``) held against the JAX package's on the same
``tenancy`` records: a conserved pod over several ticks, a tick whose
pools do not add up, records of other kinds mixed in, a tick length other
than 1 s, and no snapshot at all. The arithmetic is integer chip-ticks in
both, so the reports are compared exactly."""

import pytest

from tpu_dist.fleet.scheduler import audit_chip_seconds as jax_audit
from tpu_dist_torch.fleet.scheduler import audit_chip_seconds

_CONSERVED = [
    {"kind": "tenancy", "tick": t, "alloc": {"train": 4 - t, "serve": t}, "free": 0,
     "pending": 0, "total_chips": 4}
    for t in range(4)
]
_VIOLATION = _CONSERVED[:2] + [
    {"kind": "tenancy", "tick": 2, "alloc": {"train": 3}, "free": 2, "pending": 0,
     "total_chips": 4},
]
_MIXED = [{"kind": "fleet", "tick": 1, "action": "grant", "recipient": "serve", "chips": 1},
          {"kind": "tenancy", "tick": 1, "alloc": {"train": 2}, "free": 1, "pending": 1,
           "total_chips": 4},
          {"kind": "serve", "requests": 3}]

CASES = {"conserved": (_CONSERVED, 1.0), "violation": (_VIOLATION, 1.0),
         "mixed_kinds": (_MIXED, 1.0), "tick_2_5_s": (_CONSERVED, 2.5), "empty": ([], 1.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_audit_chip_seconds_equals_jax(case):
    records, tick_s = CASES[case]
    ours = audit_chip_seconds(records, tick_s=tick_s)
    assert ours == jax_audit(records, tick_s=tick_s)
    assert ours["conserved"] == (case != "violation")
