"""Chip arbitration across the runs sharing one pod: the port's copy of
``tpu_dist/fleet/``.

* ``capacity.py``: the allocation files the scheduler owns and the
  launcher's capacity probe reads, the one channel between them.
* ``scheduler.py``: the goodput- and SLO-aware arbiter
  (``FleetScheduler``) and the chip-second audit.
* ``drill.py`` (``python -m tpu_dist_torch.fleet.drill``): the proof,
  a preempted run shrunk and grown back by the real supervisor, and two
  supervised runs between which the scheduler moves cards.

Not ported yet: ``tenancy_drill.py`` and ``scheduler.py::signals_from_hub``.
Both read the pod telemetry hub's ``TelemetryHub`` and the live goodput
ledger, ROADMAP Queue A 6 (telemetry), and come with them.
"""
