"""Chip arbitration across the runs sharing one pod: the port's copy of
``tpu_dist/fleet/``.

* ``capacity.py``: the allocation files the scheduler owns and the
  launcher's capacity probe reads, the one channel between them.
* ``scheduler.py``: the goodput- and SLO-aware arbiter
  (``FleetScheduler``), which reads the runs one by one
  (``read_signals``) or off one pass of the pod telemetry hub
  (``signals_from_hub``), and the chip-second audit.
* ``drill.py`` (``python -m tpu_dist_torch.fleet.drill``): the proof,
  a preempted run shrunk and grown back by the real supervisor, and two
  supervised runs between which the scheduler moves cards.
* ``tenancy_drill.py`` (``python -m tpu_dist_torch.fleet.tenancy_drill``):
  the proof of train and serve co-scheduling, a recorded diurnal day
  through the SLO engine, the hub and the arbiter, against a real trainer,
  and a supervised serving replica killed and relaunched.
"""
