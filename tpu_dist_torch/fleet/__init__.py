"""Chip arbitration across runs sharing one pod: the port's copy of
``tpu_dist/fleet/``. Only the chip-second audit (``scheduler.py``) is
ported, because the history summary reads a pod's ``tenancy`` records;
the scheduler, the capacity file and the tenancy drill are ROADMAP
Queue A 6 (fleet/*)."""
