"""The analysis layer: the port's counterpart of ``tpu_dist/analysis``
(``docs/analysis.md``).

* :mod:`~tpu_dist_torch.analysis.lint` (Layer 1, TD001-TD008): the AST
  lint of the package, with inline suppressions and
  :mod:`~tpu_dist_torch.analysis.baseline`.
* :mod:`~tpu_dist_torch.analysis.step_audit` (Layer 2): one step's two
  collective accountings, the calls it makes through
  ``comm/collectives.py`` (predicted) and the ``c10d`` ops that reach the
  dispatcher (executed), on one ring model; the step fingerprint; the audit
  cases and their budgets (TD101-TD104).
* :mod:`~tpu_dist_torch.analysis.noop_probes` (Layer 2): the no-op probes
  (TD105-TD115, TD120, TD122-TD124) and ``audit_all``.
* :mod:`~tpu_dist_torch.analysis.shardlint` (Layer 3): every config family
  run once over the process group; TD116 holds the executed inventory to
  the predicted one, TD117 flags an unpredicted collective; the
  ``shard_report.json`` the planner reads.
* :mod:`~tpu_dist_torch.analysis.planner` (Layer 4, TD118/TD119): the
  ``--auto_shard`` search over the families.
* :mod:`~tpu_dist_torch.analysis.overlap` (Layer 4b, TD121): the
  collective-schedule knob tuner, its ``tune_report.json`` read by
  ``--tune_report``.

CLI: ``python -m tpu_dist_torch.analysis [paths]`` (lint and audit) and
``shard|plan|tune-overlap``. Exit 0 clean, 1 violations, 2 error or a dead
detector.

Keep this ``__init__`` import-light: the rule registry is stdlib only.
"""

from tpu_dist_torch.analysis.rules import RULES, Rule, Violation  # noqa: F401


def shard_all(*args, **kwargs):
    from tpu_dist_torch.analysis.shardlint import shard_all as _impl  # noqa: PLC0415

    return _impl(*args, **kwargs)
