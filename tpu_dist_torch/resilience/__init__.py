"""Resilience of the port: deterministic fault injection (``--fault_plan``,
:mod:`tpu_dist_torch.resilience.faults`), the cooperative SIGTERM contract
(exit 75) and the transient-I/O retry."""

from tpu_dist_torch.resilience.faults import (  # noqa: F401
    FaultPlan,
    FaultPlanError,
    active,
    clear,
    configure,
    install,
)
from tpu_dist_torch.resilience.preemption import (  # noqa: F401
    PREEMPTION_EXIT_CODE,
    PreemptedError,
)
from tpu_dist_torch.resilience.retry import retry_call  # noqa: F401
