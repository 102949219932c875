"""Fault model: the error taxonomy (``errors``), fault injection
(``faults``) and the tier ladder with retries, breakers and deadline
budgets (``ladder``).

Counterpart of ``roaringbitmap_tpu/robust/``. Importing this package arms
the ``RB_TPU_FAULTS`` seeded schedule when the environment variable is
set, as the JAX package's does.
"""

from .errors import (
    DeadlineExceeded,
    ResourceExhausted,
    RobustError,
    TierUnavailable,
    TransientDeviceError,
    classify,
    simulated_oom,
)
from .faults import SITES, active, clear, fault_point, inject, install, suspended
from .ladder import (
    LADDER,
    TIERS,
    Ladder,
    deadline_expired,
    deadline_remaining,
    deadline_scope,
    retry,
)

__all__ = [
    "RobustError",
    "TransientDeviceError",
    "ResourceExhausted",
    "TierUnavailable",
    "DeadlineExceeded",
    "classify",
    "simulated_oom",
    "SITES",
    "active",
    "fault_point",
    "inject",
    "install",
    "suspended",
    "clear",
    "LADDER",
    "TIERS",
    "Ladder",
    "retry",
    "deadline_scope",
    "deadline_remaining",
    "deadline_expired",
]

# Arm the environment's seeded schedule once, at the first import of the
# fault framework.
from .faults import install_env_schedule as _install_env_schedule

_install_env_schedule()
