"""Fault-model error taxonomy (see ``errors``)."""

from .errors import (
    DeadlineExceeded,
    ResourceExhausted,
    RobustError,
    TierUnavailable,
    TransientDeviceError,
)

__all__ = [
    "RobustError",
    "TransientDeviceError",
    "ResourceExhausted",
    "TierUnavailable",
    "DeadlineExceeded",
]
