"""Project exception taxonomy for the fault model.

The same four categories as the JAX package's fault model, so code written
against either package raises and catches the same kinds:

* :class:`TransientDeviceError` — a transfer/dispatch hiccup that may
  succeed on retry.
* :class:`ResourceExhausted` — device memory or a byte budget ran out;
  never retried at the same tier.
* :class:`TierUnavailable` — the tier cannot serve at all: no card, no
  CUDA toolchain to build the kernels, a library that failed to load.
* :class:`DeadlineExceeded` — a per-query deadline budget blew.

This package has no degradation ladder: a device call that fails raises
to the caller. These classes name what went wrong; nothing here routes
around it.
"""

from __future__ import annotations

# categories (the ``category`` attribute of each class)
TRANSIENT = "transient"
RESOURCE = "resource"
UNAVAILABLE = "unavailable"
DEADLINE = "deadline"
FATAL = "fatal"


class RobustError(Exception):
    """Base of the fault-model taxonomy."""

    category = FATAL


class TransientDeviceError(RobustError):
    """Retryable transfer/dispatch failure."""

    category = TRANSIENT


class ResourceExhausted(RobustError):
    """Device-memory / budget exhaustion: never retried."""

    category = RESOURCE


class TierUnavailable(RobustError):
    """The tier cannot serve (no card, toolchain missing, load failed)."""

    category = UNAVAILABLE


class DeadlineExceeded(RobustError):
    """A per-query deadline budget expired mid-flight."""

    category = DEADLINE
