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

``classify(exc)`` maps any exception — these, PyTorch's CUDA errors,
transport errors — onto those categories, with one deliberate asymmetry:
programming errors (``TypeError``, ``ValueError``, ``KeyError``,
``AssertionError``...) classify **fatal**. The retry loop
(``robust/ladder.retry``) retries only ``"transient"``; the tier ladder
re-raises ``"fatal"`` unchanged and walks the rest down a CPU-to-CPU
chain. A device tier is always the last tier of its list, so a device
failure that outlives its retries raises, classified, to the caller: no
CPU tier computes the answer behind its back.
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


# Substrings of a RuntimeError's message that name an out-of-memory status
# (the CUDA caching allocator's "CUDA out of memory", the JAX runtime's
# RESOURCE_EXHAUSTED). Every other RuntimeError defaults to transient.
_RESOURCE_MARKERS = ("RESOURCE_EXHAUSTED", "OUT_OF_MEMORY", "out of memory")


def _cuda_oom_type() -> tuple:
    """``torch.cuda.OutOfMemoryError`` where this build of PyTorch has it
    (CPU builds do too)."""
    try:
        import torch

        return (torch.cuda.OutOfMemoryError,)
    except (ImportError, AttributeError):
        return ()


def classify(exc: BaseException) -> str:
    """Map an exception to a fault category: ``"transient"``,
    ``"resource"``, ``"unavailable"``, ``"deadline"``, or ``"fatal"``.

    ``torch.cuda.OutOfMemoryError``, ``MemoryError`` and a RuntimeError
    whose message names an out-of-memory status are ``"resource"``. Any
    other ``RuntimeError`` — a failed CUDA launch or copy surfaces as one
    — and the transport ``OSError`` subclasses are ``"transient"``, as the
    JAX package classifies its runtime errors: misclassifying a
    recoverable blip as fatal turns it into an outage, while
    misclassifying a real fault as transient costs one bounded retry
    before it raises. Bare ``OSError`` stays fatal: a missing file or a
    permission error is a misconfiguration to surface."""
    if isinstance(exc, RobustError):
        return exc.category
    if isinstance(exc, (MemoryError,) + _cuda_oom_type()):
        return RESOURCE
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if any(m in msg for m in _RESOURCE_MARKERS):
            return RESOURCE
        return TRANSIENT
    # transport errors only — NOT bare OSError: FileNotFoundError /
    # PermissionError and friends are misconfigurations that must surface
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return TRANSIENT
    return FATAL


def simulated_oom(site: str) -> Exception:
    """A device-OOM lookalike for fault injection: a
    ``torch.cuda.OutOfMemoryError`` carrying a ``RESOURCE_EXHAUSTED``
    message (constructible on a CPU build of PyTorch too), else
    :class:`ResourceExhausted`. Either way ``classify()`` returns
    ``"resource"`` — injection exercises the routing the real allocator
    failure takes."""
    msg = (
        f"RESOURCE_EXHAUSTED: simulated device OOM injected at fault site "
        f"{site!r} (rb_tpu fault injection)"
    )
    for t in _cuda_oom_type():
        try:
            return t(msg)
        except TypeError:  # non-constructible binding
            pass
    return ResourceExhausted(msg)
