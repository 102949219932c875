"""Per-query wall-clock budgets.

The deadline half of ``roaringbitmap_tpu/robust/ladder.py``:
``query.execute(deadline_s=...)`` arms a budget for the enclosed work on
this thread, and once it has run out every remaining step is routed to its
CPU tier before it runs. The choice is made by the clock, never after a
failure: this package has no degradation ladder.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_TLS = threading.local()  # .deadline: monotonic deadline stack


class deadline_scope:
    """Arm a wall-clock budget of ``seconds`` (None: inherit the enclosing
    one) on this thread. Nested scopes keep the TIGHTER deadline (a
    sub-query cannot outlive its parent's budget)."""

    def __init__(self, seconds: Optional[float]):
        self._seconds = seconds

    def __enter__(self) -> "deadline_scope":
        stack = getattr(_TLS, "deadline", None)
        if stack is None:
            stack = _TLS.deadline = []
        if self._seconds is None:
            dl = stack[-1] if stack else None
        else:
            dl = time.monotonic() + float(self._seconds)
            if stack and stack[-1] is not None:
                dl = min(dl, stack[-1])
        stack.append(dl)
        return self

    def __exit__(self, *exc) -> None:
        _TLS.deadline.pop()


def deadline_remaining() -> Optional[float]:
    """Seconds left in the ambient budget; None when no scope is armed."""
    stack = getattr(_TLS, "deadline", None)
    if not stack or stack[-1] is None:
        return None
    return stack[-1] - time.monotonic()


def deadline_expired() -> bool:
    rem = deadline_remaining()
    return rem is not None and rem <= 0
