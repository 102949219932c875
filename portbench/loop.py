"""A closed loop of client threads in one process: each sends its next
request as soon as its last one returns. With several clients, several
calls are in flight, and one client's device work can overlap another's
host work."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

# the streams a run draws from: one per phase and client, all from --seed
WARMUP, WINDOW = 1, 2


@dataclass
class Request:
    client: int
    index: int
    request: Any
    keep: bool
    start: float = 0.0
    end: float = 0.0
    error: Optional[str] = None
    answer: Any = None


@dataclass
class Outcome:
    requests: List[Request] = field(default_factory=list)
    opened: float = 0.0
    closed: float = 0.0


def client_rng(seed: int, phase: int, client: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, phase, client]))


def run(clients: int, seed: int, phase: int, draw: Callable, call: Callable,
        keep_share: float, seconds: Optional[float] = None,
        per_client: Optional[int] = None, on_open: Callable = None) -> Outcome:
    """Run ``clients`` threads until ``seconds`` have passed since they
    all started (a request begun before the close is awaited) or each has
    sent ``per_client`` requests. A client keeps the answer of its first
    request and of each later one its stream picks with ``keep_share``."""
    out = Outcome()
    logs: List[List[Request]] = [[] for _ in range(clients)]
    ready = threading.Barrier(clients + 1)
    go = threading.Event()

    def client(c: int) -> None:
        rng = client_rng(seed, phase, c)
        log = logs[c]
        ready.wait()
        go.wait()
        i = 0
        while True:
            if per_client is not None and i >= per_client:
                return
            r = Request(c, i, draw(rng), i == 0 or rng.random() < keep_share)
            r.start = time.perf_counter()
            if seconds is not None and r.start >= out.closed:
                return
            try:
                answer = call(r.request)
            except Exception as exc:  # a failed request is recorded, not fatal
                r.error = f"{type(exc).__name__}: {exc}"
            else:
                if r.keep:
                    r.answer = answer
            r.end = time.perf_counter()
            log.append(r)
            i += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}", daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    ready.wait()
    if on_open is not None:
        on_open()
    out.opened = time.perf_counter()
    out.closed = out.opened + (seconds if seconds is not None else float("inf"))
    go.set()
    for t in threads:
        t.join()
    for log in logs:
        out.requests.extend(log)
    return out
