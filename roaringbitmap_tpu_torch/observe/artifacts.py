"""The diagnostic-artifact sink.

Counterpart of ``roaringbitmap_tpu/observe/artifacts.py``. Every
dump-on-anomaly hook (the timeline's, the build watch's, the outcome
ledger's) writes through ONE directory:

* ``RB_TPU_ARTIFACT_DIR`` (default ``./rb_tpu_artifacts/``, git-ignored)
  names the sink; ``configure(dir=...)`` overrides at runtime.
* :func:`resolve` is the write-side hook the dump sinks call: a bare
  filename lands inside the artifact dir; an explicit path (anything
  with a directory component, e.g. a test's ``tmp_path``) is honoured
  verbatim.
* The directory is created lazily at first write — a healthy process
  never creates it at all.

Pure stdlib.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

DEFAULT_DIR = "rb_tpu_artifacts"

_LOCK = threading.Lock()
_DIR = os.environ.get("RB_TPU_ARTIFACT_DIR") or DEFAULT_DIR  # guarded-by: _LOCK


def configure(dir: Optional[str] = None) -> None:
    """Runtime override of the artifact directory (tests point it at a
    tmp path; None keeps the current value)."""
    global _DIR
    if dir is not None:
        with _LOCK:
            _DIR = dir


def artifact_dir() -> str:
    """The sink directory as an absolute path (NOT created — creation is
    the writer's job, via :func:`resolve` / the bundle writer)."""
    with _LOCK:
        d = _DIR
    return os.path.abspath(d)


def resolve(name: str, mkdir: bool = True) -> str:
    """Where a diagnostic artifact named ``name`` should be written: a
    bare filename joins the artifact dir (created on demand when
    ``mkdir``); a path with any directory component is returned as-is —
    explicit routing always wins over the unified default."""
    if os.path.dirname(name):
        return name
    base = artifact_dir()
    if mkdir:
        os.makedirs(base, exist_ok=True)
    return os.path.join(base, name)
