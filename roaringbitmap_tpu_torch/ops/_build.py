"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface. At first use they are compiled by
``nvcc`` for ``sm_90a`` into a shared library under the package's
``_build/`` directory (git-ignored), named by a hash of the sources and the
flags so an edited source rebuilds, and loaded with ``ctypes``. Nothing is
fetched and nothing is built when the module is imported.

A missing ``nvcc`` or a failed compile raises
:class:`~..robust.errors.TierUnavailable` with the compiler's output: the
kernels are the device path, so there is nothing to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from ..robust.errors import TierUnavailable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = [PACKAGE_DIR / "csrc" / "reduce.cu"]
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None  # guarded-by: _LOCK


def nvcc_path() -> str:
    """The ``nvcc`` of the CUDA toolkit PyTorch found, else the one on
    PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise TierUnavailable(
            "nvcc not found (no CUDA toolkit): the CUDA kernels cannot be built"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librb_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the sources unless the library for them exists already;
    ``verbose`` always compiles and adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel). Returns the library path and the
    compiler's output."""
    out = library_path()
    if out.is_file() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd: List[str] = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise TierUnavailable(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, log


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.rb_group_reduce.argtypes = [i, i, vp, ll, vp, ll, vp, vp, vp]
            lib.rb_group_reduce.restype = i
            lib.rb_popcount_rows.argtypes = [i, vp, ll, vp, vp]
            lib.rb_popcount_rows.restype = i
            lib.rb_error_string.argtypes = [i]
            lib.rb_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA status returned by a kernel entry point."""
    if rc != 0:
        msg = lib.rb_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
