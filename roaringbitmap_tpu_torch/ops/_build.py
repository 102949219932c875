"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface. At first use each is compiled by its
own ``nvcc`` for ``sm_90a``, all of them started together, and the objects
are linked into one shared library under the package's ``_build/``
directory (git-ignored), named by a hash of the sources and the flags so an
edited source rebuilds, and loaded with ``ctypes``. Nothing is fetched and
nothing is built when the module is imported. Every build that runs the
compilers counts one into ``rb_tpu_compile_total{fn="rb_kernels"}``
(``observe/compilewatch.py``).

A missing ``nvcc`` or a failed compile raises
:class:`~..robust.errors.TierUnavailable` with the compiler's output: the
kernels are the device path, so there is nothing to fall back to. The
one exception is the tensor-core probe (``csrc/mma_probe.cu``), compiled
once for each form it measures: a form ``ptxas`` refuses is left out of
the library and recorded in :data:`PROBE_REFUSED`, since which forms the
card's assembler takes is what the probe is there to find out.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..observe import compilewatch as _compilewatch
from ..robust.errors import TierUnavailable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = [
    PACKAGE_DIR / "csrc" / name
    for name in ("reduce.cu", "oneil.cu", "query.cu", "columnar.cu", "expand.cu", "batch.cu")
]
HEADERS = [PACKAGE_DIR / "csrc" / "wgmma.cuh"]
PROBE_SOURCE = PACKAGE_DIR / "csrc" / "mma_probe.cu"
# the probe's forms (entry point rb_mma_probe_<form>), each its own compile
PROBE_FORMS = {"wgmma_s8": 0, "wgmma_b1": 1, "mma_b1": 2}
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None  # guarded-by: _LOCK
# seconds of the last compile in this process: each source's own nvcc (they
# run together), the link, and the whole build's wall time
BUILD_SECONDS: Dict[str, float] = {}
# probe forms the last compile in this process left out, with the
# compiler's error lines
PROBE_REFUSED: Dict[str, str] = {}


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
    for src in (*SOURCES, *HEADERS, PROBE_SOURCE):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librb_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> List[Tuple[int, str, float]]:
    """Run every command at once: ``(rc, output, seconds)`` for each."""

    def run(cmd):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return p.returncode, p.stdout, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        return list(pool.map(run, cmds))


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the sources unless the library for them exists already;
    ``verbose`` always compiles and adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel). Returns the library path and the
    compiler's output."""
    out = library_path()
    if out.is_file() and not verbose:
        return out, ""
    return _compile(out, verbose)


@_compilewatch.tracked("rb_kernels")
def _compile(out: Path, verbose: bool) -> Tuple[Path, str]:
    """Run the compilers and link: one count of ``rb_tpu_compile_total
    {fn="rb_kernels"}`` a call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    # (name, object, flags and source, probe form or None) of each compile
    jobs = [(src.name, BUILD_DIR / f"{tag}.{src.stem}.o", [str(src)], None) for src in SOURCES] + [
        (f"{PROBE_SOURCE.name}[{form}]", BUILD_DIR / f"{tag}.probe_{form}.o",
         [f"-DRB_PROBE_FORM={code}", str(PROBE_SOURCE)], form)
        for form, code in PROBE_FORMS.items()
    ]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    t0 = time.perf_counter()
    times = {}
    refused = {}
    try:
        cmds = [[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), *args] for _, obj, args, _ in jobs]
        logs = []
        linked = []
        for (name, obj, _, form), cmd, (rc, log, sec) in zip(jobs, cmds, _run_all(cmds)):
            logs.append(log)
            times[name] = sec
            if rc == 0:
                linked.append(obj)
            elif form is not None:
                refused[form] = "\n".join(ln for ln in log.splitlines() if "error" in ln.lower()) or log
            else:
                raise TierUnavailable(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, linked)]
        ((rc, log, times["link"]),) = _run_all([cmd])
        logs.append(log)
        if rc != 0:
            raise TierUnavailable(f"nvcc link failed ({rc}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for _, obj, _, _ in jobs:
            obj.unlink(missing_ok=True)
    times["wall"] = time.perf_counter() - t0
    BUILD_SECONDS.clear()
    BUILD_SECONDS.update(times)
    PROBE_REFUSED.clear()
    PROBE_REFUSED.update(refused)
    return out, "".join(logs)


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.rb_group_reduce.argtypes = [i, i, vp, ll, i, vp, ll, vp, vp, vp]
            lib.rb_group_reduce.restype = i
            lib.rb_popcount_rows.argtypes = [i, vp, ll, i, vp, ll, i, vp, vp]
            lib.rb_popcount_rows.restype = i
            lib.rb_oneil_compare.argtypes = [i, i, vp, i, ll, i, vp, i, vp, vp, vp, vp, vp]
            lib.rb_oneil_compare.restype = i
            lib.rb_oneil_counts.argtypes = [i, i, vp, i, ll, i, vp, i, vp, vp, vp, i, ll, vp]
            lib.rb_oneil_counts.restype = i
            lib.rb_threshold.argtypes = [i, vp, ll, ll, i, ctypes.c_uint, vp, vp, vp]
            lib.rb_threshold.restype = i
            lib.rb_pair_rows.argtypes = [i, i, vp, ll, vp, vp, ll, vp, ll, vp, vp, vp]
            lib.rb_pair_rows.restype = i
            lib.rb_expand_rows.argtypes = [i, ll, vp, vp, vp, ll, vp, vp, ll, vp, vp, vp, vp, vp, vp]
            lib.rb_expand_rows.restype = i
            lib.rb_pairwise_and_card.argtypes = [i, vp, ll, vp, ll, ll, vp, vp]
            lib.rb_pairwise_and_card.restype = i
            lib.rb_pairwise_and_card_attrs.argtypes = [i, vp, vp]
            lib.rb_pairwise_and_card_attrs.restype = i
            for form in PROBE_FORMS:
                name = f"rb_mma_probe_{form}"
                if hasattr(lib, name):  # absent where ptxas refused the form
                    getattr(lib, name).argtypes = [i, i, ll, vp, vp]
                    getattr(lib, name).restype = i
                    getattr(lib, f"{name}_threads").restype = i
            lib.rb_error_string.argtypes = [i]
            lib.rb_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA status returned by a kernel entry point."""
    if rc != 0:
        msg = lib.rb_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
