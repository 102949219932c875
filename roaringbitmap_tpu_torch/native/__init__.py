"""Native host tier: the compiled C++ L0 and batch kernels (``kernels.cpp``).

Counterpart of ``roaringbitmap_tpu/native/__init__.py``. The sources are the
port's own copies (``kernels.cpp``, and ``ext.cpp``, which includes it in
one translation unit). At first use ``g++`` builds two libraries into the
package's ``_build/`` directory (git-ignored), both compiles started
together, each named by a hash of the sources, the flags, the
interpreter's ``EXT_SUFFIX`` and version and numpy's version (an edited
source, or another interpreter or numpy, builds anew):

* ``librb_host_<hash>.so``, loaded with ``ctypes``: every ``rb_*`` entry
  point, the OpenMP batch kernels among them (~4-13 us a call, amortized by
  a batch);
* ``_rb_ext_<hash><EXT_SUFFIX>``, the CPython/numpy C-API extension imported
  as ``roaringbitmap_tpu_torch.native._rb_ext`` (~0.2-1 us a call): the
  per-container entry points and the containers' scalar probes.

Each compile goes to a private temporary file that ``os.replace`` moves
into place, so processes building at once never load half a file.

There is no fallback. A missing ``g++`` or a failed compile raises
:class:`~..robust.errors.TierUnavailable` with the compiler's output. The
numpy tier (``utils/bits.py``'s ``*_numpy`` functions and the banded
``columnar/kernels.py`` functions, the plain versions the native tier is
held against) runs only when a caller chooses it: ``set_tier("numpy")``
sets ``config.tier`` and rebinds every dispatched name.

The batch entry points take raw pointers and int64 CSR offsets (declared
without ``ndpointer``, whose validation costs ~10 us an argument): a wrong
dtype, a non-contiguous array or an offset past its buffer would corrupt
memory, so the wrappers below convert dtypes and check offsets and row ids
before every call. Inputs need not be aligned: a mapped bitmap's words and
values are views at any byte offset of their buffer, and the kernels read
every input through one-byte-aligned types. Outputs are allocated here,
and a caller's output or accumulator must be aligned. ctypes calls
release the interpreter lock; the extension's calls hold it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict

import numpy as np

from ..observe import compilewatch as _compilewatch
from ..robust import faults as _faults
from ..robust.errors import TierUnavailable

_DIR = Path(__file__).resolve().parent
KERNELS_SRC = _DIR / "kernels.cpp"
EXT_SRC = _DIR / "ext.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]
TIERS = ("native", "numpy")


class config:
    """``tier``: ``"native"`` (the default: the compiled kernels) or
    ``"numpy"`` (the plain versions). Change it with :func:`set_tier`,
    which rebinds the names already resolved."""

    tier: str = "native"


_LOCK = threading.Lock()
_lib = None  # guarded-by: _LOCK (the ctypes library)
_ext = None  # guarded-by: _LOCK (the extension module; published last)
# seconds of the last build in this process: each compile and the wall
BUILD_SECONDS: Dict[str, float] = {}
# the entry points of each binding, by wrapper name (filled at load)
CTYPES: Dict[str, Callable] = {}
EXT: Dict[str, Callable] = {}


def set_tier(tier: str) -> None:
    """Choose the host tier (``"native"`` or ``"numpy"``) and unbind every
    name resolved under the old one (``utils/bits``' dispatched names, the
    containers' scalar probes). Choosing ``"native"`` builds nothing here:
    the next dispatched call does."""
    if tier not in TIERS:
        raise ValueError(f"host tier must be one of {TIERS}, got {tier!r}")
    from ..models import container
    from ..utils import bits

    config.tier = tier
    bits._install_trampolines()
    container._unbind_scalar_probes()


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise TierUnavailable("g++ not found: the native host tier cannot be built")
    return found


def build_commands() -> Dict[str, tuple]:
    """``{binding: (command without its output, library path)}`` for the
    ``ctypes`` library and the ``ext`` module."""
    gxx = _gxx()
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    lib_cmd = [gxx, *CXX_FLAGS, "-fno-exceptions", "-fno-rtti", str(KERNELS_SRC)]
    ext_cmd = [
        gxx, *CXX_FLAGS,
        "-I" + sysconfig.get_paths()["include"], "-I" + np.get_include(),
        str(EXT_SRC),
    ]
    h = hashlib.sha256()
    for src in (KERNELS_SRC, EXT_SRC):
        h.update(src.read_bytes())
    h.update(" ".join(lib_cmd[1:] + ext_cmd[1:]).encode())
    h.update(f"{suffix} {sys.version} {np.__version__}".encode())
    tag = h.hexdigest()[:16]
    return {
        "ctypes": (lib_cmd, BUILD_DIR / f"librb_host_{tag}.so"),
        "ext": (ext_cmd, BUILD_DIR / f"_rb_ext_{tag}{suffix}"),
    }


def build(force: bool = False) -> Dict[str, Path]:
    """Compile both libraries unless they exist already (``force``: compile
    them anyway), both compiles started together; returns their paths.
    Raises TierUnavailable with the compiler's output on any failure."""
    cmds = build_commands()
    todo = {k: v for k, v in cmds.items() if force or not v[1].is_file()}
    if todo:
        _compile(todo)
    return {k: v[1] for k, v in cmds.items()}


@_compilewatch.tracked("rb_host")
def _compile(todo: Dict[str, tuple]) -> None:
    """Run ``g++`` for each library of ``todo``, all at once: one count of
    ``rb_tpu_compile_total{fn="rb_host"}`` a call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def run(item):
        name, (cmd, out) = item
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        full = [*cmd, "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(full, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True, timeout=600)
            if p.returncode != 0 or not tmp.is_file():
                raise TierUnavailable(
                    f"g++ failed ({p.returncode}) building the {name} binding: "
                    f"{' '.join(full)}\n{p.stdout}"
                )
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        except (OSError, subprocess.SubprocessError) as e:
            raise TierUnavailable(f"g++ could not run ({e}): {' '.join(full)}") from e
        finally:
            tmp.unlink(missing_ok=True)
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        times = dict(pool.map(run, todo.items()))
    times["wall"] = time.perf_counter() - t0
    BUILD_SECONDS.clear()
    BUILD_SECONDS.update(times)


def _import_ext(path: Path):
    import importlib.util

    spec = importlib.util.spec_from_file_location("roaringbitmap_tpu_torch.native._rb_ext", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # a stale ABI or a missing symbol shows now, not on a later call
    if int(mod.cardinality_of_words(np.ones(1, dtype=np.uint64))) != 1:
        raise TierUnavailable(f"{path.name}: smoke test failed")
    return mod


def load():
    """The loaded ``(ctypes library, extension module)``, built on the first
    call. Raises TierUnavailable when either cannot be built or loaded."""
    global _lib, _ext
    if _ext is not None:
        return _lib, _ext
    with _LOCK:
        if _ext is None:
            paths = build()
            try:
                lib = ctypes.CDLL(str(paths["ctypes"]))
                _declare(lib)
            except (OSError, AttributeError) as e:
                raise TierUnavailable(f"cannot load {paths['ctypes'].name}: {e}") from e
            try:
                ext = _import_ext(paths["ext"])
            except ImportError as e:
                raise TierUnavailable(f"cannot import {paths['ext'].name}: {e}") from e
            _lib = lib
            _bind_ext(ext)
            _ext = ext
    return _lib, _ext


def available() -> bool:
    """True when the native tier serves (built and loaded at the first
    call; a failed build raises TierUnavailable), False when
    ``config.tier`` is ``"numpy"``. The ``native.entry`` fault site fires
    here on the native tier; where the JAX package degrades to numpy, the
    fault raises to the caller, classified by ``robust.errors.classify``
    (there is no native-to-numpy degrade)."""
    if config.tier == "numpy":
        return False
    if config.tier != "native":
        raise ValueError(f"host tier must be one of {TIERS}, got {config.tier!r}")
    _faults.fault_point("native.entry")
    load()
    return True


def lib() -> ctypes.CDLL:
    return load()[0]


def omp_threads():
    """OpenMP's thread count for the batch kernels (None before the
    library is loaded). Read, never set: the library leaves it to
    ``OMP_NUM_THREADS`` and the runtime."""
    if _lib is None:
        return None
    fn = _lib.omp_get_max_threads  # libgomp, a dependency of the library
    fn.restype = ctypes.c_int
    return int(fn())


def backend_tier() -> dict:
    """The live host tier, read without building anything: ``tier`` (the
    chosen one), ``loaded`` (the native libraries built and loaded in this
    process), the ``bindings`` loaded, whether OpenMP was compiled in and
    its thread count."""
    loaded = _ext is not None
    return {
        "tier": config.tier,
        "loaded": loaded,
        "bindings": ["ext", "ctypes"] if loaded else [],
        "openmp": loaded and "-fopenmp" in CXX_FLAGS,
        "omp_threads": omp_threads(),
    }


def _declare(lib: ctypes.CDLL) -> None:
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32, i64, u16 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint16
    vp = ctypes.c_void_p

    def decl(name, restype, *argtypes):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)

    decl("rb_advance_until", i32, u16p, i32, i32, u16)
    decl("rb_intersect_card_u16", i32, u16p, i32, u16p, i32)
    for name in ("rb_intersect_u16", "rb_union_u16", "rb_difference_u16", "rb_xor_u16"):
        decl(name, i32, u16p, i32, u16p, i32, u16p)
    decl("rb_contains_many_u16", None, u16p, i32, u16p, i32, u8p)
    decl("rb_popcount_words", i64, u64p, i64)
    decl("rb_words_from_values", None, u16p, i32, u64p)
    decl("rb_values_from_words", i32, u64p, i32, u16p)
    decl("rb_num_runs_words", i32, u64p, i32)
    decl("rb_select_words", i32, u64p, i32, i32)
    decl("rb_cardinality_in_range", i64, u64p, i32, i32)
    decl("rb_wide_op_words", i64, u64p, i64, i64, i32, u64p)
    decl("rb_runs_from_values", i32, u16p, i32, u16p, u16p)
    decl("rb_num_runs_values", i32, u16p, i32)
    decl("rb_words_from_intervals", None, i64p, i64p, i32, u64p)
    # the batch entry points: raw pointers (the wrappers own the checks)
    decl("rb_pack_array_rows", None, vp, vp, i64, vp, vp)
    decl("rb_batch_pairwise_u16", None, vp, vp, vp, vp, i64, i32, vp, vp, vp)
    decl("rb_batch_intersect_card_u16", None, vp, vp, vp, vp, i64, vp)
    decl("rb_batch_run_pairwise", None, vp, vp, vp, vp, vp, vp, i64, i32, vp, vp, vp, vp, vp)
    decl("rb_popcount_rows", None, vp, i64, i64, vp)
    decl("rb_scatter_values_rows", None, vp, vp, i64, vp, vp, i32)
    decl("rb_fill_intervals_rows", None, vp, vp, i64, vp, vp, vp, i32)


# ---------------------------------------------------------------------------
# the extension's entry points (bound at load; the ctypes ones stay in CTYPES)
# ---------------------------------------------------------------------------

_EXT_PAIRS = ("intersect_sorted", "merge_sorted_unique", "difference_sorted",
              "xor_sorted", "intersect_cardinality", "contains_many")
_EXT_WORDS = ("cardinality_of_words", "values_from_words", "num_runs_in_words")


def _bind_ext(e) -> None:
    """Bind the module's per-container names to the extension. The
    extension checks dtype and contiguity and raises TypeError; only then
    is the input converted, so the common uint16/uint64 case stays
    copy-free."""
    g = globals()

    def pair(fn):
        def run(a, b):
            try:
                return fn(a, b)
            except TypeError:
                return fn(_c16(a), _c16(b))

        return run

    def words1(fn):
        def run(words):
            try:
                return fn(words)
            except TypeError:
                return fn(_w64(words))

        return run

    def advance_until(a, pos, min_val, _fn=e.advance_until):
        try:
            return _fn(a, int(pos), int(min_val))
        except TypeError:
            return _fn(_c16(a), int(pos), int(min_val))

    def words_from_values(values, n_words=1024, _fn=e.words_from_values):
        try:
            return _fn(values, int(n_words))
        except TypeError:
            return _fn(_c16(values), int(n_words))

    def select_in_words(words, j, _fn=e.select_in_words):
        try:
            return _fn(words, int(j))
        except TypeError:
            return _fn(_w64(words), int(j))

    def cardinality_in_range(words, start, end, _fn=e.cardinality_in_range):
        try:
            return _fn(words, int(start), int(end))
        except TypeError:
            return _fn(_w64(words), int(start), int(end))

    bound = {name: pair(getattr(e, name)) for name in _EXT_PAIRS}
    bound.update({name: words1(getattr(e, name)) for name in _EXT_WORDS})
    for fn in (advance_until, words_from_values, select_in_words, cardinality_in_range):
        bound[fn.__name__] = fn
    for name, fn in bound.items():
        fn.__name__ = name
        CTYPES[name] = g[name]
        EXT[name] = fn
        g[name] = fn
    # extension-only entry points
    for name in ("lower_bound", "validate_sorted_u16", "validate_runs_u16"):
        EXT[name] = g[name]


def lower_bound(a: np.ndarray, x: int) -> int:
    """First index with ``a[i] >= x`` (sorted uint16), through the
    extension's galloping ``advance_until`` (pos -1: it searches strictly
    after pos)."""
    try:
        return _ext.advance_until(a, -1, int(x))
    except TypeError:
        return _ext.advance_until(_c16(a), -1, int(x))


def validate_sorted_u16(values: np.ndarray) -> bool:
    """True iff strictly increasing (one C pass)."""
    try:
        return bool(_ext.is_strictly_increasing(values))
    except TypeError:
        return bool(_ext.is_strictly_increasing(_c16(values)))


def validate_runs_u16(pairs: np.ndarray) -> bool:
    """True iff interleaved (start, length) runs are sorted, disjoint,
    non-touching, and end inside the 2^16 universe."""
    try:
        return bool(_ext.runs_valid(pairs))
    except TypeError:
        return bool(_ext.runs_valid(_c16(pairs)))


# ---------------------------------------------------------------------------
# ctypes wrappers (same signatures as the utils/bits.py plain versions)
# ---------------------------------------------------------------------------


def _c16(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint16)


def _w64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = _c16(a), _c16(b)
    out = np.empty(min(a.size, b.size), dtype=np.uint16)
    n = lib().rb_intersect_u16(a, a.size, b, b.size, out)
    return out[:n].copy()  # copy: do not pin the oversized scratch buffer


def intersect_cardinality(a: np.ndarray, b: np.ndarray) -> int:
    a, b = _c16(a), _c16(b)
    return int(lib().rb_intersect_card_u16(a, a.size, b, b.size))


def merge_sorted_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = _c16(a), _c16(b)
    out = np.empty(a.size + b.size, dtype=np.uint16)
    n = lib().rb_union_u16(a, a.size, b, b.size, out)
    return out[:n].copy()


def difference_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = _c16(a), _c16(b)
    out = np.empty(a.size, dtype=np.uint16)
    n = lib().rb_difference_u16(a, a.size, b, b.size, out)
    return out[:n].copy()


def xor_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = _c16(a), _c16(b)
    out = np.empty(a.size + b.size, dtype=np.uint16)
    n = lib().rb_xor_u16(a, a.size, b, b.size, out)
    return out[:n].copy()


def contains_many(sorted_vals: np.ndarray, queries: np.ndarray) -> np.ndarray:
    s, q = _c16(sorted_vals), _c16(queries)
    out = np.empty(q.size, dtype=np.uint8)
    lib().rb_contains_many_u16(s, s.size, q, q.size, out)
    return out.astype(bool)


def advance_until(a: np.ndarray, pos: int, min_val: int) -> int:
    a = _c16(a)
    return int(lib().rb_advance_until(a, a.size, pos, min_val))


def cardinality_of_words(words: np.ndarray) -> int:
    w = _w64(words)
    return int(lib().rb_popcount_words(w, w.size))


def words_from_values(values: np.ndarray, n_words: int = 1024) -> np.ndarray:
    v = _c16(values)
    words = np.zeros(n_words, dtype=np.uint64)
    lib().rb_words_from_values(v, v.size, words)
    return words


def or_values_into_words(words: np.ndarray, values: np.ndarray) -> np.ndarray:
    """OR values into the caller's accumulator (``rb_words_from_values``
    ORs into its output). Like the plain version, a short or read-only
    accumulator raises rather than corrupting memory."""
    v = _c16(values)
    if words.size < 1024:
        raise IndexError(f"accumulator has {words.size} words, need 1024")
    if not words.flags.writeable:
        raise ValueError("accumulator is read-only")
    if words.dtype != np.uint64 or not words.flags.c_contiguous or not words.flags.aligned:
        w = np.require(words, np.uint64, ["C", "A"])
        lib().rb_words_from_values(v, v.size, w)
        words[:] = w
        return words
    lib().rb_words_from_values(v, v.size, words)
    return words


def values_from_words(words: np.ndarray) -> np.ndarray:
    w = _w64(words)
    out = np.empty(w.size * 64, dtype=np.uint16)
    n = lib().rb_values_from_words(w, w.size, out)
    # copy: a [:n] view would pin the full 64 * w.size buffer
    return out[:n].copy()


def num_runs_in_words(words: np.ndarray) -> int:
    w = _w64(words)
    return int(lib().rb_num_runs_words(w, w.size))


def select_in_words(words: np.ndarray, j: int) -> int:
    w = _w64(words)
    r = int(lib().rb_select_words(w, w.size, j))
    if r < 0:
        raise IndexError(f"select({j}) out of range")
    return r


def cardinality_in_range(words: np.ndarray, start: int, end: int) -> int:
    w = _w64(words)
    return int(lib().rb_cardinality_in_range(w, start, end))


def wide_op_words(rows: np.ndarray, op: str = "or"):
    """Fold an [n_rows, n_words] matrix; returns (out_words, cardinality)."""
    r = _w64(rows)
    n_rows, n_words = r.shape
    out = np.empty(n_words, dtype=np.uint64)
    opc = {"or": 0, "and": 1, "xor": 2}[op]
    card = lib().rb_wide_op_words(r.reshape(-1), n_rows, n_words, opc, out)
    return out, int(card)


def runs_from_values(values: np.ndarray):
    v = _c16(values)
    if v.size == 0:
        return np.empty(0, dtype=np.uint16), np.empty(0, dtype=np.uint16)
    starts = np.empty(v.size, dtype=np.uint16)
    lengths = np.empty(v.size, dtype=np.uint16)
    n = lib().rb_runs_from_values(v, v.size, starts, lengths)
    # copies: run containers outlive the oversized scratch buffers
    return starts[:n].copy(), lengths[:n].copy()


def num_runs_in_values(values: np.ndarray) -> int:
    v = _c16(values)
    return int(lib().rb_num_runs_values(v, v.size))


def words_from_intervals(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    s = _c64i(starts)
    e = _c64i(ends)
    if s.size != e.size:
        raise ValueError(f"{s.size} starts but {e.size} ends")
    words = np.zeros(1024, dtype=np.uint64)
    lib().rb_words_from_intervals(s, e, np.int32(s.size), words)
    return words


# ---------------------------------------------------------------------------
# batch entry points (raw pointers: the checks below stand between a wrong
# argument and memory corruption)
# ---------------------------------------------------------------------------

_BATCH_OPS = {"and": 0, "or": 1, "xor": 2, "andnot": 3}
_SCATTER_OPS = {"or": 0, "xor": 1, "clear": 2}


def _c64i(a) -> np.ndarray:
    # offsets, row ids and interval ends are read as plain int64_t: aligned
    a = np.ascontiguousarray(a, dtype=np.int64)
    return a if a.flags.aligned else a.copy()


def _p(a: np.ndarray) -> int:
    # raw data pointer; every caller has forced dtype and C-contiguity, and
    # the array stays referenced by the calling frame for the call
    return a.ctypes.data


def _check_offsets(offs: np.ndarray, size: int, what: str) -> None:
    """CSR offsets: non-decreasing, from 0, ending inside ``size``."""
    if offs.size == 0 or offs[0] < 0 or offs[-1] > size or (offs.size > 1 and (np.diff(offs) < 0).any()):
        raise ValueError(f"{what}: offsets must rise from >= 0 to at most {size}")


def _check_rows(rows: np.ndarray, out64: np.ndarray, what: str) -> None:
    if (out64.dtype != np.uint64 or not out64.flags.c_contiguous
            or not out64.flags.writeable or not out64.flags.aligned):
        raise ValueError(f"{what} needs a writable, aligned, C-contiguous uint64 target")
    if out64.size % 1024:
        raise ValueError(f"{what}: the target is not a whole number of 1024-word rows")
    if rows.size and (rows.min() < 0 or rows.max() >= out64.size // 1024):
        raise IndexError(f"{what}: a row id lies outside the target's {out64.size // 1024} rows")


def batch_pairwise_u16(avals, aoffs, bvals, boffs, op: str, out_offs, out_size: int):
    """One call = one whole batch of sorted-u16 container ops. Pair j reads
    ``avals[aoffs[j]:aoffs[j+1]]`` x ``bvals[boffs[j]:boffs[j+1]]`` and
    writes at ``out[out_offs[j]:]``; returns ``(out_scratch, counts)``.
    ``out_offs[j]`` plus pair j's worst case (the smaller side for and,
    the left for andnot, both for or/xor) must fit ``out_size``."""
    a, b = _c16(avals), _c16(bvals)
    ao, bo, oo = _c64i(aoffs), _c64i(boffs), _c64i(out_offs)
    n = ao.size - 1
    _check_offsets(ao, a.size, "batch_pairwise_u16 a")
    _check_offsets(bo, b.size, "batch_pairwise_u16 b")
    if bo.size != ao.size or oo.size < n:
        raise ValueError("batch_pairwise_u16: a, b and out offsets disagree on the pair count")
    alen, blen = np.diff(ao), np.diff(bo)
    worst = {"and": np.minimum(alen, blen), "andnot": alen}.get(op, alen + blen)
    if n and ((oo[:n] < 0).any() or (oo[:n] + worst > out_size).any()):
        raise ValueError("batch_pairwise_u16: a pair's output does not fit out_size")
    out = np.empty(max(1, int(out_size)), dtype=np.uint16)
    counts = np.empty(max(1, n), dtype=np.int64)
    lib().rb_batch_pairwise_u16(
        _p(a), _p(ao), _p(b), _p(bo), n, _BATCH_OPS[op], _p(oo), _p(out), _p(counts)
    )
    return out, counts[:n]


def batch_run_pairwise(astarts, alens, aoffs, bstarts, blens, boffs, op: str, out_offs, out_size: int):
    """Run-unified batch AND/ANDNOT (arrays as length-0 runs): one call
    runs every (array|run) x (array|run) pair, emitting result intervals
    (at most ``na + nb`` a pair). ``out_offs=None`` counts only; returns
    ``(out_starts or None, out_lengths or None, interval_counts, cards)``."""
    if op not in ("and", "andnot"):
        raise ValueError(f"batch_run_pairwise runs and/andnot, got {op!r}")
    a_s, a_l = _c16(astarts), _c16(alens)
    b_s, b_l = _c16(bstarts), _c16(blens)
    ao, bo = _c64i(aoffs), _c64i(boffs)
    n = ao.size - 1
    if a_s.size != a_l.size or b_s.size != b_l.size or bo.size != ao.size:
        raise ValueError("batch_run_pairwise: starts, lengths and offsets disagree")
    _check_offsets(ao, a_s.size, "batch_run_pairwise a")
    _check_offsets(bo, b_s.size, "batch_run_pairwise b")
    counts = np.empty(max(1, n), dtype=np.int64)
    cards = np.empty(max(1, n), dtype=np.int64)
    if out_offs is None:
        lib().rb_batch_run_pairwise(
            _p(a_s), _p(a_l), _p(ao), _p(b_s), _p(b_l), _p(bo),
            n, _BATCH_OPS[op], None, None, None, _p(counts), _p(cards),
        )
        return None, None, counts[:n], cards[:n]
    oo = _c64i(out_offs)
    worst = np.diff(ao) + np.diff(bo)
    if oo.size < n or (n and ((oo[:n] < 0).any() or (oo[:n] + worst > out_size).any())):
        raise ValueError("batch_run_pairwise: a pair's output does not fit out_size")
    out_s = np.empty(max(1, int(out_size)), dtype=np.uint16)
    out_l = np.empty(max(1, int(out_size)), dtype=np.uint16)
    lib().rb_batch_run_pairwise(
        _p(a_s), _p(a_l), _p(ao), _p(b_s), _p(b_l), _p(bo),
        n, _BATCH_OPS[op], _p(oo), _p(out_s), _p(out_l), _p(counts), _p(cards),
    )
    return out_s, out_l, counts[:n], cards[:n]


def batch_intersect_card_u16(avals, aoffs, bvals, boffs) -> np.ndarray:
    """Per-pair AND cardinalities, no materialization."""
    a, b = _c16(avals), _c16(bvals)
    ao, bo = _c64i(aoffs), _c64i(boffs)
    n = ao.size - 1
    _check_offsets(ao, a.size, "batch_intersect_card_u16 a")
    _check_offsets(bo, b.size, "batch_intersect_card_u16 b")
    if bo.size != ao.size:
        raise ValueError("batch_intersect_card_u16: a and b disagree on the pair count")
    counts = np.empty(max(1, n), dtype=np.int64)
    lib().rb_batch_intersect_card_u16(_p(a), _p(ao), _p(b), _p(bo), n, _p(counts))
    return counts[:n]


def popcount_rows(mat: np.ndarray) -> np.ndarray:
    """Per-row popcount of an [n_rows, n_words] uint64 matrix."""
    m = _w64(mat)
    n_rows, n_words = m.shape
    out = np.empty(max(1, n_rows), dtype=np.int64)
    lib().rb_popcount_rows(_p(m), n_rows, n_words, _p(out))
    return out[:n_rows]


def scatter_values_rows(row_ids, offsets, vals, out64: np.ndarray, op: str = "or") -> None:
    """Scatter concatenated u16 container values into [*, 1024]-word rows
    with or/xor/clear combine; row ids may repeat (fold accumulators)."""
    rows, offs = _c64i(row_ids), _c64i(offsets)
    v = _c16(vals)
    _check_rows(rows, out64, "scatter_values_rows")
    _check_offsets(offs, v.size, "scatter_values_rows")
    if offs.size != rows.size + 1:
        raise ValueError("scatter_values_rows: one offset more than rows expected")
    lib().rb_scatter_values_rows(_p(rows), _p(offs), rows.size, _p(v), _p(out64), _SCATTER_OPS[op])


def fill_intervals_rows(row_ids, run_offs, starts, ends, out64: np.ndarray, op: str = "or") -> None:
    """Expand many run containers' half-open [start, end) intervals into
    word rows in one call (or: set, xor: flip)."""
    if op not in ("or", "xor"):
        raise ValueError(f"fill_intervals_rows combines with or/xor, got {op!r}")
    rows, offs = _c64i(row_ids), _c64i(run_offs)
    s, e = _c64i(starts), _c64i(ends)
    _check_rows(rows, out64, "fill_intervals_rows")
    if s.size != e.size:
        raise ValueError(f"fill_intervals_rows: {s.size} starts but {e.size} ends")
    _check_offsets(offs, s.size, "fill_intervals_rows")
    if offs.size != rows.size + 1:
        raise ValueError("fill_intervals_rows: one offset more than rows expected")
    lib().rb_fill_intervals_rows(_p(rows), _p(offs), rows.size, _p(s), _p(e), _p(out64), _SCATTER_OPS[op])


def pack_array_rows(row_ids, offsets, vals, out64: np.ndarray) -> None:
    """OR array containers' values into [n_rows, 1024]-word rows in one
    parallel pass: container j's values land in row ``row_ids[j]``. Rows
    must not repeat (the containers split across threads)."""
    rows, offs = _c64i(row_ids), _c64i(offsets)
    v = _c16(vals)
    _check_rows(rows, out64, "pack_array_rows")
    _check_offsets(offs, v.size, "pack_array_rows")
    if offs.size != rows.size + 1:
        raise ValueError("pack_array_rows: one offset more than rows expected")
    lib().rb_pack_array_rows(_p(rows), _p(offs), rows.size, _p(v), _p(out64))
