"""dtype-discipline: container payloads are uint16/uint64 — signed-narrow
intermediates must be explicitly justified.

The roaring invariant (Lemire et al., arXiv:1709.07821) is that container
payloads are unsigned: uint16 values/runs, uint64 words, uint32 universe
points. numpy happily promotes through signed int32 (``astype``, ``dtype=``
kwargs, ``np.int32(...)`` casts), which is lossy for uint32-scale data
(values >= 2^31 wrap negative) and a silent-corruption hazard when a
payload round-trips through such an intermediate. ``int64`` is the blessed
widening type — it holds every uint16/uint32 payload exactly — so this rule
flags only signed types *narrower than 64 bits* (int8/int16/int32/intc/
short/byte) plus the platform-width builtins (``dtype=int`` / ``astype(int)``
/ ``np.int_``), on container payload paths.

Scope: files ending in ``utils/bits.py`` / ``models/container.py`` /
``models/bitset.py``, plus any file carrying a ``# rb-payload-path``
directive. Bounded intermediates (e.g. the ±(2^16+1) cumsum in
words_from_intervals) are annotated ``# rb-ok: dtype-discipline <bound>``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Checker, FileContext, Finding, dotted_name, register

PAYLOAD_PATH_SUFFIXES = (
    "utils/bits.py",
    "models/container.py",
    "models/bitset.py",
)

# signed dtypes that cannot hold the full uint32 payload range
_NARROW_SIGNED = {
    "int8", "int16", "int32", "intc", "short", "byte", "int_", "intp",
}
_PLATFORM_INT = {"int"}  # bare builtin: width is platform-defined


def _dtype_token(node: ast.AST):
    """The signed-dtype identifier named by an expression, or None.

    Matches ``np.int32`` / ``numpy.int32`` / bare ``int32`` / ``int`` /
    string literals ``"int32"`` / ``"i4"``.
    """
    name = dotted_name(node)
    if name is not None:
        tail = name.rsplit(".", 1)[-1]
        if tail in _NARROW_SIGNED or tail in _PLATFORM_INT:
            return tail
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        v = node.value.lower()
        if v in _NARROW_SIGNED or v in _PLATFORM_INT:
            return v
        if v in ("i1", "i2", "i4", "<i4", ">i4", "=i4"):
            return v
    return None


@register
class DtypeDiscipline(Checker):
    rule_id = "dtype-discipline"
    description = (
        "container payload paths must stay uint16/uint64 (int64 widening "
        "allowed); signed-narrow casts need a justifying pragma"
    )
    severity = "error"

    def _applies(self, ctx: FileContext) -> bool:
        rel = ctx.relpath.replace("\\", "/")
        return rel.endswith(PAYLOAD_PATH_SUFFIXES) or ctx.has_directive(
            "payload-path"
        )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if not self._applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            # x.astype(np.int32) / x.astype("int32") / x.astype(dtype=int)
            if isinstance(node.func, ast.Attribute) and node.func.attr == "astype":
                dtype_args = list(node.args[:1]) + [
                    kw.value for kw in node.keywords if kw.arg == "dtype"
                ]
                for arg in dtype_args:
                    tok = _dtype_token(arg)
                    if tok:
                        yield self.finding(
                            ctx,
                            node,
                            f"astype({tok}) on a container payload path: "
                            f"signed-narrow intermediate can wrap uint payloads"
                            f" — widen to int64/uint or justify with "
                            f"`# rb-ok: {self.rule_id} <bound>`",
                        )
                continue
            # np.int32(x) direct casts — bare `int32(x)` (from-import) too
            if fname is not None:
                tail = fname.rsplit(".", 1)[-1]
                if tail in _NARROW_SIGNED:
                    yield self.finding(
                        ctx,
                        node,
                        f"{fname}(...) cast on a container payload path: "
                        f"use uint/int64 or justify with a pragma",
                    )
                    continue
            # dtype=np.int32 keyword on any call (np.cumsum, np.zeros, ...)
            for kw in node.keywords:
                if kw.arg == "dtype":
                    tok = _dtype_token(kw.value)
                    if tok:
                        yield self.finding(
                            ctx,
                            node,
                            f"dtype={tok} on a container payload path: "
                            f"signed-narrow accumulator can wrap uint payloads"
                            f" — widen to int64/uint or justify with "
                            f"`# rb-ok: {self.rule_id} <bound>`",
                        )
