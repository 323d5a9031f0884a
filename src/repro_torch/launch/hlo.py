"""HLO text analysis: the per-op collective census.

A copy of the regex parser of ``repro.launch.hlo`` that trace replay
needs (``repro_torch.trace.hlo_to_trace``); it reads HLO text and lowers
nothing.  In optimized dumps operands are bare ``%name`` references, so
per-op *operand* bytes are recovered from the result shape and the
replica-group size:

    all-reduce / all-to-all / collective-permute : operand == result
    all-gather                                   : operand == result / gs
    reduce-scatter                               : operand == result * gs
"""
from __future__ import annotations

import re

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z][a-z0-9]*)\[([\d,]*)\]")
_LINE_RE = re.compile(
    r"=\s*(.+?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_EXPL_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_PAIR_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")
_PAIR_ITEM_RE = re.compile(r"\{(\d+),(\d+)\}")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str) -> int:
    m = _IOTA_GROUPS_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    m = _EXPL_GROUPS_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    return 1


def _permute_pairs(line: str) -> list[tuple[int, int]]:
    m = _PAIR_RE.search(line)
    if not m:
        return []
    return [(int(a), int(b)) for a, b in _PAIR_ITEM_RE.findall(m.group(1))]


def collective_ops(hlo_text: str) -> list[dict]:
    """Every collective op in program order, one dict per op:
    ``{"kind", "bytes" (per-device operand bytes), "group_size",
    "pairs" (collective-permute's source_target_pairs, else [])}``.

    Async ``-start`` ops print a ``(operand, result)`` tuple shape; only
    the result (last) shape is counted, so start/done pairs contribute
    exactly once and tuple results are not double-counted.
    """
    ops = []
    for line in hlo_text.splitlines():
        m = _LINE_RE.search(line)
        if not m:
            continue
        kind, is_start = m.group(2), bool(m.group(3))
        shapes = [_shape_bytes(sm.group(1), sm.group(2))
                  for sm in _SHAPE_RE.finditer(m.group(1))]
        if not shapes:
            continue
        result_bytes = shapes[-1] if is_start else sum(shapes)
        pairs = _permute_pairs(line) if kind == "collective-permute" else []
        gs = len(pairs) if pairs else _group_size(line)
        if kind == "all-gather":
            nbytes = result_bytes // max(gs, 1)
        elif kind == "reduce-scatter":
            nbytes = result_bytes * gs
        else:
            nbytes = result_bytes
        ops.append({"kind": kind, "bytes": int(nbytes), "group_size": gs,
                    "pairs": pairs})
    return ops
