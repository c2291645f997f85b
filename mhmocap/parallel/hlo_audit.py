"""Collective-traffic extraction from compiled (post-GSPMD) HLO text.

Used by `script/audit_collectives.py` and the collective-budget regression
test (tests/test_spmd_production.py) to check what the partitioner
ACTUALLY inserts for the fused sharded cycle against the analytic
budget — the reference has no distributed path at all (survey §2.3),
so this audit guards a design invariant of this repo: the
time-sharded cycle must stay compute-bound (KBs of inter-device
traffic per cycle, never an O(T·V) or O(T·H·W) gather).
"""

from __future__ import annotations

import re

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2,
                "s16": 2, "u16": 2, "f32": 4, "s32": 4, "u32": 4,
                "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16}

_SHAPE_RE = re.compile(r"([a-z]+\d*)\[([\d,]*)\]")
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "collective-permute",
                    "reduce-scatter", "all-to-all",
                    "collective-broadcast", "ragged-all-to-all")
_OP_RE = re.compile(
    r"=\s+((?:\([^=]*?\))|(?:[a-z]+\d*\[[\d,]*\]\S*))\s+"
    r"(" + "|".join(COLLECTIVE_KINDS) + r")(-start|-done)?\(")


def _element_bytes(shape_str: str):
    """Per-array byte counts of an HLO shape string (tuple elements
    listed separately; unknown dtypes like token skipped)."""
    sizes = []
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        sizes.append(n * _DTYPE_BYTES[dtype])
    return sizes


def shape_bytes(shape_str: str) -> int:
    """Total bytes of an HLO result shape string (tuples summed)."""
    return sum(_element_bytes(shape_str))


def extract_collectives(hlo_text: str):
    """[(kind, result_shape_str, bytes)] from optimized HLO text.

    '-done' ops are skipped ('-start' already carries the shape).
    Async '-start' ops return (operand, result, ...) tuples that alias
    the input buffer — only the LARGEST element is counted for them
    (summing would double-count the transfer; e.g. an
    all-gather-start's (f32[26,..], f32[208,..]) tuple moves 208 rows,
    not 234). Shapes are per-partition when the module was compiled
    for a mesh, so bytes are per-device."""
    out = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m or m.group(3) == "-done":
            continue
        shape = m.group(1).strip()
        if m.group(3) == "-start" and shape.startswith("("):
            nbytes = max(_element_bytes(shape), default=0)
        else:
            nbytes = shape_bytes(shape)
        out.append((m.group(2), shape, nbytes))
    return out


def collective_totals(hlo_text: str):
    """{kind: total_bytes} summary of extract_collectives."""
    totals = {}
    for kind, _, nbytes in extract_collectives(hlo_text):
        totals[kind] = totals.get(kind, 0) + nbytes
    return totals
