#!/usr/bin/env python3
"""List the loops of a kernel's SASS, to count instructions per step.

Reads the text of ``cuobjdump -sass <library>`` and, for every function
whose mangled name contains ``--function``, prints each loop (a branch
back to an earlier address) with its address range, its instruction count
and the count of each opcode class in it. ``--range START END`` (hex
addresses) prints the same counts for one straight stretch of code, such
as a loop body without its rare path.

    cuobjdump -sass build/graphmine_tpu_torch/libknn_topk_<hash>.so > k.sass
    python3 tools/sass_loops.py k.sass --function knn_general_kernel
"""

from __future__ import annotations

import argparse
import re
from collections import Counter

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_CLASSES = (
    ("fp32", ("FMUL", "FADD", "FSETP", "FMNMX", "FSEL", "FFMA")),
    ("shared", ("LDS", "STS")),
    ("global", ("LDG", "STG", "LD", "ST")),
    ("warp", ("SHFL", "VOTE", "MATCH", "WARPSYNC", "BAR")),
    ("branch", ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET")),
)


def parse(text: str) -> dict:
    """``{function name: [(address, opcode, operands), ...]}``."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            out[cur] = []
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            out[cur].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def classify(ops) -> dict:
    """Instruction count of each class (the first dotted part of the
    opcode decides), ``other`` for the rest."""
    c = Counter()
    for _, op, _ in ops:
        base = op.split(".")[0]
        cls = next((name for name, bases in _CLASSES if base in bases), "other")
        c[cls] += 1
    return {"total": len(ops), **dict(sorted(c.items()))}


def loops(insns) -> list:
    """``(start, end)`` of every backward branch, innermost first."""
    found = set()
    for addr, op, args in insns:
        if op.startswith("BRA"):
            m = _TARGET.search(args)
            if m and int(m.group(1), 16) <= addr:
                found.add((int(m.group(1), 16), addr))
    return sorted(found, key=lambda se: se[1] - se[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sass", help="output of cuobjdump -sass")
    ap.add_argument("--function", required=True, help="part of the mangled function name")
    ap.add_argument("--range", nargs=2, metavar=("START", "END"),
                    help="hex addresses of a stretch to count, END included")
    args = ap.parse_args(argv)
    with open(args.sass) as fh:
        funcs = parse(fh.read())
    for name, insns in funcs.items():
        if args.function not in name:
            continue
        print(name)
        if args.range:
            lo, hi = (int(a, 16) for a in args.range)
            print(f"  range {lo:#x}-{hi:#x}: {classify([i for i in insns if lo <= i[0] <= hi])}")
            continue
        for lo, hi in loops(insns):
            print(f"  loop {lo:#x}-{hi:#x}: {classify([i for i in insns if lo <= i[0] <= hi])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
