#!/usr/bin/env python3
"""Static SASS instruction counts of the port's CUDA kernels.

    python3 tools/kernel_sass.py [SUBSTRING ...] [--out FILE]

Builds the kernel library (``repro_torch.kernels._build.lib()``, cached by
content), disassembles it with the CUDA toolkit's ``cuobjdump -sass`` and
prints, for every kernel whose readable name (``posit_gemm_kernel<16,1,0,0,
0,0>``) contains one of the substrings (all kernels without any), one JSON
line: its instruction count, the length of each loop (the instructions
from a backward branch's target to the branch; a grid-stride elementwise
kernel's loop is the cost of one element), and its opcodes by class
(integer ALU, float, memory, control, uniform).  ``--out`` also writes the
full disassembly there.  Static counts: what a loop's body issues per
trip, not how often it runs.  Run it where the card and the toolkit are.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

CLASSES = (
    ("float", ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "I2F",
               "F2I", "MUFU", "HFMA2", "HADD2", "HMUL2", "FCHK", "I2FP",
               "F2F", "FRND")),
    ("memory", ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "LDGSTS",
                "LDGDEPBAR", "DEPBAR", "ATOM", "RED", "MEMBAR", "LDSM")),
    ("control", ("BRA", "BSSY", "BSYNC", "EXIT", "BAR", "RET", "CALL",
                 "WARPSYNC", "NOP", "YIELD", "ERRBAR", "CCTL", "UCGABAR")),
)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(?:\.[A-Z0-9_.]+)?")


def opcode_class(op: str) -> str:
    if op.startswith("U") and op not in ("UCGABAR",):
        return "uniform"
    for name, ops in CLASSES:
        if op in ops:
            return name
    return "integer"


def functions(sass: str):
    """(mangled name, [(address, opcode, line)]) of every function."""
    for block in sass.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        insns = [(int(m[1], 16), m[2], line.strip())
                 for line in body.splitlines() if (m := _INSN.search(line))]
        yield name.strip(), insns


def loops(insns):
    """Lengths of the backward branches' bodies, in instructions."""
    index = {addr: i for i, (addr, _, _) in enumerate(insns)}
    out = []
    for i, (addr, op, line) in enumerate(insns):
        m = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", line)
        if op == "BRA" and m and int(m[1], 16) < addr:
            out.append(i - index.get(int(m[1], 16), i) + 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from repro_torch.kernels import _build
    lib = _build.build()
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(sass)
    for mangled, insns in functions(sass):
        name = _build.kernel_name(mangled)
        if args.names and not any(s in name for s in args.names):
            continue
        by_class = collections.Counter(opcode_class(op) for _, op, _ in insns)
        print(json.dumps(dict(kernel=name, instructions=len(insns),
                              loops=loops(insns), by_class=by_class)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
