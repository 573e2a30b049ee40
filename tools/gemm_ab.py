#!/usr/bin/env python3
"""Time the posit GEMM kernel of two or more checkouts of the repo on one GPU.

    python3 tools/gemm_ab.py TREE [TREE ...] [--rounds 5] [--out FILE]

Each TREE is the root of a checkout (``src/repro_torch`` under it).  The
trees are timed in the order given, each in a process of its own that
builds that tree's kernels and imports its ``repro_torch``; give them as
A B B A to cancel drift.  A process times, at (4032, 64, 4032) p32e2
split3 (the n=4096 LU's first trailing update), the f32 form
``posit_gemm_f32``, the fused form ``posit_gemm`` and the simple kernel
``posit_gemm_f32_simple`` (the same source in every tree, so the ratio to
it cancels what differs between processes), each the mean device time of
one call in a CUDA graph of 20 calls, best of ``--rounds``.  It also
prints ptxas's registers for the tiled kernel's main-path instantiations
when it built the library itself, and for the same instantiations the
number of SASS instructions by opcode (``cuobjdump -sass`` of the built
library): where two trees' kernels differ in time, the static counts show
which instructions changed.  One JSON line per process, then a summary
line; the card's ``nvidia-smi`` name and power limit are printed beside
them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (4032, 64, 4032)
# The main path's instantiations: p32e2 split3, one K chunk, f32 and fused.
MAIN = "posit_gemm_kernel<32,2,0,1,"


def graph_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sass_counts(so: Path, kernel_name) -> dict:
    """{kernel: {"total": n, opcode: n, ...}} for the ``MAIN`` kernels in
    the SASS of a built library (empty when cuobjdump is missing)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = kernel_name(m[1])
            if name.startswith(MAIN):
                out[name] = {"total": 0}
        elif name in out and (m := re.match(
                r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                line)):
            ops = out[name]
            ops["total"] += 1
            ops[m[1]] = ops.get(m[1], 0) + 1
    return out


def worker(tree: Path, rounds: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.kernels import _build
    from repro_torch.kernels import posit_gemm as pg
    _build.lib()
    report = _build.ptxas_report() if _build.build_log else {}
    sass = sass_counts(_build.build(), _build.kernel_name)
    m, k, n = SHAPE
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    a = posit.from_float64(torch.from_numpy(rng.standard_normal((m, k)))
                           .to(dev))
    b = posit.from_float64(torch.from_numpy(rng.standard_normal((k, n)))
                           .to(dev))
    fns = {"posit_gemm_f32": lambda: pg.posit_gemm_f32(a, b),
           "posit_gemm": lambda: pg.posit_gemm(a, b),
           "posit_gemm_f32_simple": lambda: pg.posit_gemm_f32_simple(a, b)}
    ms = {name: min(graph_ms(fn) for _ in range(rounds))
          for name, fn in fns.items()}
    return dict(tree=str(tree), shape=list(SHAPE), ms=ms,
                build_s=_build.build_seconds,
                f32_over_simple=ms["posit_gemm_f32"]
                / ms["posit_gemm_f32_simple"],
                registers={name: r["registers"] for name, r in report.items()
                           if name.startswith(MAIN)},
                sass=sass)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve(), args.rounds)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gemm_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = []
    for tree in args.trees:
        out = subprocess.run([sys.executable, __file__, "--worker",
                              str(tree), "--rounds", str(args.rounds)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), f"[{smi}]", flush=True)
    summary = {}
    for r in rows:
        s = summary.setdefault(r["tree"], {"posit_gemm_f32": [],
                                           "posit_gemm": [],
                                           "f32_over_simple": []})
        s["posit_gemm_f32"].append(r["ms"]["posit_gemm_f32"])
        s["posit_gemm"].append(r["ms"]["posit_gemm"])
        s["f32_over_simple"].append(r["f32_over_simple"])
    print(json.dumps({"device": smi, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=smi, runs=rows, summary=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
