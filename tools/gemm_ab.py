#!/usr/bin/env python3
"""Time the posit kernels of two or more checkouts of the repo on one GPU.

    python3 tools/gemm_ab.py TREE [TREE ...] [--rounds 5] [--out FILE]

Each TREE is the root of a checkout (``src/repro_torch`` under it).  The
trees are timed in the order given, each in a process of its own that
builds that tree's kernels and imports its ``repro_torch``; give them as
A B B A to cancel drift.  A process times, each the mean device time of
one call in a CUDA graph of 20 calls, best of ``--rounds``:

* at (4032, 64, 4032) p32e2 split3 (the n=4096 LU's first trailing
  update), the f32 form ``posit_gemm_f32``, the fused form ``posit_gemm``
  and the simple kernel ``posit_gemm_f32_simple`` (the same source in
  every tree, so the ratio to it cancels what differs between processes);
* the encode kernel ``encode_posit_f32`` at 2^24 values: p32e2 and p16e1
  into int32, and p16e1 into the int16 wire words (where the tree's
  wrapper takes no ``out_dtype``, its int32 words and the cast after them,
  as its K/V path did); and ``serving.kv_cache.encode_kv`` on one layer's
  K rows at decode width 4 (4 x 2 KV heads x 64, qwen2-0.5b);
* the skinny kernel ``quant_gemm_f32`` at qwen2-0.5b's four linear shapes
  at decode width 4, p16e1 words.

Each time has its bound beside it (bytes over 3.35 TB/s, flops over 67
TFLOP/s FP32, the larger), and each output its SHA-256, which the summary
holds equal across the trees: a change of the kernels that moves a word
fails there.  It also prints ptxas's registers for the tiled kernel's
main-path instantiations when it built the library itself, and for those,
the encode kernels and the skinny kernel at M = 4 the number of SASS
instructions by opcode, their loops and, for the encode kernels, the
instructions a value (``tools/kernel_sass.py``'s counts of the built
library): where two trees' kernels differ in time, the static counts show
which instructions changed.  One JSON line per process, then a summary
line; the card's ``nvidia-smi`` name and power limit are printed beside
them.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import kernel_sass              # tools/, beside this script

SHAPE = (4032, 64, 4032)
# The main path's instantiations: p32e2 split3, one K chunk, f32 and fused.
MAIN = "posit_gemm_kernel<32,2,0,1,"
SASS_KERNELS = (MAIN, "encode_posit_kernel<",
                "posit_gemm_skinny_kernel<16,1,4>")
ENCODE_N = 1 << 24
KV_ROWS = (4, 2, 64)           # decode width x KV heads x head width
# qwen2-0.5b's linears at decode width 4: (M, K, N) of q/o, k/v, gate/up,
# down (d_model 896, d_kv 128, d_ff 4864)
SKINNY_SHAPES = ((4, 896, 896), (4, 896, 128), (4, 896, 4864),
                 (4, 4864, 896))
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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
    """{kernel: {"total": n, "loops": [...], opcode: n, ...}} for the
    ``SASS_KERNELS`` in the SASS of a built library, with ``per_value`` for
    the encode kernels (empty when cuobjdump is missing)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for mangled, insns in kernel_sass.functions(sass):
        name = kernel_name(mangled)
        if not name.startswith(SASS_KERNELS):
            continue
        loops = kernel_sass.loops(insns)
        out[name] = {"total": len(insns), "loops": loops,
                     **collections.Counter(op for _, op, _ in insns)}
        per_trip = kernel_sass.values_per_trip(name)
        if per_trip and loops:
            out[name]["per_value"] = max(loops) / per_trip
    return out


def bound_ms(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3


def digest(t) -> str:
    import torch
    t = t.contiguous().cpu()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def worker(tree: Path, rounds: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import inspect
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import P16E1, P32E2
    from repro_torch.kernels import _build
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.serving.kv_cache import encode_kv
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
    gemm_bytes = 4.0 * (m * k + k * n + m * n)
    fns = {"posit_gemm_f32": (lambda: pg.posit_gemm_f32(a, b),
                              bound_ms(gemm_bytes, 6.0 * m * k * n)),
           "posit_gemm": (lambda: pg.posit_gemm(a, b),
                          bound_ms(gemm_bytes, 6.0 * m * k * n)),
           "posit_gemm_f32_simple": (lambda: pg.posit_gemm_f32_simple(a, b),
                                     bound_ms(gemm_bytes, 6.0 * m * k * n))}
    vals = torch.from_numpy((rng.standard_normal(ENCODE_N) * 100.0)
                            .astype(np.float32)).to(dev)
    narrow = "out_dtype" in inspect.signature(pg.encode_posit_f32).parameters

    def p16_int16():
        if narrow:
            return pg.encode_posit_f32(vals, P16E1, out_dtype=torch.int16)
        return pg.encode_posit_f32(vals, P16E1).to(torch.int16)
    kv = torch.from_numpy(rng.standard_normal(KV_ROWS).astype(np.float32)
                          ).to(dev)
    fns.update({
        "encode_p32e2_int32": (lambda: pg.encode_posit_f32(vals, P32E2),
                               bound_ms(8.0 * ENCODE_N)),
        "encode_p16e1_int32": (lambda: pg.encode_posit_f32(vals, P16E1),
                               bound_ms(8.0 * ENCODE_N)),
        "encode_p16e1_int16": (p16_int16, bound_ms(6.0 * ENCODE_N)),
        "encode_kv_p16e1": (lambda: encode_kv(kv, "p16e1"),
                            bound_ms(6.0 * kv.numel()))})
    for (mm, kk, nn) in SKINNY_SHAPES:
        x = torch.from_numpy(rng.standard_normal((mm, kk)).astype(
            np.float32)).to(dev)
        w = posit.from_float64(torch.from_numpy(
            rng.standard_normal((kk, nn)) * 0.05).to(dev), P16E1
        ).to(torch.int16)
        sx = torch.from_numpy(rng.integers(-3, 4, nn).astype(np.int8)
                              ).to(dev)
        fns[f"skinny_{mm}x{kk}x{nn}"] = (
            lambda x=x, w=w, sx=sx: pg.quant_gemm_f32(x, w, sx, P16E1),
            bound_ms(2.0 * kk * nn + 4.0 * (mm * kk + mm * nn) + nn,
                     2.0 * mm * kk * nn))
    ms = {name: min(graph_ms(fn) for _ in range(rounds))
          for name, (fn, _) in fns.items()}
    return dict(tree=str(tree), shape=list(SHAPE), ms=ms,
                bound_ms={name: bd for name, (_, bd) in fns.items()},
                sha256={name: digest(fn()) for name, (fn, _) in fns.items()},
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
        s = summary.setdefault(r["tree"], {"f32_over_simple": []})
        for name, t in r["ms"].items():
            s.setdefault(name, []).append(t)
        s["f32_over_simple"].append(r["f32_over_simple"])
    moved = sorted(name for name in rows[0]["sha256"]
                   if len({r["sha256"][name] for r in rows}) > 1)
    print(json.dumps({"device": smi, "summary": summary,
                      "bound_ms": rows[0]["bound_ms"] if rows else {},
                      "outputs_differ": moved}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=smi, runs=rows, summary=summary,
                 outputs_differ=moved), indent=1))
    if moved:
        print(f"gemm_ab: the trees' outputs differ: {moved}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
