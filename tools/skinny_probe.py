#!/usr/bin/env python3
"""Where the skinny GEMM kernel's time goes, on one GPU.

    python3 tools/skinny_probe.py [--reps 3]

Builds ``kernels/csrc/posit_gemm_skinny.cu`` as it is and in variants with
one part changed (each its own ``nvcc`` process, all started together),
and times each, CUDA graph of 20 calls, best of ``--reps``, on random
p16e1 leaves at the four serve shapes and M = 1 and 4:

* ``as_built``: the source as it is;
* ``no_decode``: each weight word converted to float instead of decoded
  (the decode's cost);
* ``no_chain``: no chain at all (what the encode, the copies, the barriers
  and the fold cost);
* ``cluster16``: clusters of up to 16 blocks along K (non-portable);
* ``tile32``: 32-column tiles everywhere (no 64-column tiles).

The variants' outputs are wrong by design; only ``as_built`` is the
kernel.  Prints one line per shape and M with the card's ``nvidia-smi``
name and power limit.  A variant whose source text is not found fails.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

TILE_RULE = ("  const int g = n < TILE ? n : n >= 512 && 2 * TILE * kb <= "
             "max_threads\n                                   ? 2 * TILE : "
             "TILE;")
VARIANTS = {
    "as_built": [],
    "no_decode": [("        const float b = decode_hi<NBITS, ES>(wc[r * g.g]);",
                   "        const float b = (float)wc[r * g.g];")],
    "no_chain": [("      for (int r = 0; r < rows_c; ++r) {   // fmaf(a, b, "
                  "ph): the tiled order",
                  "      for (int r = 0; r < 0 * rows_c; ++r) {")],
    "cluster16": [("constexpr int MAX_CLUSTER = 8;",
                   "constexpr int MAX_CLUSTER = 16;"),
                  ("    if (dev >= 0 && dev < 64) attr_set[dev] = true;",
                   "    e = cudaFuncSetAttribute(kern, cudaFuncAttribute"
                   "NonPortableClusterSizeAllowed, 1);\n    if (e != "
                   "cudaSuccess) return e;\n    if (dev >= 0 && dev < 64) "
                   "attr_set[dev] = true;")],
    "tile32": [(TILE_RULE, "  const int g = n < TILE ? n : TILE;")],
}
SHAPES = ((896, 128), (896, 896), (896, 4864), (4864, 896))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.serving import QuantConfig
    from repro_torch.serving import quantize as qz
    base = (_build.CSRC / "posit_gemm_skinny.cu").read_text()
    work = Path(tempfile.mkdtemp(prefix="skinny_probe_"))
    procs = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: source text not found: {old!r}")
            src = src.replace(old, new)
        (work / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(work / f"{name}.so"),
             str(work / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = _build.bind(ctypes.CDLL(str(work / f"{name}.so")))
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(0)
    for k, n in SHAPES:
        w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05)
                             .astype(np.float32)).to(dev)
        leaf = qz.quantize_leaf({"w": w, "axes": (None, None)},
                                QuantConfig(fmt="p16e1", backend="pallas"))
        for m in (1, 4):
            x = torch.from_numpy(rng.standard_normal((m, k))
                                 .astype(np.float32)).to(dev)
            y = torch.empty((m, n), device=dev)
            times = []
            for name, lib in libs.items():
                def call(lib=lib):
                    rc = lib.posit_gemm_skinny_launch(
                        x.data_ptr(), leaf["qw"].data_ptr(),
                        leaf["sexp"].data_ptr(), y.data_ptr(), m, n, k, 1,
                        32, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")
                t = min(cs.graph_ms(call, 20) for _ in range(args.reps))
                times.append(f"{name} {t:.4f}")
            print(f"[probe] ({m}, {k}, {n}) p16e1 ms: " + ", ".join(times)
                  + f" [{smi}]", flush=True)
    for f in work.iterdir():
        f.unlink()
    os.rmdir(work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
