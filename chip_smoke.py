#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out RESULT.json]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/``
(checking that the main path's GEMM kernels do not spill), checks every
kernel against its plain PyTorch version and the tiled GEMM kernel against
the first (simple) kernel bit for bit, drives the paper's §5.1 path
(posit LU and Cholesky with every trailing update on the decode pre-pass
and the tiled GEMM kernel, triangular solves, backward error against
binary32) at full size, and times the kernels: the tiled kernel and the
simple one interleaved, the pre-pass, the f32 and f64 ``torch.matmul``
yardsticks, and the whole ``rgemm`` trailing-update call.  Every phase raises on a failed check, so the
script exits non-zero unless all of them pass.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it carries
the card's name and power limit as ``nvidia-smi`` reports them, and the
line before that the per-kernel JSON (launches on the main path, error,
times and bound).

It imports nothing of JAX or of the JAX package ``repro``, and needs one
CUDA device; without one it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # torch_inputs: the tests' inputs

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): FP32 on the
# CUDA cores and device-memory bandwidth.  Bounds are stated against them,
# with the card's power limit printed beside every time.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

MAIN_LU = dict(n=4096, sigma=1.0, algo="lu", nb=64)
MAIN_CHOL = dict(n=1024, sigma=1.0, algo="cholesky", nb=64)
GEMM_SHAPES = ((65, 17, 130), (33, 65, 9), (4032, 64, 4032), (64, 64, 64))
IDENTITY_SHAPES = ((65, 17, 130), (33, 65, 9), (257, 300, 129),
                   (4032, 64, 4032))
TIMED_SHAPE = (4032, 64, 4032)      # the n=4096 LU's first trailing update
# The tiled kernel's instantiations on the main path (p32e2, split3, one K
# chunk; f32 out and fused encode): ptxas must report no spills for them.
MAIN_PATH_KERNELS = ("posit_gemm_kernel<32,2,0,1,0>",
                     "posit_gemm_kernel<32,2,0,1,1>")
SOURCES = {"posit_gemm_f32": "posit_gemm.cu", "posit_gemm": "posit_gemm.cu",
           "decode_planes": "posit_gemm.cu",
           "decode_split_f32": "posit_codec.cu",
           "encode_posit_f32": "posit_codec.cu",
           "posit_gemm_f32_simple": "posit_gemm_simple.cu",
           "posit_gemm_simple": "posit_gemm_simple.cu"}
REPLACES = {"posit_gemm_f32": "src/repro/kernels/posit_gemm.py:271",
            "posit_gemm": "src/repro/kernels/posit_gemm.py:271",
            "decode_planes": "src/repro/kernels/posit_gemm.py:211",
            "decode_split_f32": "src/repro/kernels/posit_gemm.py:88",
            "encode_posit_f32": "src/repro/kernels/posit_gemm.py:127",
            "posit_gemm_f32_simple": "src/repro/kernels/posit_gemm.py:271",
            "posit_gemm_simple": "src/repro/kernels/posit_gemm.py:271"}
ON_MAIN_PATH = ("posit_gemm_f32", "decode_planes")


def say(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed (CUDA events around the replay), after warm-up
    calls: the kernels' time without the host's per-call launch overhead,
    which for the GEMM's pre-pass is ten times its device time."""
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


def same_bits(x, y) -> bool:
    """Bit-equal tensors (floats: equal bits, or NaN in both)."""
    import torch
    x, y = x.cpu(), y.cpu()
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype.is_floating_point:
        ib = torch.int64 if x.element_size() == 8 else torch.int32
        return bool(((x.view(ib) == y.view(ib))
                     | (torch.isnan(x) & torch.isnan(y))).all())
    return bool(torch.equal(x, y))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build():
    """Build the kernels; print ptxas's registers, stack and spills per
    kernel; the decode pre-pass and the tiled GEMM must not spill in any
    instantiation, and the main path's must be among them."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    secs = time.perf_counter() - t0
    say(f"[build] kernels built and loaded in {secs:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s, one process per source)")
    report = _build.ptxas_report()
    for name, r in sorted(report.items()):
        say(f"[build] {name:36s} {json.dumps(r)}")
    for name in MAIN_PATH_KERNELS:
        check(name in report, f"ptxas reported nothing for {name}")
    for name, r in report.items():
        if name.startswith(("posit_gemm_kernel<", "decode_planes_kernel<")):
            check(r["spill_stores"] == r["spill_loads"] == r["stack"] == 0,
                  f"{name} spills: {r}")
    return secs, report


def phase_plain_codec(dev):
    """The plain codec on the card gives the CPU's bits."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import FORMATS, P16E1, P32E2
    import torch_inputs as ti
    rng = np.random.default_rng(20)
    for fmt in FORMATS.values():
        w = ti.words(fmt, rng, 1 << 20)
        wc = torch.from_numpy(w)
        v_cpu = posit.to_float64(wc, fmt)
        v_gpu = posit.to_float64(wc.to(dev), fmt)
        check(same_bits(v_cpu, v_gpu), f"to_float64 {fmt.name}: GPU != CPU")
        x = rng.standard_normal(1 << 18) * np.exp2(rng.uniform(-300, 300,
                                                               1 << 18))
        x = torch.cat([v_cpu, torch.from_numpy(x),
                       torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                     float("nan"), 5e-324, 2.0 ** -1022,
                                     1.7e308], dtype=torch.float64)])
        w_cpu = posit.from_float64(x, fmt)
        w_gpu = posit.from_float64(x.to(dev), fmt)
        check(same_bits(w_cpu, w_gpu), f"from_float64 {fmt.name}: GPU != CPU")
        check(same_bits(w_cpu[:wc.numel()], wc), f"{fmt.name}: word round trip")
        say(f"[codec] {fmt.name}: {wc.numel()} words + {x.numel()} values, "
            "to_float64/from_float64 bit-identical GPU vs CPU")
    for fmt in (P32E2, P16E1):
        x = ti.values(np.random.default_rng(7))
        xc = torch.from_numpy(x)
        r_cpu = posit.chain_round(xc, fmt)
        r_gpu = posit.chain_round(xc.to(dev), fmt)
        check(same_bits(r_cpu, r_gpu), f"chain_round {fmt.name}: GPU != CPU")
        check(same_bits(r_cpu, posit.to_float64(posit.from_float64(xc, fmt),
                                                fmt)),
              f"chain_round {fmt.name} != word round trip")
        say(f"[codec] chain_round {fmt.name}: {x.size} values bit-identical "
            "GPU vs CPU and to the word round trip")


def phase_codec_kernels(dev):
    """Decode/encode elementwise kernels vs their plain versions."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import FORMATS
    from repro_torch.kernels import posit_gemm as pg
    import torch_inputs as ti
    rng = np.random.default_rng(21)
    corners = torch.from_numpy(ti.f32_corners())
    rand_f32 = torch.from_numpy(rng.integers(0, 2**32, 1 << 22,
                                             dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)
                                ).view(torch.float32)
    for fmt in FORMATS.values():
        w = ti.words(fmt, rng, 1 << 24)
        wg = torch.from_numpy(w).to(dev)
        kh, kl = pg.decode_split_f32(wg, fmt)
        ph, pl = pg.decode_split_f32_plain(wg, fmt)
        check(same_bits(kh, ph) and same_bits(kl, pl),
              f"decode_split kernel {fmt.name} != plain")
        exact = posit.to_float64(wg, fmt)
        fin = ~torch.isnan(exact) & (exact.abs() >= 2.0 ** -99)
        check(torch.equal((kh.double() + kl.double())[fin], exact[fin]),
              f"decode_split {fmt.name}: hi + lo != value")
        for name, x in (("corner", corners), ("random-bits", rand_f32)):
            xg = x.to(dev)
            ke = pg.encode_posit_f32(xg, fmt)
            check(same_bits(ke, pg.encode_posit_f32_plain(xg, fmt)),
                  f"encode kernel {fmt.name} {name} != plain")
            check(same_bits(ke, posit.from_float32_bits(x, fmt)),
                  f"encode kernel {fmt.name} {name} != from_float32_bits")
        say(f"[kernels] {fmt.name}: decode_split on {w.size} words and "
            f"encode_posit on {corners.numel() + rand_f32.numel()} f32 "
            "values bit-identical to the plain versions")


def phase_gemm(dev):
    """GEMM kernel vs the exact product and vs its plain version, then on
    operands where the lo planes decide the product."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import FORMATS
    from repro_torch.kernels import posit_gemm as pg
    import torch_inputs as ti
    rng = np.random.default_rng(22)
    worst = {}
    for fmt in FORMATS.values():
        for (m, k, n) in GEMM_SHAPES:
            a = ti.posits(rng, (m, k), -4, 4, fmt, dev)
            b = ti.posits(rng, (k, n), -4, 4, fmt, dev)
            av, bv = posit.to_float64(a, fmt), posit.to_float64(b, fmt)
            bound = np.sqrt(k) * 8e-8
            for mode in pg.MODES:
                got = pg.posit_gemm_f32(a, b, mode=mode, fmt=fmt)
                plain = pg.posit_gemm_f32_plain(a, b, mode=mode, fmt=fmt)
                e_k = ti.gemm_rel_err(got, av, bv)
                e_p = ti.gemm_rel_err(plain, av, bv)
                check(e_k < bound and e_p < bound,
                      f"gemm {fmt.name} {mode} {(m, k, n)}: kernel {e_k:.3g} "
                      f"plain {e_p:.3g} >= bound {bound:.3g}")
                diff = float((got - plain).abs().max())
                worst[("posit_gemm_f32", fmt.name, (m, k, n), mode)] = diff
                for neg in (False, True):
                    fused = pg.posit_gemm(a, b, mode=mode, negate=neg,
                                          fmt=fmt)
                    want = pg.encode_posit_f32_plain(-got if neg else got,
                                                     fmt)
                    check(torch.equal(fused, want),
                          f"posit_gemm {fmt.name} {mode} neg={neg} "
                          f"{(m, k, n)} != encode(± own f32 output)")
                say(f"[gemm] {fmt.name} {mode:11s} {str((m, k, n)):18s} "
                    f"rel err kernel {e_k:.3e} plain {e_p:.3e} "
                    f"(bound sqrt(K)*8e-8 = {bound:.3e}); "
                    f"max|kernel-plain| {diff:.3e}; fused encode "
                    "bit-identical")
    # Where the lo planes decide the product, sqrt(K)*8e-8 would also pass
    # a hi-plane-only GEMM; this check does not, as its control shows.
    limit = ti.LO_PLANE_LIMIT
    for (m, k, n) in ti.LO_PLANE_SHAPES:
        a, b = ti.lo_plane_operands(rng, m, k, n, dev)
        e_hi = ti.lo_plane_err(ti.hi_only_product(a, b), a, b)
        check(e_hi > limit, f"lo-plane case {(m, k, n)}: the hi-only control "
              f"({e_hi:.3g}) is within {limit:.3g}, so the case tests nothing")
        for mode in pg.MODES:
            e_k = ti.lo_plane_err(pg.posit_gemm_f32(a, b, mode=mode), a, b)
            e_p = ti.lo_plane_err(pg.posit_gemm_f32_plain(a, b, mode=mode),
                                  a, b)
            check(e_k <= limit and e_p <= limit,
                  f"lo-plane case {mode} {(m, k, n)}: kernel {e_k:.4g} plain "
                  f"{e_p:.4g} > {limit:.4g} (hi-only control {e_hi:.4g})")
            say(f"[gemm] p32e2 {mode:11s} {str((m, k, n)):18s} lo planes "
                f"decide: rel err kernel {e_k:.4e} plain {e_p:.4e} <= "
                f"{limit:.4e} < hi-only control {e_hi:.4e}")
    return worst


def phase_bit_identity(dev):
    """The tiled kernel (pre-pass + GEMM) against the simple kernel, bit
    for bit: every format, both modes, kc 16/48/128 (several chunks where
    K > kc), ragged and full-size shapes, an exactly cancelling product,
    row-strided and transposed views; the fused form against the encode
    of its own f32 output and the simple kernel's words."""
    import numpy as np
    import torch
    from repro_torch.core.formats import FORMATS
    from repro_torch.kernels import posit_gemm as pg
    import torch_inputs as ti
    rng = np.random.default_rng(24)

    def bits(x):
        return x.view(torch.int32)
    compared = 0
    for fmt in FORMATS.values():
        cases = []
        for (m, k, n) in IDENTITY_SHAPES:
            a = ti.posits(rng, (m, k), -4, 4, fmt, dev)
            a[0, 0] = fmt.nar_pattern
            cases.append((f"{(m, k, n)}", a,
                          ti.posits(rng, (k, n), -4, 4, fmt, dev)))
        cases.append(("cancelling (257, 96, 129)",
                      *ti.cancelling_operands(rng, 257, 96, 129, fmt, dev)))
        big = ti.posits(rng, (300, 300), -2, 2, fmt, dev)
        cases.append(("row-strided views", big[70:, 3:67], big[3:67, 70:]))
        cases.append(("trans_b view", big[70:, 3:67], big[70:233, 3:67].T))
        for label, a, b in cases:
            for mode in pg.MODES:
                for kc in (16, 48, 128):
                    kw = dict(bk=kc, mode=mode, fmt=fmt)
                    got = pg.posit_gemm_f32(a, b, **kw)
                    check(torch.equal(bits(got),
                                      bits(pg.posit_gemm_f32_simple(a, b,
                                                                    **kw))),
                          f"tiled != simple: {fmt.name} {mode} kc={kc} "
                          f"{label}")
                    for neg in (False, True):
                        fused = pg.posit_gemm(a, b, negate=neg, **kw)
                        check(torch.equal(fused, pg.posit_gemm_simple(
                            a, b, negate=neg, **kw)) and torch.equal(
                                fused, pg.encode_posit_f32_plain(
                                    -got if neg else got, fmt)),
                              f"fused tiled != simple / encode(± own f32): "
                              f"{fmt.name} {mode} kc={kc} neg={neg} {label}")
                    compared += 3
        say(f"[identity] {fmt.name}: tiled == simple bit for bit on "
            f"{len(cases)} operand pairs x 2 modes x kc 16/48/128 (f32 and "
            "fused ±encode == encode of own f32)")
    return compared


class StageTimer:
    """Wall time by stage of the posit path: wraps the functions the
    drivers call (panels, trsm, GEMM, solves), synchronising around each
    call so the time lands on the stage that queued the work."""

    STAGES = {"panel": [("decomp", "getf2"), ("decomp", "potf2")],
              "trsm": [("decomp", "rtrsm_left_lower"),
                       ("decomp", "rtrsm_right_lowerT")],
              "gemm": [("decomp", "rgemm")],
              "solve": [("solve", "rgetrs"), ("solve", "rpotrs")]}

    def __init__(self):
        from repro_torch.lapack import decomp, solve
        self.mods = {"decomp": decomp, "solve": solve}
        self.secs = {}
        self.saved = []

    def __enter__(self):
        import torch
        for stage, targets in self.STAGES.items():
            self.secs[stage] = 0.0
            for mod_name, fn_name in targets:
                mod = self.mods[mod_name]
                fn = getattr(mod, fn_name)
                self.saved.append((mod, fn_name, fn))

                def timed(*a, _fn=fn, _stage=stage, **kw):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = _fn(*a, **kw)
                    torch.cuda.synchronize()
                    self.secs[_stage] += time.perf_counter() - t0
                    return out
                setattr(mod, fn_name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def run_study(cfg, backend, dev, timed=False):
    import torch
    from repro_torch.lapack.error_eval import backward_error_study
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if timed:
        with StageTimer() as st:
            res = backward_error_study(gemm_backend=backend, device=dev,
                                       **cfg)
        stages = dict(st.secs)
    else:
        res = backward_error_study(gemm_backend=backend, device=dev, **cfg)
        stages = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if stages is not None:
        stages["other"] = wall - sum(stages.values())
    return res, wall, stages


def phase_main_path(dev, smi):
    """The §5.1 path at full size, every trailing update on the kernel.
    The launch counts are read right after the two studies: they are the
    main path's own."""
    import math
    from repro_torch.kernels import posit_gemm as pg

    report = {}
    pg.reset_launch_counts()
    for cfg in (MAIN_LU, MAIN_CHOL):
        before = pg.launch_counts()
        res, wall, stages = run_study(cfg, "pallas_split3", dev, timed=True)
        after = pg.launch_counts()
        launches = after["posit_gemm_f32"] - before["posit_gemm_f32"]
        prepass = after["decode_planes"] - before["decode_planes"]
        expect = math.ceil(cfg["n"] / cfg["nb"]) - 1
        check(launches == prepass == expect,
              f"{cfg['algo']} n={cfg['n']}: GEMM kernel launched {launches} "
              f"times and the pre-pass {prepass}, expected {expect} each "
              "(one per trailing update)")
        check(math.isfinite(res.e_posit) and res.e_posit > 0,
              f"{cfg['algo']}: e_posit {res.e_posit}")
        say(f"[main] {cfg['algo']} n={cfg['n']} nb={cfg['nb']} "
            f"pallas_split3: e_posit {res.e_posit!r} e_binary32 "
            f"{res.e_binary32!r} digits {res.digits!r}; GEMM kernel "
            f"launches {launches}; wall {wall:.2f} s "
            + " ".join(f"{k} {v:.2f} s" for k, v in stages.items())
            + f" [{smi}]")
        report[cfg["algo"]] = dict(n=cfg["n"], nb=cfg["nb"],
                                   e_posit=res.e_posit,
                                   e_binary32=res.e_binary32,
                                   digits=res.digits, wall_s=wall,
                                   stages_s=stages, gemm_launches=launches)
    counts = pg.launch_counts()
    say(f"[main] launches on the main path: {json.dumps(counts)}")
    check(counts["posit_gemm_f32_simple"] == counts["posit_gemm_simple"] == 0,
          "the simple kernel was launched on the main path")
    return report, counts


def phase_fused_rgemm(dev):
    """rgemm's fused-encode form (alpha=-1, beta=0), which the studies do
    not take, through the user entry point at the LU's first
    trailing-update shape: one posit_gemm launch, no other, and the words
    of encode(-kernel f32 output)."""
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import P32E2
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.kernels.ops import rgemm
    from repro_torch.lapack.error_eval import make_general
    a_p = posit.from_float64(
        torch.from_numpy(make_general(MAIN_LU["n"], 1.0)).to(dev), P32E2)
    nb = MAIN_LU["nb"]
    a, b = a_p[nb:, :nb], a_p[:nb, nb:]
    pg.reset_launch_counts()
    fused = rgemm(a, b, alpha=-1.0, backend="pallas_split3")
    counts = pg.launch_counts()
    want = {name: int(name in ("posit_gemm", "decode_planes"))
            for name in counts}
    check(counts == want, f"fused rgemm launched {counts}, expected {want}")
    check(torch.equal(fused,
                      pg.encode_posit_f32_plain(-pg.posit_gemm_f32(a, b))),
          "fused rgemm != encode(-posit_gemm_f32)")
    check(not bool(posit.is_nar(fused).any()), "fused rgemm produced NaR")
    say(f"[fused] rgemm alpha=-1 beta=0 {tuple(a.shape)}@{tuple(b.shape)}: "
        "one pre-pass and one posit_gemm launch, words == encode(-kernel "
        "f32 output)")


def phase_reference_backend(dev, report):
    """The same studies with the f64 xla_quire backend (no kernel): the
    kernel's e_posit must lie within 0.5 decimal digits."""
    import math
    for cfg in (MAIN_LU, MAIN_CHOL):
        res, wall, _ = run_study(cfg, "xla_quire", dev)
        mine = report[cfg["algo"]]["e_posit"]
        gap = abs(math.log10(mine / res.e_posit))
        check(gap < 0.5, f"{cfg['algo']}: e_posit {mine} vs xla_quire "
              f"{res.e_posit}: {gap:.3f} digits apart (limit 0.5)")
        say(f"[main] {cfg['algo']} n={cfg['n']} xla_quire: e_posit "
            f"{res.e_posit!r} (kernel path {gap:.4f} digits away); wall "
            f"{wall:.2f} s")
        report[cfg["algo"]]["xla_quire_e_posit"] = res.e_posit
        report[cfg["algo"]]["xla_quire_wall_s"] = wall


def phase_word_parity(dev):
    """faithful at n=128: the card's e_posit equals the CPU's, bit for
    bit (integer and separately-rounded f64 ops only)."""
    from repro_torch.lapack.error_eval import backward_error_study
    for algo in ("lu", "cholesky"):
        g = backward_error_study(128, 1.0, algo, gemm_backend="faithful",
                                 device=dev)
        c = backward_error_study(128, 1.0, algo, gemm_backend="faithful",
                                 device="cpu")
        check(g.e_posit == c.e_posit,
              f"{algo} faithful n=128: e_posit GPU {g.e_posit!r} != CPU "
              f"{c.e_posit!r}")
        say(f"[parity] {algo} n=128 faithful: e_posit {g.e_posit!r} "
            "bit-identical on GPU and CPU")


def interleaved_ms(first, second, reps: int = 20):
    """Device times of two functions in turns (first, second, second,
    first; ``graph_ms`` each): (first's mean, second's mean, all four)."""
    t = [graph_ms(f, reps) for f in (first, second, second, first)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def host_ms(fn, reps: int):
    """Host-clock ms of synchronised calls after one warm-up: (mean, min)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / reps, min(times)


def phase_timings(dev, worst, smi):
    """At the LU's first trailing-update shape: the tiled kernel against
    the simple one (interleaved), in p32e2 and p16e1, both modes, both
    output forms; the pre-pass alone; the f32 and f64 torch.matmul
    yardsticks; the whole rgemm(alpha=-1, beta=1) call; plain versions and
    bounds; the elementwise codec kernels."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import P16E1, P32E2
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.kernels.ops import rgemm
    import torch_inputs as ti
    flops_rate, bytes_rate = PEAK_FP32_FLOPS, PEAK_BYTES_PER_S
    rng = np.random.default_rng(23)
    m, k, n = TIMED_SHAPE
    gemm_bytes = 4.0 * (m * k + k * n + m * n)
    rows, grid, extra = {}, [], {}
    for fmt in (P32E2, P16E1):
        a = ti.posits(rng, (m, k), -4, 4, fmt, dev)
        b = ti.posits(rng, (k, n), -4, 4, fmt, dev)
        # 3 products (2 without lo planes) of 2 flops per (m, k, n)
        flops = (6.0 if fmt.nbits > 16 else 2.0) * m * k * n
        bound_ms = max(flops / flops_rate, gemm_bytes / bytes_rate) * 1e3
        for mode in pg.MODES:
            for form in ("f32", "fused"):
                kw = dict(mode=mode, fmt=fmt)
                if form == "f32":
                    def tiled():
                        return pg.posit_gemm_f32(a, b, **kw)

                    def simple():
                        return pg.posit_gemm_f32_simple(a, b, **kw)
                else:
                    def tiled():
                        return pg.posit_gemm(a, b, negate=True, **kw)

                    def simple():
                        return pg.posit_gemm_simple(a, b, negate=True, **kw)
                simple_ms, tiled_ms, raw = interleaved_ms(simple, tiled)
                grid.append(dict(fmt=fmt.name, mode=mode, form=form,
                                 tiled_ms=tiled_ms, simple_ms=simple_ms,
                                 interleaved_ms=raw, bound_ms=bound_ms))
                say(f"[time] {fmt.name} {mode:11s} {form:5s} "
                    f"{(m, k, n)}: tiled {tiled_ms:.4f} ms, simple "
                    f"{simple_ms:.4f} ms (simple, tiled, tiled, simple: "
                    + ", ".join(f"{t:.4f}" for t in raw)
                    + f"), {simple_ms / tiled_ms:.2f}x; bound "
                    f"{bound_ms:.4f} ms, tiled at "
                    f"{100 * bound_ms / tiled_ms:.1f} % of it, "
                    f"{flops / tiled_ms / 1e9:.2f} TFLOP/s [{smi}]")
        prepass_ms = graph_ms(lambda: pg.decode_planes(a, b, fmt), 20)
        prepass_call_ms = cuda_ms(lambda: pg.decode_planes(a, b, fmt), 20)
        ah, al = pg.decode_split_f32_plain(a, fmt)
        bh, bl = pg.decode_split_f32_plain(b, fmt)
        a32, b32 = ah + al, bh + bl
        a64, b64 = posit.to_float64(a, fmt), posit.to_float64(b, fmt)
        f32_ms = cuda_ms(lambda: torch.matmul(a32, b32), 20)
        f64_ms = cuda_ms(lambda: torch.matmul(a64, b64), 20)
        extra[fmt.name] = dict(prepass_ms=prepass_ms,
                               prepass_call_ms=prepass_call_ms,
                               matmul_f32_ms=f32_ms, matmul_f64_ms=f64_ms)
        say(f"[time] {fmt.name} decode pre-pass {prepass_ms:.4f} ms on the "
            f"device ({prepass_call_ms:.4f} ms a call from Python, launch "
            "overhead included); "
            f"torch.matmul f32 on hi + lo {f32_ms:.4f} ms; torch.matmul f64 "
            f"on the decoded values (xla_quire's product) {f64_ms:.4f} ms "
            f"[{smi}]")
        if fmt is not P32E2:
            continue
        # The main path's rows: p32e2, split3.
        k_pad, lda, ldb = pg.plane_layout(m, k, n)
        by_form = {(g["form"]): g for g in grid
                   if g["fmt"] == fmt.name and g["mode"] == "split3"}
        for name, fn, plain, form, simple in (
                ("posit_gemm_f32", lambda: pg.posit_gemm_f32(a, b),
                 lambda: pg.posit_gemm_f32_plain(a, b), "f32", False),
                ("posit_gemm", lambda: pg.posit_gemm(a, b, negate=True),
                 lambda: pg.posit_gemm_plain(a, b, negate=True), "fused",
                 False),
                ("posit_gemm_f32_simple",
                 lambda: pg.posit_gemm_f32_simple(a, b),
                 lambda: pg.posit_gemm_f32_plain(a, b), "f32", True),
                ("posit_gemm_simple",
                 lambda: pg.posit_gemm_simple(a, b, negate=True),
                 lambda: pg.posit_gemm_plain(a, b, negate=True), "fused",
                 True)):
            plain_ms = cuda_ms(plain, 5)
            out, ref = fn(), plain()
            if form == "fused":
                err = float((posit.to_float64(out) - posit.to_float64(ref))
                            .abs().max())
            else:
                err = float((out - ref).abs().max())
            g = by_form[form]
            rows[name] = dict(name=name,
                              ms=g["simple_ms" if simple else "tiled_ms"],
                              plain_ms=plain_ms, bound_ms=g["bound_ms"],
                              bound_by="operations", library_ms=f32_ms,
                              library_f64_ms=f64_ms, max_abs_err=err,
                              shape=[m, k, n])
        planes, ref = pg.decode_planes(a, b), pg.decode_planes_plain(a, b)
        check(all(same_bits(p, r) for p, r in zip(planes, ref)),
              "decode_planes != plain at the timed size")
        planes_err = max(float((p.double() - r.double()).nan_to_num(0.0)
                               .abs().max()) for p, r in zip(planes, ref))
        rows["decode_planes"] = dict(
            name="decode_planes", ms=prepass_ms,
            plain_ms=cuda_ms(lambda: pg.decode_planes_plain(a, b), 5),
            # one read of A and B, one write of the four planes
            bound_ms=(4.0 * (m * k + k * n) + 8.0 * k_pad * (lda + ldb))
            / bytes_rate * 1e3, bound_by="bytes", library_ms=None,
            max_abs_err=planes_err, shape=[m, k, n])
        # The trailing update as the studies issue it: alpha=-1, beta=1.
        c = ti.posits(rng, (m, n), -2, 2, fmt, dev)
        rgemm_ms, rgemm_min = host_ms(lambda: rgemm(
            a, b, c, alpha=-1.0, beta=1.0, backend="pallas_split3"), 20)
        gemm_host_ms, gemm_host_min = host_ms(
            lambda: pg.posit_gemm_f32(a, b), 20)
        extra["rgemm_trailing_update"] = dict(
            rgemm_host_ms=rgemm_ms, rgemm_host_min_ms=rgemm_min,
            gemm_host_ms=gemm_host_ms, gemm_host_min_ms=gemm_host_min,
            epilogue_host_ms=rgemm_ms - gemm_host_ms)
        say(f"[time] rgemm(alpha=-1, beta=1, pallas_split3) {(m, k, n)}: "
            f"{rgemm_ms:.4f} ms (min {rgemm_min:.4f}) on the host clock, of "
            f"which the pre-pass + kernel call {gemm_host_ms:.4f} ms (min "
            f"{gemm_host_min:.4f}); the f64 beta epilogue "
            f"{rgemm_ms - gemm_host_ms:.4f} ms [{smi}]")
        say(f"[time] bound with the cross terms on tensor cores (2*MKN "
            f"FFMA at {flops_rate / 1e12:.0f} TFLOP/s): "
            f"{2.0 * m * k * n / flops_rate * 1e3:.4f} ms")

    words = torch.from_numpy(ti.words(P32E2, rng, 1 << 24)).to(dev)
    nw = words.numel()
    vals = torch.randn(nw, device=dev) * 100.0
    for name, fn, plain, nbytes in (
            ("decode_split_f32", lambda: pg.decode_split_f32(words),
             lambda: pg.decode_split_f32_plain(words), 12.0 * nw),
            ("encode_posit_f32", lambda: pg.encode_posit_f32(vals),
             lambda: pg.encode_posit_f32_plain(vals), 8.0 * nw)):
        ms = graph_ms(fn, 20)
        plain_ms = cuda_ms(plain, 5)
        out, ref = fn(), plain()
        if isinstance(out, tuple):               # (hi, lo) f32 planes
            ok = all(same_bits(o, r) for o, r in zip(out, ref))
            err = max(float((o.double() - r.double()).nan_to_num(0.0)
                            .abs().max()) for o, r in zip(out, ref))
        else:                                    # posit words: value error
            ok = same_bits(out, ref)
            err = float((posit.to_float64(out) - posit.to_float64(ref))
                        .nan_to_num(0.0).abs().max())
        check(ok, f"{name}: kernel != plain at the timed size")
        rows[name] = dict(name=name, ms=ms, plain_ms=plain_ms,
                          bound_ms=nbytes / bytes_rate * 1e3,
                          bound_by="bytes", library_ms=None, max_abs_err=err,
                          shape=[nw])
    for r in rows.values():
        lib = r["library_ms"]
        say(f"[time] {r['name']:21s} shape {r['shape']}: kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
            f"{lib if lib is None else round(lib, 4)} ms, max|kernel-plain| "
            f"{r['max_abs_err']:.3e} [{smi}]")
    worst_gemm = max(worst.values())
    say(f"[time] worst max|kernel-plain| over the GEMM check shapes: "
        f"{worst_gemm:.3e}")
    return rows, grid, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full result as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | bound rates: H100 SXM data sheet, "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s FP32, "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s")

    t_start = time.perf_counter()
    build_s, ptxas = phase_build()
    phase_plain_codec(dev)
    phase_codec_kernels(dev)
    worst = phase_gemm(dev)
    compared = phase_bit_identity(dev)
    report, counts = phase_main_path(dev, smi)
    phase_fused_rgemm(dev)
    phase_reference_backend(dev, report)
    phase_word_parity(dev)
    rows, grid, extra = phase_timings(dev, worst, smi)

    for name in ON_MAIN_PATH:
        check(counts[name] > 0, f"{name} was not launched on the main path")
    src = "src/repro_torch/kernels/csrc/"
    kernels = [dict(name=name, route="cuda", source=src + SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    on_main_path=name in ON_MAIN_PATH)
               for name, r in rows.items()]
    total_s = time.perf_counter() - t_start
    say(f"[done] all phases passed in {total_s:.1f} s (build {build_s:.1f} s)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=smi, kind=kind,
                 peaks=dict(fp32_flops=PEAK_FP32_FLOPS,
                            bytes_per_s=PEAK_BYTES_PER_S),
                 build_s=build_s, ptxas=ptxas, total_s=total_s,
                 identity_comparisons=compared, studies=report,
                 kernels=kernels, timings=list(rows.values()),
                 gemm_grid=grid, gemm_extra=extra), indent=1))
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
