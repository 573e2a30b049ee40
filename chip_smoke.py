#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out RESULT.json]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/``
(checking that the main path's GEMM kernels do not spill), checks every
kernel against its plain PyTorch version (the encode kernel on all 2^32
f32 bit patterns in each format) and the tiled GEMM kernel against
the first (simple) kernel bit for bit, drives the paper's §5.1 path
(posit LU and Cholesky with every trailing update on the decode pre-pass
and the tiled GEMM kernel, triangular solves, backward error against
binary32) at full size, holds the quire (``quire_dot``, ``quire_gemm``,
``rgemm(backend="quire_exact")``, ``q_to_posit``) on the card to its CPU
words, drives the quire-exact refinement path (``refinement_study`` LU
and Cholesky, ``mixed_precision_study`` with its p16e1 factorization, the
mixed-precision acceptance cells) with every trailing update on the
kernel, holds the four refinement drivers' pair words on the card to the
CPU's, drives Householder QR and least squares (``rgels`` at the
reference's QR benchmark shape, ``least_squares_study`` on the paper
tables' sigma grid; the block reflector's V^T C and T^T W on the fused
kernel, C -= V W on the f32 one), the batched §5.1 ensemble
(``backward_error_ensemble``: one batched kernel launch per trailing
update for the whole sigma x seed grid), holds QR words on the card to
the CPU's and the batched launch to per-matrix launches, drives the
observability layer (``[obs]``: records on the card equal to the CPU's,
a collector changing no word and no launch, a Chrome trace read back;
``[golden]``: ``golden_zone_study`` on Fig. 7's sigma grid) and the exact
ABFT (``[ft]``: the protected LU, Cholesky and QR on the kernel,
fault-free and with a seeded fault; ``[ft soak]``: five seeded faults at
every site; ``[guarded]``: the mp -> ir -> plain ladder, card vs CPU),
drives the distributed path (``[dist gemm]``, ``[dist lu]``, ``[dist
chol]``, ``[dist ir]``, ``[dist ft]``: four spawned ranks on the card as
a 2x2 grid, gloo collectives on host copies, every rank's product on the
kernel, the words held to the single-device words, the collective
bytes to the plans and rank 0's kernel GEMMs at the grid's shapes to the
plain version; ``[dist nccl]``: one rank on NCCL), drives the LM
serving path (``[models]``: each model family's tiny config on the card
against the CPU; ``[serve]``: qwen2-0.5b at its published widths with
p16e1 weights, every linear of every decode step and prefill token on the
skinny GEMM kernel, a p16e1 paged KV cache, a seeded trace replayed
batched and sequentially with equal tokens, the first decode step's
GEMMs equal to the tiled kernel's chain bit for bit and held to the plain
version, the skinny kernel against the tiled chain at several rows and
timed against it), drives the training path (``[codec]``: the
policy's codec, ``encode_tensor`` / ``decode_tensor``, on every f32
pattern and every word of every format against the plain codec;
``[train]``: qwen2-0.5b at its published widths through the training
CLI's ``run``, 8 steps at posit32 with every linear's weights and
activations through ``quantize`` on the encode and decode kernels, the
first step's codec calls held to the plain codec, and 4 steps at
bf16_opt16 with p16e1 AdamW moments on the same kernels; ``[train
parity]``: the tiny configs' losses, gradients and train steps card vs
CPU; ``[train resume]``: a killed and resumed run against a straight
one; ``[train dp]``: two ranks on the card, the p16e1-compressed
gradient sum against one process; ``[train sharded]``: the sharded
``make_train_step`` of qwen2-0.5b at its published widths on a 2x2
("data", "model") mesh of four ranks sharing the card and on one NCCL
rank, against one process and the dry run's collective plan, and the
expert-parallel MoE against the local path), runs the port's ten
example scripts (``[examples]``: ``examples/torch_<name>.py`` through
their ``main()``, each one's launches counted and its claims checked,
the quickstart's kernel GEMM held to the plain version), and times the
kernels: the tiled kernel and the simple one interleaved, the pre-pass,
the f32 and f64 ``torch.matmul`` yardsticks, the whole ``rgemm``
trailing-update call and its ``quire_exact`` form, and the batched
launch against per-matrix ones.  The scripts and the check-only
``[parity]``, ``[lstsq]``, ``[ft soak]`` and ``[guarded]`` run in three
child processes beside ``[refine]`` and ``[mp]``.
Every phase raises on a failed check, so the script exits non-zero unless
all of them pass.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it carries
the card's name and power limit as ``nvidia-smi`` reports them, and the
line before that the per-kernel JSON (``launches``: on the kernel's own
path, the first of ``ON_PATH`` that launches it (``launches_path``; the
§5.1 main path for the GEMM and the pre-pass, QR for the fused GEMM,
serving for the skinny GEMM and the encode kernel, training for the
decode kernel);
``launches_by_path``: on the §5.1 main path and on the refinement, QR, ensemble,
golden-zone, protected (``ft``), distributed (``dist``, every rank's),
serving (``serve``: both replays of ``[serve]``), training
(``train``: both runs of ``[train]``), sharded training
(``train_sharded``: the 2x2 ranks' steps, summed) and examples
(``examples``: the ten scripts' ``main()``s, summed) paths, each
counted from zero around its own run; ``on_main_path``:
launched on one of them; error, times and bound).

It imports nothing of JAX or of the JAX package ``repro``, and needs one
CUDA device; without one it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import shutil
import subprocess
import sys
import tempfile
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
# The refinement path: quire refinement of an LU and of a Cholesky, and
# the mixed-precision study (p16e1 factor, p32e2 refinement).  Their quire
# sweeps are host-bound, a few hundred small launches a row (PERF.md §5),
# so the cells are cut for the time limit: the LU from the main cell's
# n=4096 to 1024 (at 2048 the whole script took 1017 s of its 1200 s on
# an H100), the Cholesky and the mixed study from 1024 to 512 once the
# QR and ensemble phases came in (814.6 s with them at 1024 on a fast
# host, where the slowest host seen runs the host-bound phases ~1.5x
# slower), and the mixed study from 512 to 256 once the serving phases
# came in (74.70 s at 512; the whole script took 1067.6 s on a slow host).
REFINE_LU = dict(n=1024, sigma=1.0, algo="lu", nb=64, iters=3)
REFINE_CHOL = dict(n=512, sigma=1.0, algo="cholesky", nb=64, iters=3)
MIXED = dict(n=256, sigma=1.0, algo="lu", nb=64)
# The reference's mixed-precision acceptance cells
# (benchmarks/bench_formats.py bench_mixed, tests/test_formats.py).
MP_CELLS = (("lu", 64, 1e-2), ("lu", 64, 1.0), ("lu", 64, 1e2),
            ("cholesky", 48, 1.0))
QUIRE_SHAPES = ((17, 23, 9), (65, 130, 33), (256, 64, 256))
# The refinement drivers held to the CPU's pair words: (driver, n); n=64
# (two panels at the drivers' nb=32) for the time limit, as above.
PARITY_DRIVERS = (("rgesv_ir", 64), ("rposv_ir", 64), ("rgesv_mp", 64),
                  ("rposv_mp", 48))
# Householder QR at the reference's QR benchmark shape
# (benchmarks/bench_qr.py:104-106: n = 256, m = n + n // 2, nb = 32), and
# the least-squares study on the paper tables' grid
# (benchmarks/paper_tables.py:170-186), gated as benchmarks/bench_qr.py
# gates it.
QR_CELL = dict(m=384, n=256, nb=32)
LSTSQ = dict(m=96, n=64, nb=32, sigmas=(1e-2, 1.0, 1e2))
QR_PARITY = dict(m=40, n=24, nb=8)
# The batched §5.1 ensemble on Fig. 7's sigma grid x two seeds.  Cholesky
# runs at n=512: its panels are the costliest launch sequence.
ENSEMBLE_SIGMAS = (1e-2, 1.0, 1e2, 1e4, 1e6)
ENSEMBLE_SEEDS = (0, 1)
ENSEMBLE_CELLS = (dict(n=1024, algo="lu", nb=64),
                  dict(n=512, algo="cholesky", nb=64))
# The ensemble LU's first trailing update, (10 x 960, 64, 960).
BATCH_SHAPE = (len(ENSEMBLE_SIGMAS) * len(ENSEMBLE_SEEDS), 960, 64, 960)
# The QR path's GEMM forms at the [qr] cell's first block: V^T C over three
# K chunks (K = m - j up to 384 > kc = 128), the same against a vector
# (rormqr, N=1), and C -= V W.
QR_GEMM_SHAPES = ((32, 384, 224), (32, 384, 1), (352, 32, 224))
GEMM_SHAPES = ((65, 17, 130), (33, 65, 9), (4032, 64, 4032),
               (64, 64, 64)) + QR_GEMM_SHAPES
# Where the lo planes decide the product, also at the QR forms' shapes (the
# N=1 one has too few outputs for the hi-only control to miss reliably).
LO_PLANE_SHAPES = ((32, 384, 224), (352, 32, 224))
# e_qr of the JAX package's rgels at the [qr] cell with pallas_split3
# (tools/qr_reference_numbers.py prints it); the port's kernel must land
# within E_QR_DIGITS of it.
E_QR_REFERENCE = 4.07195566435249e-07
E_QR_DIGITS = 0.05
IDENTITY_SHAPES = ((65, 17, 130), (33, 65, 9), (257, 300, 129),
                   (4032, 64, 4032))
TIMED_SHAPE = (4032, 64, 4032)      # the n=4096 LU's first trailing update
ENCODE_CHUNK = 1 << 26              # f32 patterns a launch in [kernels]
MIXED_SHAPE = (960, 64, 960)        # the n=1024 LU studies' first update
# The observability and fault-tolerance paths.  [obs]: the §5.1 LU and
# Cholesky with faithful under a collector, GPU vs CPU, and the split3 LU
# observed vs unobserved.  [golden]: golden_zone_study on Fig. 7's sigma
# grid; n=256, not the main cell's 4096, because each cell is a refinement
# LU whose quire sweeps are host-bound (the n=1024 refinement LU took 45 s;
# the five cells at n=512 took 130.64 s, 109.39 s of it quire sweeps: cut
# to 256 to make room for [models] and [serve] in the time limit).
# [ft]: the protected drivers at the sizes their checksums were sized for;
# [ft soak]: benchmarks/bench_ft.py's soak (five seeds a site, n=96,
# nb=32); [guarded]: the ladder's three cases of tests/test_ft.py:249-293,
# then the benign one at n=512 on the kernel.
OBS_PARITY_N = 128
OBS_LU = dict(n=1024, nb=64)
GOLDEN = dict(n=256, sigmas=(1e-2, 1.0, 1e2, 1e4, 1e6), algo="lu", nb=64,
              iters=3)
FT_CELLS = (("rgetrf", dict(n=1024, nb=64)), ("rpotrf", dict(n=512, nb=64)),
            ("rgeqrf", dict(m=192, n=128, nb=32)))
SOAK = dict(n=96, nb=32, seeds=5)
GUARDED_SMALL = dict(n=64, nb=16)
GUARDED_BIG = dict(n=512, nb=64)
# The distributed path (repro_torch.dist): four ranks on the one card as a
# 2x2 grid, their collectives over gloo on host copies, every rank's
# product on the kernel (pallas_split3, nb=64); inputs from the §5.1
# generators (seed 0, sigma=1).  [dist gemm]: pdgemm at DIST_GEMM and the
# quire k_split schedule at a shape that does not divide by 64; [dist lu]:
# cut from [main]'s n=4096 to 2048 (the script's time limit), held to the
# single-device LU; [dist chol]: [main]'s n, held to [main]'s words;
# [dist ir]: the refinement drivers, cut from the [refine] cells' n to 128
# because every rank runs the host-bound quire sweeps again (5.5-10.4 ms a
# row); [dist ft]: the protected drivers at the [ft] cells' n, a panel
# fault on rank 3, a kill after step DIST_FT["stop_after"] and its resume,
# and pdgemm_ft with a fault in each operand on rank 1; [dist nccl]: one
# rank on NCCL with its tensors on the card, pdgemm and p_rgetrf at
# [dist ft]'s sizes.
DIST_GRID = (2, 2)
DIST_NB = 64
DIST_GEMM = (2048, 2048, 2048)
DIST_KSPLIT = (480, 416, 352)
DIST_LU = 2048
DIST_CHOL = MAIN_CHOL["n"]
DIST_IR = dict(n=128, iters=3)
DIST_FT = dict(lu=1024, chol=512, gemm=1024, stop_after=2, panel_dev=3,
               gemm_dev=1)
# The LM serving path (repro_torch.models, repro_torch.serving).  [models]:
# each family's tiny config (the archs of tests/test_serving.py) at
# policy="f32", the card against the CPU from the same seeded weights.
# [serve]: qwen2-0.5b at its published widths (24 layers, d_model 896,
# 14/2 heads of 64, d_ff 4864, vocab 151936, tied embeddings), seeded
# random weights at the reference's init scales, quantized to p16e1 with
# the kernel backend (168 linears a decode step on the GEMM kernel), a
# p16e1 paged KV pool, and the engine of benchmarks/bench_serve.py
# (page_size 16, max_seq 128) at decode width 4 on a seeded trace.
MODEL_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-780m",
               "zamba2-2.7b", "gemma3-12b", "whisper-tiny", "internvl2-26b")
MODEL_RTOL = 1e-5            # f32 logits, card vs CPU (library sum order)
MODEL_QUANT_RTOL = 1e-3      # p16e1 kernel backend: activation words may flip
SERVE_ARCH = "qwen2-0.5b"
SERVE_ENGINE = dict(max_batch=4, page_size=16, max_seq=128)
SERVE_TRAFFIC = dict(n_requests=6, mean_plen=24, mean_new=12,
                     arrival_rate=0.5, seed=0)
# Rows at which [serve] holds the skinny kernel to the tiled chain bit for
# bit on the layer-0 leaves (and at SKINNY_M_MAX), and at which it times
# the two in turns: the measurements the dispatch threshold is chosen from.
SKINNY_IDENTITY_MS = (1, 2, 3, 4, 16)
SKINNY_SWEEP_MS = (1, 4, 16, 64)
SKINNY_ROW_SHAPE = (4, 4864, 896)   # the kernels line's row: the slowest
# The tiled kernel's instantiations the studies run (split3; the last
# template flag is BATCHED): p32e2 with one K chunk, f32 out and fused
# encode; p32e2 fused over several chunks (QR's V^T C, K = m - j > 128);
# p16e1 f32 (the mixed study) and fused (rgels_mp's QR); the batched p32e2
# f32 form (the ensemble's updates); p16e1 f32 over several chunks (the
# quantized linears above the skinny kernel's rows, bk=32); and the skinny
# kernel's p16e1 forms at M = 1 (prefill, sequential decode), 4 (decode at
# width 4) and 16 ([models]' prefill of 2 x 8 tokens).  ptxas must report
# them, and no spills in any.
MAIN_PATH_KERNELS = ("posit_gemm_kernel<32,2,0,1,0,0>",
                     "posit_gemm_kernel<32,2,0,1,1,0>",
                     "posit_gemm_kernel<32,2,0,0,1,0>",
                     "posit_gemm_kernel<16,1,0,1,0,0>",
                     "posit_gemm_kernel<16,1,0,1,1,0>",
                     "posit_gemm_kernel<32,2,0,1,0,1>",
                     "posit_gemm_kernel<16,1,0,0,0,0>",
                     "posit_gemm_skinny_kernel<16,1,1>",
                     "posit_gemm_skinny_kernel<16,1,4>",
                     "posit_gemm_skinny_kernel<16,1,16>")
SOURCES = {"posit_gemm_f32": "posit_gemm.cu", "posit_gemm": "posit_gemm.cu",
           "decode_planes": "posit_gemm.cu",
           "decode_split_f32": "posit_codec.cu",
           "encode_posit_f32": "posit_codec.cu",
           "posit_gemm_f32_simple": "posit_gemm_simple.cu",
           "posit_gemm_simple": "posit_gemm_simple.cu",
           "quant_gemm_f32": "posit_gemm_skinny.cu"}
REPLACES = {"posit_gemm_f32": "src/repro/kernels/posit_gemm.py:271",
            "posit_gemm": "src/repro/kernels/posit_gemm.py:271",
            "decode_planes": "src/repro/kernels/posit_gemm.py:211",
            "decode_split_f32": "src/repro/kernels/posit_gemm.py:88",
            "encode_posit_f32": "src/repro/kernels/posit_gemm.py:127",
            "posit_gemm_f32_simple": "src/repro/kernels/posit_gemm.py:271",
            "posit_gemm_simple": "src/repro/kernels/posit_gemm.py:271",
            "quant_gemm_f32": "src/repro/kernels/posit_gemm.py:271"}
# Kernels each path must launch (counted from zero around it): the §5.1
# main path and the paths of later slices.
ON_PATH = {"main": ("posit_gemm_f32", "decode_planes"),
           "refine": ("posit_gemm_f32", "decode_planes"),
           "qr": ("posit_gemm_f32", "posit_gemm", "decode_planes"),
           "ensemble": ("posit_gemm_f32", "decode_planes"),
           "golden": ("posit_gemm_f32", "decode_planes"),
           "ft": ("posit_gemm_f32", "posit_gemm", "decode_planes"),
           "dist": ("posit_gemm_f32", "decode_planes"),
           "serve": ("quant_gemm_f32", "encode_posit_f32"),
           "train": ("encode_posit_f32", "decode_split_f32"),
           "train_sharded": ("encode_posit_f32", "decode_split_f32"),
           "examples": ("posit_gemm", "decode_planes", "encode_posit_f32",
                        "decode_split_f32")}

# [train]: qwen2-0.5b at its published widths through launch.train.run,
# TRAIN_STEPS steps per policy at TRAIN_RUN; [train parity]: the tiny
# configs card vs CPU; [train resume]: the smoke config, straight vs
# resumed; [train dp]: two ranks on the card, the smoke config.
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_RUN = dict(batch=4, seq=64, lr=1e-3)
TRAIN_STEPS = {"posit32": 8, "bf16_opt16": 4}
TRAIN_PARITY_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-780m")
TRAIN_RTOL = 1e-5            # f32 compute, card vs CPU (library sum order)
TRAIN_BF16_RTOL = 2e-2       # bf16 compute: each op's bf16 rounding
TRAIN_RESUME = dict(steps=6, batch=2, seq=16, policy="bf16_opt16")
TRAIN_DP = dict(arch="qwen2-0.5b", policy="posit_dp", steps=3, batch=4,
                seq=16, lr=1e-3, seed=0)
TRAIN_DP_RTOL = 1e-3         # the p16e1 wire's noise (8e-5 on the CPU)
# [train sharded]: qwen2-0.5b at its published widths (vocab-parallel
# embedding: 75968 table rows a rank) on a 2x2 ("data", "model") mesh of
# four ranks sharing the card (gloo on host copies), then on one NCCL rank
# (a 1x1 mesh); the granite-moe smoke config's expert parallelism on the
# same 2x2 ranks.
TRAIN_SHARDED = dict(arch="qwen2-0.5b", policy="posit32", batch=4, seq=64,
                     steps=2, lr=1e-3, seed=0)
TRAIN_SHARDED_RTOL = 1e-5    # f32 compute: the sharded sum orders
TRAIN_SHARDED_CODEC = 336    # 168 linears' weights and activations a step
EP_RTOL, EP_GRAD_RTOL = 1e-6, 1e-5

# [examples]: the port's example scripts, examples/torch_<name>.py, through
# main() at the reference's sizes but for three cuts (PERF.md §4): the
# argv each gets (a trace file and a checkpoint directory added in a
# temporary directory), and the kernels each must launch on the card.
EXAMPLE_ARGS = {
    "quickstart": [],
    "cholesky_lu_accuracy": [],
    "quire_refine": ["--n", "64"],     # N 256: ~14 s a refinement LU's sweeps
    "observe_solve": [],
    "fault_tolerant_solve": [],
    "dist_solve": ["--p", "2", "--q", "2"],    # 2x4: eight ranks on one card
    "serve_posit": [],
    "serve_batched": [],
    "posit_training": [],
    "train_100m": ["--steps", "10"],    # 150 steps at its full widths
}
# Two of the three child processes that run beside [refine] and [mp] in
# main() (187 s on a host where the children took 113-120 s of scripts,
# ~50 s of [guarded], ~34 s of [ft soak], ~160 s of [parity] + [lstsq])
# run the scripts, the first then [guarded], the second [ft soak].
EXAMPLE_GROUPS = (("quire_refine", "observe_solve", "cholesky_lu_accuracy"),
                  ("dist_solve", "fault_tolerant_solve", "quickstart",
                   "posit_training", "serve_posit", "train_100m",
                   "serve_batched"))
EXAMPLE_KERNELS = {"quickstart": ("posit_gemm", "decode_planes"),
                   "serve_posit": ("encode_posit_f32",),
                   "posit_training": ("encode_posit_f32", "decode_split_f32")}


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
    kernel; the decode pre-pass, the tiled GEMM and the skinny GEMM must
    not spill in any instantiation, and the main path's must be among
    them."""
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
        if name.startswith(("posit_gemm_kernel<", "decode_planes_kernel<",
                            "posit_gemm_skinny_kernel<")):
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
    """Decode/encode elementwise kernels vs their plain versions; the
    encode on every f32 pattern; ``core.policy``'s codec (the training
    path's) on every f32 pattern and every word against the plain codec
    (returns the seconds of the encode kernel's check and of the codec's
    checks)."""
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
    return encode_exhaustive(dev)


def encode_exhaustive(dev):
    """Every f32 bit pattern (all 2^32, in chunks of ``ENCODE_CHUNK``)
    through the encode kernel with int32 words, equal to the plain
    version on the card, for each format; the narrow wire words (int16,
    int8) equal to the int32 words narrowed.  Returns its seconds (a few:
    the script's time limit has no room for minutes)."""
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import FORMATS
    from repro_torch.core.policy import encode_tensor, wire_dtype
    from repro_torch.kernels import posit_gemm as pg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy_s = 0.0
    for fmt in FORMATS.values():
        narrow = wire_dtype(fmt) if fmt.nbits <= 16 else None
        for c0 in range(0, 1 << 32, ENCODE_CHUNK):
            lo = c0 - (1 << 32) if c0 >= 1 << 31 else c0
            x = torch.arange(lo, lo + ENCODE_CHUNK, dtype=torch.int64,
                             device=dev).to(torch.int32).view(torch.float32)
            got = pg.encode_posit_f32(x, fmt)
            check(torch.equal(got, pg.encode_posit_f32_plain(x, fmt)),
                  f"encode kernel {fmt.name} != plain on the f32 patterns "
                  f"[{c0:#x}, {c0 + ENCODE_CHUNK:#x})")
            if narrow is not None:
                check(torch.equal(pg.encode_posit_f32(x, fmt,
                                                      out_dtype=narrow),
                                  got.to(narrow)),
                      f"encode kernel {fmt.name} {narrow} != its int32 "
                      f"words narrowed on [{c0:#x}, {c0 + ENCODE_CHUNK:#x})")
            # core.policy.encode_tensor (the kernel, straight into the wire
            # dtype) against the plain codec's from_float32_bits
            t1 = time.perf_counter()
            check(torch.equal(encode_tensor(x, fmt),
                              posit.from_float32_bits(x, fmt).to(
                                  wire_dtype(fmt))),
                  f"encode_tensor {fmt.name} != from_float32_bits on the f32 "
                  f"patterns [{c0:#x}, {c0 + ENCODE_CHUNK:#x})")
            torch.cuda.synchronize()
            policy_s += time.perf_counter() - t1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    say(f"[kernels] encode_posit on all 2^32 f32 patterns x 4 formats "
        "(p32e2, p16e1, p8e2, p8e0) bit-identical to the plain version on "
        "the card, and the int16/int8 wire words to the int32 words "
        f"narrowed, in {secs - policy_s:.2f} s (chunks of {ENCODE_CHUNK})")
    say(f"[codec] encode_tensor (the encode kernel into the wire dtype) on "
        "all 2^32 f32 patterns x 4 formats bit-identical to the plain "
        "codec's from_float32_bits on the card (-0, subnormals, inf and NaN "
        f"payloads included), in {policy_s:.2f} s")
    return secs, policy_s + decode_exhaustive(dev)


def decode_exhaustive(dev):
    """``core.policy.decode_tensor`` (the decode kernel's pair summed once,
    the tiny p32e2 words from their table) on every word of every format
    (all 2^32 p32e2 words in chunks of ``ENCODE_CHUNK``, all 2^16 p16e1 in
    their int16 wire dtype, all 2^8 of each 8-bit format in int8) against
    the plain codec's ``to_float32_bits``, bit for bit (NaN for NaR).
    Returns its seconds."""
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import FORMATS
    from repro_torch.core.policy import decode_tensor, wire_dtype
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fmt in FORMATS.values():
        n = 1 << fmt.nbits
        for c0 in range(0, n, ENCODE_CHUNK):
            lo = c0 - n // 2
            w = torch.arange(lo, lo + min(ENCODE_CHUNK, n), dtype=torch.int64,
                             device=dev).to(torch.int32)
            got = decode_tensor(w.to(wire_dtype(fmt)), fmt)
            check(dev_same_bits(got, posit.to_float32_bits(w, fmt)),
                  f"decode_tensor {fmt.name} != to_float32_bits on the words "
                  f"[{lo:#x}, {lo + min(ENCODE_CHUNK, n):#x})")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    say("[codec] decode_tensor (the decode kernel's hi + lo) on all 2^32 "
        "p32e2 words, all 2^16 p16e1 words (int16) and all 2^8 p8e2 / p8e0 "
        "words (int8) bit-identical to the plain codec's to_float32_bits on "
        f"the card (minpos, the 38 p32e2 words below 2^-103, maxpos, NaR), "
        f"in {secs:.2f} s")
    return secs


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
    for (m, k, n) in ti.LO_PLANE_SHAPES + LO_PLANE_SHAPES:
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
    drivers call (panels, trsm, GEMM, solves, the quire residual),
    synchronising around each call so the time lands on the stage that
    queued the work.  A solve called with ``quire=True`` is a "quire
    solve".  Around every ``rgemm`` of a factorization (the un-hooked
    ``_rgemm`` the bodies call) it also counts the GEMM kernel's
    launches, by posit format."""

    STAGES = {"panel": [("decomp", "getf2"), ("decomp", "potf2"),
                        ("qr", "geqr2")],
              "larft": [("qr", "larft")],
              "trsm": [("decomp", "rtrsm_left_lower"),
                       ("decomp", "rtrsm_right_lowerT")],
              "gemm": [("decomp", "_rgemm"), ("qr", "_rgemm")],
              "back-substitution": [("qr", "rtrsm_left_upper")],
              "solve": [("solve", "rgetrs"), ("solve", "rpotrs")],
              "quire residual": [("refine", "residual_quire")]}

    def __init__(self):
        from repro_torch.lapack import decomp, qr, refine, solve
        self.mods = {"decomp": decomp, "solve": solve, "refine": refine,
                     "qr": qr}
        self.secs = {stage: 0.0 for stage in
                     ("panel", "larft", "trsm", "gemm", "back-substitution",
                      "solve", "quire solve", "quire residual")}
        self.gemm = {}              # fmt -> rgemm calls and kernel launches
        self.saved = []

    def _count_gemm(self, fn, *a, **kw):
        from repro_torch.kernels import posit_gemm as pg
        before = pg.launch_counts()
        out = fn(*a, **kw)
        after = pg.launch_counts()
        row = self.gemm.setdefault(kw["fmt"].name, dict.fromkeys(
            ["rgemm_calls"] + list(after), 0))
        row["rgemm_calls"] += 1
        for name in after:
            row[name] += after[name] - before[name]
        return out

    def __enter__(self):
        import torch
        for stage, targets in self.STAGES.items():
            for mod_name, fn_name in targets:
                mod = self.mods[mod_name]
                fn = getattr(mod, fn_name)
                self.saved.append((mod, fn_name, fn))

                def timed(*a, _fn=fn, _stage=stage, **kw):
                    if _stage == "solve" and kw.get("quire"):
                        _stage = "quire solve"
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if _stage == "gemm":
                        out = self._count_gemm(_fn, *a, **kw)
                    else:
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


class GemmRecorder:
    """Keeps a copy of the operands and the output of every GEMM wrapper
    call made through ``kernels.ops`` (``rgemm``'s ``posit_gemm_f32`` and
    fused ``posit_gemm``; ``quant_matmul``'s ``quant_gemm_f32``, whose
    scale exponents and format go into the keywords), or of the first
    ``limit`` calls, so that a path's own GEMMs can be held to the plain
    version afterwards."""

    NAMES = ("posit_gemm_f32", "posit_gemm", "quant_gemm_f32")

    def __init__(self, limit=None):
        self.calls = []             # (name, a, b, keywords, output)
        self.limit = limit

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = {name: getattr(ops, name) for name in self.NAMES}
        for name, fn in self.saved.items():
            def recorded(a, b, *rest, _fn=fn, _name=name, **kw):
                out = _fn(a, b, *rest, **kw)
                if self.limit is None or len(self.calls) < self.limit:
                    if rest:                  # quant_gemm_f32(x, w, sexp, fmt)
                        kw = dict(kw, sexp=rest[0].clone(), fmt=rest[1])
                    self.calls.append((_name, a.clone(), b.clone(), kw,
                                       out.clone()))
                return out
            setattr(ops, name, recorded)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)
        return False


def check_path_gemms(path, calls):
    """Each recorded (2-D) GEMM of a path against its plain version on the
    same operands: the kernel's f32 output and the plain version's within
    sqrt(K)*8e-8 of the exact product (phase_gemm's bound), the fused
    words the path got equal to the encode of the kernel's (± f32)
    output.  Returns the number of calls and the largest
    max|kernel-plain| over them."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.kernels import posit_gemm as pg
    import torch_inputs as ti
    check(calls, f"{path}: no GEMM was recorded")
    worst = 0.0
    for name, a, b, kw, out in calls:
        fmt, mode, bk = kw["fmt"], kw["mode"], kw["bk"]
        got = pg.posit_gemm_f32(a, b, bk=bk, mode=mode, fmt=fmt)
        plain = pg.posit_gemm_f32_plain(a, b, bk=bk, mode=mode, fmt=fmt)
        av, bv = posit.to_float64(a, fmt), posit.to_float64(b, fmt)
        bound = np.sqrt(a.shape[-1]) * 8e-8
        e_k = ti.gemm_rel_err(got, av, bv)
        e_p = ti.gemm_rel_err(plain, av, bv)
        check(e_k < bound and e_p < bound,
              f"{path} {name} {fmt.name} {mode} {tuple(a.shape)} @ "
              f"{tuple(b.shape)}: kernel {e_k:.3g} plain {e_p:.3g} >= "
              f"bound {bound:.3g}")
        worst = max(worst, float((got - plain).abs().max()))
        if name == "posit_gemm":
            neg = kw.get("negate", False)
            want = pg.encode_posit_f32_plain(-got if neg else got, fmt)
            check(torch.equal(out, want),
                  f"{path} posit_gemm {fmt.name} {mode} neg={neg} "
                  f"{tuple(a.shape)} @ {tuple(b.shape)}: the path's words "
                  "!= encode(± the kernel's f32 output)")
        else:
            check(same_bits(out, got), f"{path} posit_gemm_f32 "
                  f"{tuple(a.shape)} @ {tuple(b.shape)}: not deterministic")
    return len(calls), worst


def tiled_quant_chain(x, words, sexp, fmt, bk=32):
    """A quantized linear as ``quant_matmul`` runs it above the skinny
    kernel's rows (and as it ran every linear before it): the encode
    kernel, the words widened to int32, the pre-pass and the tiled
    kernel, then the channel scales."""
    import torch
    from repro_torch.kernels import posit_gemm as pg
    y = pg.posit_gemm_f32(pg.encode_posit_f32(x, fmt), words.to(torch.int32),
                          bk=bk, mode="split3", fmt=fmt)
    return y * pg.channel_scales(sexp)


def check_quant_gemms(path, calls):
    """Each recorded ``quant_gemm_f32`` call of a path: its output equal bit
    for bit to the tiled chain on the same operands and to a second
    launch, and, like the plain version's, within sqrt(K)*8e-8 of the
    exact product of the activation words and the scaled weights.  Returns
    the number of calls and the largest max|kernel-plain| over them."""
    import numpy as np
    from repro_torch.core import posit
    from repro_torch.kernels import posit_gemm as pg
    import torch_inputs as ti
    calls = [c for c in calls if c[0] == "quant_gemm_f32"]
    check(calls, f"{path}: no quant_gemm_f32 call was recorded")
    worst = 0.0
    for _, x, w, kw, out in calls:
        fmt, sexp, bk = kw["fmt"], kw["sexp"], kw["bk"]
        what = f"{path} quant_gemm_f32 {fmt.name} {tuple(x.shape)} @ " \
               f"{tuple(w.shape)}"
        check(same_bits(out, pg.quant_gemm_f32(x, w, sexp, fmt, bk=bk)),
              f"{what}: not deterministic")
        check(same_bits(out, tiled_quant_chain(x, w, sexp, fmt, bk)),
              f"{what}: != the tiled kernel's chain")
        plain = pg.quant_gemm_f32_plain(x, w, sexp, fmt, bk=bk)
        av = posit.to_float64(pg.encode_posit_f32(x, fmt), fmt)
        bv = (posit.to_float64(w.to(x.device).int(), fmt)
              * pg.channel_scales(sexp).double())
        bound = np.sqrt(x.shape[1]) * 8e-8
        e_k, e_p = ti.gemm_rel_err(out, av, bv), ti.gemm_rel_err(plain, av, bv)
        check(e_k < bound and e_p < bound, f"{what}: kernel {e_k:.3g} plain "
              f"{e_p:.3g} >= bound {bound:.3g}")
        worst = max(worst, float((out - plain).abs().max()))
    return len(calls), worst


def run_study(cfg, backend, dev, timed=False, study=None):
    """One study cell (``backward_error_study`` unless named): (result,
    wall seconds, stage seconds or None, GEMM launches by format or
    None)."""
    import torch
    from repro_torch.lapack.error_eval import backward_error_study
    study = study or backward_error_study
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if timed:
        with StageTimer() as st:
            res = study(gemm_backend=backend, device=dev, **cfg)
        stages, gemm = {k: v for k, v in st.secs.items() if v}, st.gemm
    else:
        res = study(gemm_backend=backend, device=dev, **cfg)
        stages = gemm = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if stages is not None:
        stages["other"] = wall - sum(stages.values())
    return res, wall, stages, gemm


class FactorKeeper:
    """Keeps what ``decomp.rpotrf`` returns while it is open (the study
    calls it through the module; a reference to the device words, no
    copy), so that [dist chol] is held to [main]'s words without
    factoring again."""

    def __init__(self):
        self.words = {}

    def __enter__(self):
        from repro_torch.lapack import decomp
        self.saved = {"rpotrf": decomp.rpotrf}
        for name, fn in self.saved.items():
            def kept(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                self.words[_name] = _as_tuple(out)
                return out
            setattr(decomp, name, kept)
        return self

    def __exit__(self, *exc):
        from repro_torch.lapack import decomp
        for name, fn in self.saved.items():
            setattr(decomp, name, fn)
        return False


def phase_main_path(dev, smi):
    """The §5.1 path at full size, every trailing update on the kernel.
    The launch counts are read right after the two studies: they are the
    main path's own.  Also returns the Cholesky factor's words."""
    import math
    from repro_torch.kernels import posit_gemm as pg

    report = {}
    pg.reset_launch_counts()
    keeper = FactorKeeper()
    for cfg in (MAIN_LU, MAIN_CHOL):
        before = pg.launch_counts()
        with keeper:
            res, wall, stages, _ = run_study(cfg, "pallas_split3", dev,
                                             timed=True)
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
    return report, counts, keeper.words


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


def reference_backend_studies(dev):
    """[main]'s studies with the f64 xla_quire backend (no kernel), run
    in a child process beside the kernel path: both are host-bound, each
    on one core, and the card has room for both.  {algo: (e_posit, wall
    seconds)}."""
    import torch
    out = {}
    for cfg in (MAIN_LU, MAIN_CHOL):
        res, wall, _, _ = run_study(cfg, "xla_quire", torch.device(dev))
        out[cfg["algo"]] = (res.e_posit, wall)
    return out


def phase_reference_backend(report, job):
    """The same studies with the f64 xla_quire backend (``job``: the
    child's ``reference_backend_studies``): the kernel's e_posit must lie
    within 0.5 decimal digits."""
    import math
    got = job.get(timeout=900)
    for cfg in (MAIN_LU, MAIN_CHOL):
        e_ref, wall = got[cfg["algo"]]
        mine = report[cfg["algo"]]["e_posit"]
        gap = abs(math.log10(mine / e_ref))
        check(gap < 0.5, f"{cfg['algo']}: e_posit {mine} vs xla_quire "
              f"{e_ref}: {gap:.3f} digits apart (limit 0.5)")
        say(f"[main] {cfg['algo']} n={cfg['n']} xla_quire: e_posit "
            f"{e_ref!r} (kernel path {gap:.4f} digits away); wall "
            f"{wall:.2f} s (in a child process beside [main])")
        report[cfg["algo"]]["xla_quire_e_posit"] = e_ref
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


def phase_quire(dev, smi):
    """The quire on the card gives the CPU's words: quire_dot (every
    chunking), quire_gemm and rgemm(quire_exact) in every format at ragged
    shapes and (256, 64, 256), and q_to_posit of limbs carried across
    from the CPU through interop; then rgemm(alpha=-1, beta=1,
    quire_exact) once at the LU's first trailing-update shape, with its
    host-clock time and peak device memory."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch import quire as Q
    from repro_torch.core.formats import FORMATS, P32E2
    from repro_torch.kernels.ops import rgemm
    import torch_inputs as ti
    rng = np.random.default_rng(25)
    for fmt in FORMATS.values():
        span = 20 if fmt.nbits > 8 else 4
        for (m, k, n) in QUIRE_SHAPES:
            a = ti.posits(rng, (m, k), -span, span, fmt)
            b = ti.posits(rng, (k, n), -span, span, fmt)
            c = ti.posits(rng, (m, n), -4, 4, fmt)
            a[0, 0] = fmt.nar_pattern
            ag, bg, cg = a.to(dev), b.to(dev), c.to(dev)
            # the CPU's chunkings agree (tests/test_torch_quire.py): one
            # CPU run is the yardstick of every chunking on the card
            want = Q.quire_dot(a[:, None, :], b.T[None, :, :], fmt,
                               init_p=c, negate=True)
            for kc in (None, 7, k):
                got = Q.quire_dot(ag[:, None, :], bg.T[None, :, :], fmt,
                                  init_p=cg, negate=True, kc=kc)
                check(same_bits(got, want), f"quire_dot {fmt.name} "
                      f"{(m, k, n)} kc={kc}: GPU != CPU")
            check(same_bits(Q.quire_gemm(ag, bg, cg, fmt, negate=True),
                            Q.quire_gemm(a, b, c, fmt, negate=True)),
                  f"quire_gemm {fmt.name} {(m, k, n)}: GPU != CPU")
            for alpha, beta in ((-1.0, 1.0), (2.0, -0.5)):
                check(same_bits(
                    rgemm(ag, bg, cg, alpha=alpha, beta=beta,
                          backend="quire_exact", fmt=fmt),
                    rgemm(a, b, c, alpha=alpha, beta=beta,
                          backend="quire_exact", fmt=fmt)),
                      f"rgemm quire_exact {fmt.name} {(m, k, n)} "
                      f"alpha={alpha} beta={beta}: GPU != CPU")
            limbs, nar = Q.quire_gemm_limbs(a, b, fmt, negate=True)
            q = interop.quire_to_torch(*interop.quire_to_numpy(
                Q.Quire(limbs, nar)), device=dev)
            check(same_bits(Q.q_to_posit(q, fmt),
                            Q.q_to_posit(Q.Quire(limbs, nar), fmt)),
                  f"q_to_posit {fmt.name} {(m, k, n)}: GPU != CPU")
        say(f"[quire] {fmt.name}: quire_dot (kc None/7/K), quire_gemm, "
            "rgemm quire_exact (alpha,beta) = (-1,1), (2,-0.5) and "
            f"q_to_posit of carried limbs at {len(QUIRE_SHAPES)} shapes: "
            "GPU words == CPU words")
    m, k, n = TIMED_SHAPE
    a = ti.posits(rng, (m, k), -4, 4, P32E2, dev)
    b = ti.posits(rng, (k, n), -4, 4, P32E2, dev)
    c = ti.posits(rng, (m, n), -2, 2, P32E2, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = rgemm(a, b, c, alpha=-1.0, beta=1.0, backend="quire_exact")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(tuple(out.shape) == (m, n) and not bool(
        (out == P32E2.nar_pattern).any()), "quire_exact rgemm: NaR or shape")
    split3 = rgemm(a, b, c, alpha=-1.0, beta=1.0, backend="pallas_split3")
    agree = float((out == split3).double().mean())
    say(f"[quire] rgemm(alpha=-1, beta=1, quire_exact) {(m, k, n)}: "
        f"{secs * 1e3:.1f} ms on the host clock (one call, first use), "
        f"peak device memory {peak / 2**30:.2f} GiB above the operands; "
        f"{100 * agree:.2f} % of its words equal pallas_split3's [{smi}]")
    return dict(shape=[m, k, n], host_ms=secs * 1e3, peak_bytes=peak,
                words_equal_split3=agree)


def phase_refine(dev, smi):
    """The quire-exact refinement path at full size, every trailing
    update on the kernel: refinement_study LU and Cholesky, and
    mixed_precision_study (p32e2 and p16e1 factorizations).  The launch
    counts are reset just before and read just after: they are this
    path's own."""
    import math
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.lapack.error_eval import (mixed_precision_study,
                                               refinement_study)
    report = {}
    pg.reset_launch_counts()
    for label, cfg, study, formats in (
            ("refine lu", REFINE_LU, refinement_study, ("p32e2",)),
            ("refine cholesky", REFINE_CHOL, refinement_study, ("p32e2",)),
            ("mixed lu", MIXED, mixed_precision_study, ("p32e2", "p16e1"))):
        res, wall, stages, gemm = run_study(cfg, "pallas_split3", dev,
                                            timed=True, study=study)
        expect = math.ceil(cfg["n"] / cfg["nb"]) - 1
        for fmt_name in formats:
            row = gemm.get(fmt_name, {})
            check(row.get("rgemm_calls") == row.get("posit_gemm_f32")
                  == row.get("decode_planes") == expect,
                  f"{label} n={cfg['n']} {fmt_name}: {row}, expected "
                  f"{expect} trailing updates, each one GEMM and one "
                  "pre-pass launch")
            check(row["posit_gemm_f32_simple"] == row["posit_gemm_simple"]
                  == row["posit_gemm"] == 0,
                  f"{label} {fmt_name}: other GEMM kernels launched: {row}")
        check(sorted(gemm) == sorted(formats),
              f"{label}: GEMMs in formats {sorted(gemm)}")
        if study is refinement_study:
            errs = dict(e_plain=res.e_plain, e_ir=res.e_ir,
                        digits_gained=res.digits_gained)
            check(math.isfinite(res.e_ir) and math.isfinite(res.e_plain),
                  f"{label}: {res}")
            check(res.digits_gained >= 2.0,
                  f"{label}: refinement gained {res.digits_gained:.3f} "
                  "digits, below the reference's bar of 2")
        else:
            errs = dict(e_ir=res.e_ir, e_mp=res.e_mp,
                        digits_lost=res.digits_lost)
            check(math.isfinite(res.e_ir) and math.isfinite(res.e_mp),
                  f"{label}: {res}")
        say(f"[refine] {label} n={cfg['n']} nb={cfg['nb']} pallas_split3: "
            + " ".join(f"{k} {v!r}" for k, v in errs.items())
            + f"; GEMM launches "
            + ", ".join(f"{f} {gemm[f]['posit_gemm_f32']}" for f in formats)
            + f" (one per trailing update); wall {wall:.2f} s "
            + " ".join(f"{k} {v:.2f} s" for k, v in stages.items())
            + f" [{smi}]")
        report[label] = dict(n=cfg["n"], nb=cfg["nb"], wall_s=wall,
                             stages_s=stages, gemm=gemm, **errs)
    counts = pg.launch_counts()
    say(f"[refine] launches on the refinement path: {json.dumps(counts)}")
    check(counts["posit_gemm_f32_simple"] == counts["posit_gemm_simple"] == 0,
          "the simple kernel was launched on the refinement path")
    return report, counts


def phase_mp_cells(dev, smi):
    """The reference's mixed-precision acceptance cells with the kernel:
    the p16e1-factor drivers lose under half a digit to the full-width
    ones."""
    from repro_torch.lapack.error_eval import mixed_precision_study
    out = []
    for algo, n, sigma in MP_CELLS:
        t0 = time.perf_counter()
        r = mixed_precision_study(n, sigma, algo, nb=16,
                                  gemm_backend="pallas_split3", device=dev)
        wall = time.perf_counter() - t0
        check(r.digits_lost < 0.5, f"mp {algo} n={n} sigma={sigma}: "
              f"digits lost {r.digits_lost:.3f} >= 0.5 ({r})")
        say(f"[mp] {algo} n={n} sigma={sigma:g} nb=16 pallas_split3: e_ir "
            f"{r.e_ir!r} e_mp {r.e_mp!r} digits lost {r.digits_lost:.4f} "
            f"(< 0.5); wall {wall:.2f} s [{smi}]")
        out.append(dict(algo=algo, n=n, sigma=sigma, e_ir=r.e_ir,
                        e_mp=r.e_mp, digits_lost=r.digits_lost,
                        wall_s=wall))
    return out


def phase_refine_parity(dev):
    """The four refinement drivers with the faithful and quire_exact
    GEMMs: pair words and factors on the card equal the CPU's, bit for
    bit (integer and separately rounded f64 ops only)."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.lapack import refine
    from repro_torch.lapack.error_eval import make_general, make_spd
    for name, n in PARITY_DRIVERS:
        make = make_spd if name.startswith("rposv") else make_general
        a64 = make(n, 1.0, 0)                    # the §5.1 studies' cell
        a = posit.from_float64(torch.from_numpy(a64))
        b = posit.from_float64(torch.from_numpy(
            a64 @ np.full(n, 1.0 / np.sqrt(n))))
        for backend in ("faithful", "quire_exact"):
            t0 = time.perf_counter()
            (hg, lg), fg = getattr(refine, name)(a.to(dev), b.to(dev),
                                                 gemm_backend=backend)
            torch.cuda.synchronize()
            t_gpu = time.perf_counter() - t0
            t0 = time.perf_counter()
            (hc, lc), fc = getattr(refine, name)(a, b, gemm_backend=backend)
            t_cpu = time.perf_counter() - t0
            fg = fg if isinstance(fg, tuple) else (fg,)
            fc = fc if isinstance(fc, tuple) else (fc,)
            check(same_bits(hg, hc) and same_bits(lg, lc),
                  f"{name} n={n} {backend}: pair words GPU != CPU")
            check(all(same_bits(g, c) for g, c in zip(fg, fc)),
                  f"{name} n={n} {backend}: factors GPU != CPU")
            check(bool(lc.any()), f"{name} n={n} {backend}: x_lo all zero, "
                  "the pair carries nothing below x_hi")
            say(f"[parity] {name} n={n} {backend}: x_hi, x_lo and factors "
                f"bit-identical on GPU and CPU (GPU {t_gpu:.2f} s, CPU "
                f"{t_cpu:.2f} s)")


def backward_error(a64, x64, b64) -> float:
    """|b - A x| / |b| (2-norms): the §5.1 backward error."""
    import numpy as np
    return float(np.linalg.norm(b64 - a64 @ x64) / np.linalg.norm(b64))


def ls_inputs(m, n, sigma, seed, dev):
    """The least-squares cell: (A, b) as p32e2 words on ``dev``, their
    exact f64 values, and the f64 originals."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.lapack.error_eval import make_rect
    a64 = make_rect(m, n, sigma, seed)
    b64 = a64 @ np.full(n, 1.0 / np.sqrt(n))
    a_p = posit.from_float64(torch.from_numpy(a64).to(dev))
    b_p = posit.from_float64(torch.from_numpy(b64).to(dev))
    return (a_p, b_p, posit.to_float64(a_p).cpu().numpy(),
            posit.to_float64(b_p).cpu().numpy(), a64, b64)


def qr_gemm_launches(m, n, nb):
    """(fused, f32) GEMM launches of rgels: three rgemm calls per block of
    rgeqrf that has columns to its right, and per block of rormqr; V^T C
    and T^T W take the fused form, C - V W the f32 one."""
    kk = min(m, n)
    blocks = len(range(0, kk, nb))
    updates = sum(1 for j in range(0, kk, nb) if j + min(nb, kk - j) < n)
    return 2 * (updates + blocks), updates + blocks


def graph_cache_report(phase):
    """The CUDA-graph cache of the chained scans after a phase: graphs
    kept, and the device memory the caching allocator holds once its free
    blocks outside graph pools are released (reserved - allocated is then
    mostly what the graphs' shared pool keeps)."""
    import torch
    from repro_torch.lapack import blas
    torch.cuda.empty_cache()
    out = dict(scan_graphs=len(blas._ADD_STEPS),
               memory_reserved_mib=torch.cuda.memory_reserved() / 2**20,
               memory_allocated_mib=torch.cuda.memory_allocated() / 2**20)
    say(f"[{phase}] chained-scan graphs cached {out['scan_graphs']} (at most "
        f"{blas._ADD_STEPS_MAX}); after empty_cache: memory reserved "
        f"{out['memory_reserved_mib']:.1f} MiB, allocated "
        f"{out['memory_allocated_mib']:.1f} MiB")
    return out


def phase_qr(dev, smi):
    """Householder QR least squares at the reference's QR benchmark shape,
    the block reflector's GEMMs on the kernels: stage seconds, errors,
    and each kernel's launches, counted from zero around the run."""
    import math
    import torch
    from repro_torch.core import posit
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.lapack import qr
    m, n, nb = QR_CELL["m"], QR_CELL["n"], QR_CELL["nb"]
    a_p, b_p, a64q, b64q, a64, b64 = ls_inputs(m, n, 1.0, 0, dev)
    pg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageTimer() as st, GemmRecorder() as rec:
        x, (qr_p, tau) = qr.rgels(a_p, b_p, nb=nb,
                                  gemm_backend="pallas_split3")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = pg.launch_counts()
    n_gemm, worst = check_path_gemms("qr", rec.calls)
    say(f"[qr] the path's {n_gemm} GEMMs (V^T C over up to "
        f"{-(-m // 128)} K chunks, T^T W, C -= V W, rormqr's N=1 forms) "
        "held to the plain version on their own operands: within "
        "sqrt(K)*8e-8 of the exact product, fused words == encode(± "
        f"kernel f32); max|kernel-plain| {worst:.3e}")
    stages = {k: v for k, v in st.secs.items() if v}
    stages["other"] = wall - sum(stages.values())
    fused, f32 = qr_gemm_launches(m, n, nb)
    want = dict.fromkeys(counts, 0)
    want.update(posit_gemm=fused, posit_gemm_f32=f32,
                decode_planes=fused + f32)
    check(counts == want, f"qr launches {counts}, expected {want}")
    e_qr = backward_error(a64q, posit.to_float64(x).cpu().numpy(), b64q)
    x32 = qr.sgels(torch.from_numpy(a64).to(dev, torch.float32),
                   torch.from_numpy(b64).to(dev, torch.float32))
    e_b32 = backward_error(a64, x32.cpu().numpy().astype("float64"), b64)
    gap = abs(math.log10(e_qr / E_QR_REFERENCE)) if e_qr > 0 else math.inf
    check(math.isfinite(e_qr) and gap < E_QR_DIGITS,
          f"qr: e_qr {e_qr} is {gap:.4f} digits from the JAX package's "
          f"{E_QR_REFERENCE} (limit {E_QR_DIGITS})")
    check(not bool(posit.is_nar(qr_p).any() or posit.is_nar(tau).any()),
          "qr: NaR in the factors")
    digits = math.log10(e_b32 / e_qr)
    say(f"[qr] rgels (rgeqrf + rormqr + back-substitution) {(m, n)} "
        f"nb={nb} p32e2 pallas_split3: e_qr {e_qr!r} e_binary32 {e_b32!r} "
        f"digits {digits!r} (JAX package's e_qr {E_QR_REFERENCE!r}, "
        f"{gap:.4f} digits away, limit {E_QR_DIGITS}); launches "
        f"posit_gemm {counts['posit_gemm']}, "
        f"posit_gemm_f32 {counts['posit_gemm_f32']}, decode_planes "
        f"{counts['decode_planes']}; wall {wall:.2f} s "
        + " ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f" [{smi}]")
    reserved = graph_cache_report("qr")
    return dict(m=m, n=n, nb=nb, e_qr=e_qr, e_binary32=e_b32, digits=digits,
                e_qr_reference=E_QR_REFERENCE, path_gemms=n_gemm,
                path_gemm_max_abs_diff=worst, wall_s=wall, stages_s=stages,
                gemm=st.gemm, **reserved), counts


def phase_lstsq(dev, smi):
    """least_squares_study on the paper tables' sigma grid with the
    kernel, gated as the reference gates it (digits_from_opt < 0.1,
    digits_lost < 0.5).  At sigma=1 the plain solve also runs through the
    plain split3 GEMM on the CPU, and the kernel's e_qr must lie within
    0.5 digits of it; the f64 xla_quire GEMM's e_qr is printed beside it.
    It is no yardstick for split3: the fused-encode W = V^T C is rounded
    from the f32 accumulator, so a split3 QR solve lands near binary32's
    error, in the JAX package as well (tools/qr_reference_numbers.py
    prints both of its errors at this cell)."""
    import math
    from repro_torch.core import posit
    from repro_torch.lapack import qr
    from repro_torch.lapack.error_eval import least_squares_study
    m, n, nb = LSTSQ["m"], LSTSQ["n"], LSTSQ["nb"]
    out = []
    for sigma in LSTSQ["sigmas"]:
        t0 = time.perf_counter()
        r = least_squares_study(m, n, sigma, nb=nb,
                                gemm_backend="pallas_split3", device=dev)
        wall = time.perf_counter() - t0
        check(r.digits_from_opt < 0.1 and r.digits_lost < 0.5,
              f"lstsq sigma={sigma}: digits_from_opt "
              f"{r.digits_from_opt:.3f} (limit 0.1), digits_lost "
              f"{r.digits_lost:.3f} (limit 0.5): {r}")
        row = dict(sigma=sigma, e_qr=r.e_qr, e_ir=r.e_ir, e_mp=r.e_mp,
                   e_opt=r.e_opt, e_binary32=r.e_binary32, digits=r.digits,
                   digits_from_opt=r.digits_from_opt,
                   digits_lost=r.digits_lost, wall_s=wall)
        extra = ""
        if sigma == 1.0:
            a_p, b_p, a64q, b64q, _, _ = ls_inputs(m, n, sigma, 0, dev)

            def e_qr(backend, device):
                x, _ = qr.rgels(a_p.to(device), b_p.to(device), nb=nb,
                                gemm_backend=backend)
                return backward_error(
                    a64q, posit.to_float64(x).cpu().numpy(), b64q)
            e_plain = e_qr("pallas_split3", "cpu")
            e_x = e_qr("xla_quire", dev)
            gap = abs(math.log10(r.e_qr / e_plain))
            check(gap < 0.5, f"lstsq: e_qr {r.e_qr} with the kernel vs "
                  f"{e_plain} with the plain split3 GEMM: {gap:.3f} digits "
                  "apart (limit 0.5)")
            row.update(plain_split3_e_qr=e_plain, xla_quire_e_qr=e_x)
            extra = (f"; plain split3 (CPU) e_qr {e_plain!r} ({gap:.4f} "
                     f"digits away); xla_quire e_qr {e_x!r} "
                     f"({math.log10(r.e_qr / e_x):.4f} digits below the "
                     "kernel's)")
        say(f"[lstsq] {(m, n)} sigma={sigma:g} nb={nb} pallas_split3: e_qr "
            f"{r.e_qr!r} e_ir {r.e_ir!r} e_mp {r.e_mp!r} e_opt {r.e_opt!r} "
            f"e_binary32 {r.e_binary32!r}; digits {r.digits:.4f} "
            f"digits_from_opt {r.digits_from_opt:.4f} (< 0.1) digits_lost "
            f"{r.digits_lost:.4f} (< 0.5){extra}; wall {wall:.2f} s [{smi}]")
        out.append(row)
    return out


def phase_ensemble(dev, smi):
    """The batched §5.1 ensemble (Fig. 7's sigma grid x two seeds, one
    batched factorization and solve): one GEMM and one pre-pass launch per
    trailing update for the whole batch; then the (sigma=1, seed 0)
    cell's e_posit against the 2-D study with the same backend and nb
    (run after the path's launch counts are read)."""
    import math
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.lapack.error_eval import (backward_error_ensemble,
                                               backward_error_study)
    report, cells_by = {}, {}
    pg.reset_launch_counts()
    for cfg in ENSEMBLE_CELLS:
        n, algo, nb = cfg["n"], cfg["algo"], cfg["nb"]
        res, wall, stages, gemm = run_study(
            dict(n=n, sigmas=ENSEMBLE_SIGMAS, algo=algo,
                 seeds=ENSEMBLE_SEEDS, nb=nb), "pallas_split3", dev,
            timed=True, study=backward_error_ensemble)
        expect = math.ceil(n / nb) - 1
        row = gemm.get("p32e2", {})
        check(sorted(gemm) == ["p32e2"] and row.get("rgemm_calls")
              == row.get("posit_gemm_f32") == row.get("decode_planes")
              == expect and row["posit_gemm"] == row["posit_gemm_f32_simple"]
              == row["posit_gemm_simple"] == 0,
              f"ensemble {algo} n={n}: {gemm}, expected {expect} trailing "
              "updates, each ONE GEMM and one pre-pass launch for the batch")
        check(all(math.isfinite(c.e_posit) and c.e_posit > 0 for c in res),
              f"ensemble {algo}: {res}")
        cells_by[algo] = res
        say(f"[ensemble] {algo} n={n} nb={nb} pallas_split3, batch of "
            f"{len(res)} (sigma x seed): GEMM launches {row['posit_gemm_f32']}"
            f" for {expect} batched trailing updates; wall {wall:.2f} s "
            + " ".join(f"{k} {v:.2f} s" for k, v in stages.items())
            + f" [{smi}]")
        for c, (sigma, seed) in zip(res, [(s, sd) for s in ENSEMBLE_SIGMAS
                                          for sd in ENSEMBLE_SEEDS]):
            say(f"[ensemble]   {algo} sigma={sigma:g} seed={seed}: e_posit "
                f"{c.e_posit!r} e_binary32 {c.e_binary32!r} digits "
                f"{c.digits:.4f}")
        report[algo] = dict(n=n, nb=nb, wall_s=wall, stages_s=stages,
                            gemm=gemm, cells=[dict(
                                sigma=c.sigma, e_posit=c.e_posit,
                                e_binary32=c.e_binary32) for c in res])
    counts = pg.launch_counts()
    say(f"[ensemble] launches on the ensemble path: {json.dumps(counts)}")
    report["graph_cache"] = graph_cache_report("ensemble")
    at = [(s, sd) for s in ENSEMBLE_SIGMAS
          for sd in ENSEMBLE_SEEDS].index((1.0, 0))
    for cfg in ENSEMBLE_CELLS:
        n, algo, nb = cfg["n"], cfg["algo"], cfg["nb"]
        t0 = time.perf_counter()
        one = backward_error_study(n, 1.0, algo, seed=0, nb=nb,
                                   gemm_backend="pallas_split3", device=dev)
        wall = time.perf_counter() - t0
        got = cells_by[algo][at].e_posit
        check(got == one.e_posit, f"ensemble {algo} (sigma=1, seed 0): "
              f"e_posit {got!r} != 2-D study's {one.e_posit!r}")
        say(f"[ensemble] {algo} n={n} (sigma=1, seed 0): e_posit {got!r} "
            f"== the 2-D backward_error_study's (wall {wall:.2f} s)")
        report[algo]["study_2d_wall_s"] = wall
    return report, counts


def phase_qr_parity(dev):
    """rgels (rgeqrf's factors and tau, rormqr, the back-substitution)
    with the faithful and quire_exact GEMMs: the card's words equal the
    CPU's, bit for bit."""
    from repro_torch.lapack import qr
    m, n, nb = QR_PARITY["m"], QR_PARITY["n"], QR_PARITY["nb"]
    a_p, b_p, _, _, _, _ = ls_inputs(m, n, 1.0, 0, "cpu")
    for backend in ("faithful", "quire_exact"):
        t0 = time.perf_counter()
        xg, (qg, tg) = qr.rgels(a_p.to(dev), b_p.to(dev), nb=nb,
                                gemm_backend=backend)
        xc, (qc, tc) = qr.rgels(a_p, b_p, nb=nb, gemm_backend=backend)
        check(same_bits(xg, xc) and same_bits(qg, qc) and same_bits(tg, tc),
              f"qr parity {(m, n)} nb={nb} {backend}: GPU words != CPU")
        say(f"[qr parity] rgels {(m, n)} nb={nb} {backend}: x, QR and tau "
            f"bit-identical on GPU and CPU ({time.perf_counter() - t0:.2f}"
            " s)")


def phase_batched_gemm(dev, smi):
    """One batched launch (pre-pass + GEMM) against per-matrix 2-D
    launches, bit for bit: ragged K (below one 16-row stage), N = 1, a
    transposed A, batch-strided views; p32e2 and p16e1, both modes, f32
    and fused ±encode.  Then the batched launch timed at the ensemble
    LU's first update against the same work as 2-D launches, with its
    bound and the f64 ``torch.bmm`` yardstick."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.core.formats import P16E1, P32E2
    from repro_torch.kernels import posit_gemm as pg
    import torch_inputs as ti
    rng = np.random.default_rng(26)
    compared = 0
    for fmt in (P32E2, P16E1):
        def words(shape):
            return ti.posits(rng, shape, -4, 4, fmt, dev)
        big = words((3, 400, 400))
        cases = [("ragged K", words((3, 200, 7)), words((3, 7, 150))),
                 ("N = 1", words((3, 300, 200)), words((3, 200, 1))),
                 ("transposed A", words((3, 70, 130)).mT, words((3, 70, 90))),
                 ("strided views", big[:, 3:260, 5:205], big[:, 10:210, 20:90])]
        for label, a, b in cases:
            for mode in pg.MODES:
                for form, neg in (("f32", False), ("fused", False),
                                  ("fused", True)):
                    def run(x, y):
                        if form == "f32":
                            return pg.posit_gemm_f32(x, y, bk=16, mode=mode,
                                                     fmt=fmt)
                        return pg.posit_gemm(x, y, bk=16, mode=mode,
                                             negate=neg, fmt=fmt)
                    before = pg.launch_counts()
                    got = run(a, b)
                    after = pg.launch_counts()
                    gemm = "posit_gemm" if form == "fused" else \
                        "posit_gemm_f32"
                    check(after[gemm] - before[gemm] == 1 and
                          after["decode_planes"] - before["decode_planes"]
                          == 1, f"batched {label}: not one launch each")
                    want = torch.stack([run(a[i], b[i]) for i in range(3)])
                    check(same_bits(got, want), f"batched launch != 2-D "
                          f"launches: {fmt.name} {mode} {form} neg={neg} "
                          f"{label}")
                    compared += 1
        say(f"[batched] {fmt.name}: one batched launch == 3 per-matrix "
            "launches bit for bit (ragged K=7, N=1, transposed A, strided "
            "views; both modes; f32 and fused ±encode; kc=16)")
    bsz, m, k, n = BATCH_SHAPE
    a = ti.posits(rng, (bsz, m, k), -4, 4, P32E2, dev)
    b = ti.posits(rng, (bsz, k, n), -4, 4, P32E2, dev)

    def batched():
        return pg.posit_gemm_f32(a, b)

    def per_matrix():
        return [pg.posit_gemm_f32(a[i], b[i]) for i in range(bsz)]
    check(same_bits(batched(), torch.stack(per_matrix())),
          "batched launch != 2-D launches at the ensemble's shape")
    loop_ms, batch_ms, raw = interleaved_ms(per_matrix, batched)
    flops = 6.0 * bsz * m * k * n
    nbytes = 4.0 * bsz * (m * k + k * n + m * n)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    by = ("operations" if flops / PEAK_FP32_FLOPS
          >= nbytes / PEAK_BYTES_PER_S else "bytes")
    a64, b64 = posit.to_float64(a), posit.to_float64(b)
    bmm_ms = cuda_ms(lambda: torch.bmm(a64, b64), 20)
    plain_ms = cuda_ms(lambda: pg.posit_gemm_f32_plain(a, b), 3)
    say(f"[batched] p32e2 split3 f32 {bsz} x {(m, k, n)}: one batched "
        f"launch {batch_ms:.4f} ms, {bsz} 2-D launches {loop_ms:.4f} ms "
        "(2-D, batched, batched, 2-D: " + ", ".join(f"{t:.4f}" for t in raw)
        + f"); bound {bound_ms:.4f} ms ({by}), batched at "
        f"{100 * bound_ms / batch_ms:.1f} % of it; plain {plain_ms:.4f} ms; "
        f"torch.bmm f64 on the decoded values {bmm_ms:.4f} ms [{smi}]")
    return dict(shape=[bsz, m, k, n], batched_ms=batch_ms,
                per_matrix_ms=loop_ms, interleaved_ms=raw, bound_ms=bound_ms,
                bound_by=by, plain_ms=plain_ms, library_bmm_f64_ms=bmm_ms,
                identity_comparisons=compared)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def counted_run(fn):
    """(output, wall seconds, GEMM kernel launches) of ``fn()``, the
    launches counted from zero around it."""
    import torch
    from repro_torch.kernels import posit_gemm as pg
    pg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, pg.launch_counts()


def phase_obs(dev, smi):
    """positscope on the card.  The §5.1 LU and Cholesky (faithful) under
    a collector: the record equals the CPU's (span times aside) and the
    words equal the unobserved run's.  The split3 LU under a collector
    (runs in turns: unobserved, observed, observed, unobserved): the
    words and the kernel launches of the unobserved run, and its Chrome
    trace written to a file and read back."""
    import os
    import tempfile
    import torch
    from repro_torch import obs
    from repro_torch.core import posit
    from repro_torch.lapack import decomp
    from repro_torch.lapack.error_eval import make_general, make_spd
    import torch_inputs as ti
    n = OBS_PARITY_N
    report = {}
    for algo, make, factor, key in (
            ("lu", make_general, decomp.rgetrf, "rgetrf"),
            ("cholesky", make_spd, decomp.rpotrf, "rpotrf")):
        a = posit.from_float64(torch.from_numpy(make(n, 1.0, 0)))
        runs = {}
        for where, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
            with obs.scoped() as m:
                out = factor(a.to(d), nb=32, gemm_backend="faithful")
            runs[where] = (m.to_dict(), _as_tuple(out))
        plain = _as_tuple(factor(a.to(dev), nb=32, gemm_backend="faithful"))
        (rec, got), (want, cpu) = runs["gpu"], runs["cpu"]
        mismatch = ti.record_mismatch(rec, want)
        check(mismatch is None, f"[obs] {algo} n={n}: record GPU != CPU: "
              f"{mismatch}")
        check(all(same_bits(g, c) for g, c in zip(got, cpu)),
              f"[obs] {algo} n={n}: observed words GPU != CPU")
        check(all(same_bits(g, p) for g, p in zip(got, plain)),
              f"[obs] {algo} n={n}: observed words != unobserved words")
        steps = rec["series"][f"{key}.step"]
        say(f"[obs] {algo} n={n} nb=32 faithful under a collector: record "
            f"== the CPU's ({len(steps)} {key}.step rows, {rec['spans']} "
            f"span, counters {rec['counters']}, last panel golden zone "
            f"{rec['gauges'][f'{key}.last_panel.golden_zone']!r}); words "
            "== the unobserved run's")
        report[algo] = dict(n=n, step_rows=len(steps), spans=rec["spans"])
    cfg = OBS_LU
    a = posit.from_float64(torch.from_numpy(make_general(
        cfg["n"], 1.0, 0)).to(dev))

    def lu():
        return decomp.rgetrf(a, nb=cfg["nb"], gemm_backend="pallas_split3")
    runs = {False: [], True: []}
    for observed in (False, True, True, False):
        if observed:
            with obs.scoped() as m:
                runs[True].append(counted_run(lu))
        else:
            runs[False].append(counted_run(lu))
    (lu0, piv0), _, counts0 = runs[False][0]
    for (lu1, piv1), _, counts1 in runs[False][1:] + runs[True]:
        check(same_bits(lu0, lu1) and same_bits(piv0, piv1),
              f"[obs] split3 LU n={cfg['n']}: observed words != unobserved")
        check(counts0 == counts1 and counts0["posit_gemm_f32"] > 0,
              f"[obs] split3 LU n={cfg['n']}: launches {counts1}, "
              f"unobserved {counts0}")
    walls = {k: [w for _, w, _ in v] for k, v in runs.items()}
    wall0, wall1 = (sum(walls[k]) / 2 for k in (False, True))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rgetrf_trace.json")
        m.save_chrome_trace(path)
        doc = json.loads(Path(path).read_text())
    events = doc["traceEvents"]
    check(len(events) == m.to_dict()["spans"] == 1
          and events[0]["name"] == "rgetrf" and events[0]["ph"] == "X"
          and 0 < events[0]["dur"] <= walls[True][1] * 1e6,
          f"[obs] Chrome trace read back: {events}")
    rows = m.to_dict()["series"]["rgetrf.step"]
    say(f"[obs] split3 LU n={cfg['n']} nb={cfg['nb']}: observed wall "
        f"{wall1:.2f} s, unobserved {wall0:.2f} s "
        f"({100 * (wall1 / wall0 - 1):+.1f} %; in turns "
        f"{walls[False][0]:.2f}, {walls[True][0]:.2f}, {walls[True][1]:.2f},"
        f" {walls[False][1]:.2f} s); words and kernel launches "
        f"equal ({counts0['posit_gemm_f32']} GEMM, "
        f"{counts0['decode_planes']} pre-pass); {len(rows)} step rows; "
        f"Chrome trace written and read back ({len(events)} event, "
        f"{events[0]['dur'] / 1e6:.2f} s) [{smi}]")
    report["lu_split3"] = dict(n=cfg["n"], nb=cfg["nb"], wall_s=wall1,
                               unobserved_wall_s=wall0, walls_s=walls,
                               gemm_launches=counts0["posit_gemm_f32"])
    return report


def phase_golden(dev, smi):
    """golden_zone_study on the kernel: each cell's occupancy equals the
    one computed on the CPU from the same words, ``ir.sweep`` has ``iters``
    rows a cell, refinement gains >= 2 digits at sigma=1 (the reference's
    bar); one GEMM and one pre-pass launch per trailing update, counted
    from zero around the study."""
    import math
    import torch
    from repro_torch import obs
    from repro_torch.core import posit
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.lapack.error_eval import (golden_zone_study,
                                               golden_zone_table,
                                               make_general)
    cfg = GOLDEN
    pg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageTimer() as st:
        res = golden_zone_study(cfg["n"], cfg["sigmas"], cfg["algo"],
                                nb=cfg["nb"], iters=cfg["iters"],
                                gemm_backend="pallas_split3", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = pg.launch_counts()
    stages = {k: v for k, v in st.secs.items() if v}
    stages["other"] = wall - sum(stages.values())
    expect = len(cfg["sigmas"]) * (math.ceil(cfg["n"] / cfg["nb"]) - 1)
    check(counts["posit_gemm_f32"] == counts["decode_planes"] == expect
          and counts["posit_gemm"] == counts["posit_gemm_f32_simple"]
          == counts["posit_gemm_simple"] == 0,
          f"[golden] launches {counts}, expected {expect} GEMM and pre-pass "
          "launches (one per trailing update)")
    for r in res:
        a_cpu = posit.from_float64(torch.from_numpy(make_general(
            cfg["n"], r.sigma, 0)))
        occ = obs.golden_zone_fraction(a_cpu)
        check(r.occupancy == occ, f"[golden] sigma={r.sigma:g}: occupancy "
              f"{r.occupancy!r} != the CPU's {occ!r}")
        check(len(r.sweeps) == cfg["iters"], f"[golden] sigma={r.sigma:g}: "
              f"{len(r.sweeps)} ir.sweep rows, expected {cfg['iters']}")
        check(all(math.isfinite(x) and x > 0 for x in
                  (r.e_plain, r.e_ir, r.e_binary32)), f"[golden] {r}")
        say(f"[golden] sigma={r.sigma:g}: occupancy {r.occupancy!r} (== "
            f"CPU), e_plain {r.e_plain!r} e_ir {r.e_ir!r} e_binary32 "
            f"{r.e_binary32!r}; digits {r.digits:.4f}, IR gained "
            f"{r.digits_gained:.4f}; sweeps digits_gained "
            + ", ".join(f"{row['digits_gained']:.3f}" for row in r.sweeps))
    one = next(r for r in res if r.sigma == 1.0)
    check(one.digits_gained >= 2.0, f"[golden] sigma=1: refinement gained "
          f"{one.digits_gained:.3f} digits, below the reference's bar of 2")
    for line in golden_zone_table(res).splitlines():
        if line:
            say(f"[golden] {line}")
    say(f"[golden] golden_zone_study n={cfg['n']} nb={cfg['nb']} iters="
        f"{cfg['iters']} pallas_split3, {len(res)} cells: GEMM launches "
        f"{counts['posit_gemm_f32']}; wall {wall:.2f} s "
        + " ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f" [{smi}]")
    return dict(n=cfg["n"], nb=cfg["nb"], iters=cfg["iters"], wall_s=wall,
                stages_s=stages, cells=[dict(
                    sigma=r.sigma, occupancy=r.occupancy, e_plain=r.e_plain,
                    e_ir=r.e_ir, e_binary32=r.e_binary32, digits=r.digits,
                    digits_gained=r.digits_gained) for r in res]), counts


def _ft_drivers(name, cfg, dev):
    """(input words, unprotected run, protected run taking a plan, site,
    block steps) of a protected driver's [ft] cell."""
    import torch
    from repro_torch.core import posit
    from repro_torch.lapack import decomp, qr
    from repro_torch.lapack.error_eval import (make_general, make_rect,
                                               make_spd)
    be = "pallas_split3"
    nb = cfg["nb"]
    if name == "rgeqrf":
        a64 = make_rect(cfg["m"], cfg["n"], 1.0, 0)
        plain = lambda a: qr.rgeqrf(a, nb, be)
        prot = lambda a, plan: qr.rgeqrf_ft(a, nb, be, plan=plan)
    elif name == "rpotrf":
        a64 = make_spd(cfg["n"], 1.0, 0)
        plain = lambda a: decomp.rpotrf(a, nb, be)
        prot = lambda a, plan: decomp.rpotrf_ft(a, nb, be, plan=plan)
    else:
        a64 = make_general(cfg["n"], 1.0, 0)
        plain = lambda a: decomp.rgetrf(a, nb, be)
        prot = lambda a, plan: decomp.rgetrf_ft(a, nb, be, plan=plan)
    a = posit.from_float64(torch.from_numpy(a64).to(dev))
    steps = -(-min(a.shape) // nb)
    return a, plain, prot, f"{name}.step", steps


def phase_ft(dev, smi):
    """The checksum-protected factorizations on the kernel: fault-free,
    the unprotected driver's words (and pivots, tau) with no detection and
    the same GEMM launches; with one seeded fault at the driver's site,
    detected and recovered to the same words.  Prints the protected /
    unprotected wall ratio (runs in turns: unprotected, protected,
    protected, unprotected), the launches and the peak device memory of
    one checksum of the factored matrix.  The ``ft`` path's launches are the
    protected runs' (counted from zero around each, summed)."""
    import torch
    from repro_torch import ft
    report, path_counts = {}, {}
    for name, cfg in FT_CELLS:
        a, plain, prot, site, steps = _ft_drivers(name, cfg, dev)
        want, wall0, c0 = counted_run(lambda: _as_tuple(plain(a)))
        out, wall1, c1 = counted_run(lambda: prot(a, None))
        again, wall1b, _ = counted_run(lambda: prot(a, None))
        _, wall0b, _ = counted_run(lambda: plain(a))
        turns = (wall0, wall1, wall1b, wall0b)
        wall0, wall1 = (wall0 + wall0b) / 2, (wall1 + wall1b) / 2
        for words, rep in ((out[:-1], out[-1]), (again[:-1], again[-1])):
            check(all(same_bits(g, w) for g, w in zip(words, want))
                  and rep.detections == rep.retries == 0,
                  f"[ft] {name} fault-free: words differ or {rep}")
        check(c1 == c0, f"[ft] {name} fault-free: launches {c1} != the "
              f"unprotected {c0}")
        plan = ft.make_plan(0, site, size=a.numel(), steps=steps)
        out, wall2, c2 = counted_run(lambda: prot(a, plan))
        words, frep = out[:-1], out[-1]
        check(frep.detections >= 1 and not frep.failed,
              f"[ft] {name}: fault {plan.faults} not detected: {frep}")
        check(all(same_bits(g, w) for g, w in zip(words, want)),
              f"[ft] {name}: recovered words != the unprotected words")
        for c in (c1, c2):
            for k, v in c.items():
                path_counts[k] = path_counts.get(k, 0) + v
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ft.checksum(want[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        shape = tuple(a.shape)
        say(f"[ft] {name}_ft {shape} nb={cfg['nb']} pallas_split3: "
            f"fault-free words == unprotected, 0 detections, launches equal "
            f"({c1['posit_gemm_f32']} f32 + {c1['posit_gemm']} fused GEMM, "
            f"{c1['decode_planes']} pre-pass); wall {wall1:.2f} s vs "
            f"unprotected {wall0:.2f} s ({wall1 / wall0:.3f}x; in turns "
            + ", ".join(f"{t:.2f}" for t in turns) + " s); one fault "
            f"{plan.faults[0]}: {frep.detections} detection, "
            f"{frep.retries} retry at {frep.sites}, recovered words "
            f"identical, wall {wall2:.2f} s, launches "
            f"{c2['posit_gemm_f32'] + c2['posit_gemm']} GEMM; one checksum "
            f"of {shape}: peak {peak / 2**20:.1f} MiB above the words "
            f"[{smi}]")
        report[name] = dict(shape=list(shape), nb=cfg["nb"], wall_s=wall1,
                            unprotected_wall_s=wall0, turns_s=turns,
                            faulted_wall_s=wall2,
                            ratio=wall1 / wall0, detections=frep.detections,
                            retries=frep.retries, launches=c1,
                            faulted_launches=c2, checksum_peak_bytes=peak)
    return report, path_counts


def phase_ft_soak(dev, smi):
    """benchmarks/bench_ft.py's soak on the card: five seeded faults at
    each site (the GEMMs' outputs and quire limbs, each protected
    factorization's steps, the decompositions on the kernel), every one
    detected and recovered to the unprotected words."""
    import numpy as np
    from repro_torch import ft
    from repro_torch.core import posit
    from repro_torch.kernels.ops import rgemm
    from repro_torch.lapack import decomp, qr
    from repro_torch.lapack.error_eval import make_spd
    import torch
    import torch_inputs as ti
    n, nb, seeds = SOAK["n"], SOAK["nb"], SOAK["seeds"]
    be = "pallas_split3"
    rng = np.random.default_rng(3)
    a = ti.posits(rng, (n, n), -4, 4, device=dev)
    spd = posit.from_float64(torch.from_numpy(make_spd(n, 1.0, 3)).to(dev))
    tall = ti.posits(rng, (n, 2 * nb), -4, 4, device=dev)
    word_kinds = ("flip", "nar", "saturate")
    cases = {
        "rgemm.out": (lambda p: ft.rgemm_ft(a, a, plan=p)[::2],
                      (rgemm(a, a, backend="quire_exact"),), n * n, 1, 32,
                      word_kinds),
        "rgemm.limbs": (lambda p: ft.quire_gemm_ft(a, a, plan=p)[::2],
                        (rgemm(a, a, backend="quire_exact"),), n * n, 1, 64,
                        ("flip",)),
        "rgetrf.step": (lambda p: decomp.rgetrf_ft(a, nb, be, plan=p),
                        decomp.rgetrf(a, nb, be), n * nb, n // nb, 32,
                        word_kinds),
        "rpotrf.step": (lambda p: decomp.rpotrf_ft(spd, nb, be, plan=p),
                        (decomp.rpotrf(spd, nb, be),), n * nb, n // nb, 32,
                        word_kinds),
        "rgeqrf.step": (lambda p: qr.rgeqrf_ft(tall, nb, be, plan=p),
                        qr.rgeqrf(tall, nb, be), n * nb, 2, 32, word_kinds),
    }
    report = {}
    t0 = time.perf_counter()
    for site, (run, want, size, steps, nbits, kinds) in cases.items():
        detected = recovered = 0
        for seed in range(seeds):
            plan = ft.make_plan(seed, site, size=size, steps=steps,
                                kinds=kinds, nbits=nbits)
            out = run(plan)
            words, rep = out[:-1], out[-1]
            detected += rep.detections >= 1
            recovered += all(same_bits(g, w) for g, w in zip(words, want))
        check(detected == recovered == seeds, f"[ft soak] {site}: "
              f"{detected} of {seeds} detected, {recovered} recovered")
        report[site] = dict(injected=seeds, detected=detected,
                            recovered=recovered)
        say(f"[ft soak] {site:12s} n={n} nb={nb}: injected {seeds}, "
            f"detected {detected}, recovered bit-identically {recovered}")
    wall = time.perf_counter() - t0
    say(f"[ft soak] {len(cases) * seeds} faults, 100 % detected and "
        f"recovered; wall {wall:.2f} s [{smi}]")
    report["wall_s"] = wall
    return report


def phase_guarded(dev, smi):
    """The guarded ladder (rgesv_guarded on rgetrf_ft): its three cases
    with faithful at n=64, the card's pair words and SolveReport equal to
    the CPU's; then the benign case at n=512 on the kernel, converged
    with the reference test's residual bound."""
    import numpy as np
    import torch
    from repro_torch import ft
    from repro_torch.core import posit
    from repro_torch.lapack import refine
    import torch_inputs as ti
    report = {}
    n, nb = GUARDED_SMALL["n"], GUARDED_SMALL["nb"]
    for case, c in ti.GUARDED_CASES.items():
        a, b = ti.guarded_problem(case, n)
        plan = (ft.FaultPlan(tuple(ft.Fault(**f) for f in c["faults"]))
                if c["faults"] else None)
        runs = {}
        for where, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            (hi, lo), rep = refine.rgesv_guarded(
                a.to(d), b.to(d), nb=nb, gemm_backend="faithful", plan=plan)
            runs[where] = (hi, lo, rep, time.perf_counter() - t0)
        (hg, lg, rg, tg), (hc, lc, rc, tc) = runs["gpu"], runs["cpu"]
        check(same_bits(hg, hc) and same_bits(lg, lc),
              f"[guarded] {case}: pair words GPU != CPU")
        check(vars(rg) == vars(rc), f"[guarded] {case}: SolveReport GPU "
              f"{rg} != CPU {rc}")
        say(f"[guarded] {case} n={n} nb={nb} faithful: pair words and "
            f"SolveReport GPU == CPU: {rg} (GPU {tg:.2f} s, CPU {tc:.2f} s)")
        report[case] = dict(vars(rg), gpu_s=tg, cpu_s=tc)
    n, nb = GUARDED_BIG["n"], GUARDED_BIG["nb"]
    a, b = ti.guarded_problem("benign", n, dev)
    ((hi, lo), rep), wall, counts = counted_run(lambda: refine.rgesv_guarded(
        a, b, nb=nb, gemm_backend="pallas_split3"))
    x = refine.pair_to_float64(hi, lo).cpu().numpy()
    bv = posit.to_float64(b).cpu().numpy()
    r = bv - posit.to_float64(a).cpu().numpy() @ x
    rel = float(np.abs(r).max() / np.abs(bv).max())
    check(rep.outcome == "converged" and rel < 1e-8,
          f"[guarded] benign n={n}: {rep}, residual {rel:.3g}")
    say(f"[guarded] benign n={n} nb={nb} pallas_split3: {rep}; max|b - A x|"
        f" / max|b| {rel:.3g} (< 1e-8); GEMM launches "
        f"{counts['posit_gemm_f32']}; wall {wall:.2f} s [{smi}]")
    report["benign_big"] = dict(vars(rep), n=n, nb=nb, wall_s=wall,
                                residual=rel)
    return report


# --------------------------------------------------------------------------
# the distributed path: a 2x2 grid of ranks on the one card
# --------------------------------------------------------------------------

def dist_config() -> dict:
    """The [dist ...] cells' sizes, handed to the ranks (which import this
    module afresh)."""
    return dict(grid=DIST_GRID, nb=DIST_NB, gemm=DIST_GEMM,
                k_split=DIST_KSPLIT, lu=DIST_LU, chol=DIST_CHOL,
                ir=dict(DIST_IR), ft=dict(DIST_FT))


def dist_inputs(cfg, keys, dev):
    """The named float64 inputs of the [dist ...] cells as p32e2 words on
    ``dev``, from the §5.1 generators (``make_general``/``make_spd``,
    sigma=1, seed 0; the second GEMM operand seed 1)."""
    import numpy as np
    from repro_torch.lapack.error_eval import make_general, make_spd
    m, k, n = cfg["gemm"]
    km, kk, kn = cfg["k_split"]
    nir = cfg["ir"]["n"]
    x_sol = np.full((nir,), 1.0 / np.sqrt(nir))

    def general(shape, seed):      # make_general's draws, any shape
        return np.random.default_rng(seed).standard_normal(shape)
    make = {
        "gemm_a": lambda: general((m, k), 0),
        "gemm_b": lambda: general((k, n), 1),
        "ks_a": lambda: general((km, kk), 0),
        "ks_b": lambda: general((kk, kn), 1),
        "lu": lambda: make_general(cfg["lu"], 1.0, 0),
        "chol": lambda: make_spd(cfg["chol"], 1.0, 0),
        "ir_a": lambda: make_general(nir, 1.0, 0),
        "ir_b": lambda: make_general(nir, 1.0, 0) @ x_sol,
        "ir_spd": lambda: make_spd(nir, 1.0, 0),
        "ir_spd_b": lambda: make_spd(nir, 1.0, 0) @ x_sol,
        "ft_lu": lambda: make_general(cfg["ft"]["lu"], 1.0, 0),
        "ft_chol": lambda: make_spd(cfg["ft"]["chol"], 1.0, 0),
        "ft_a": lambda: make_general(cfg["ft"]["gemm"], 1.0, 0),
        "ft_b": lambda: make_general(cfg["ft"]["gemm"], 1.0, 1),
    }
    return {k: _posits(make[k](), dev) for k in keys}


def _posits(x64, dev):
    import torch
    from repro_torch.core import posit
    return posit.from_float64(torch.from_numpy(x64).to(dev))


class _RankPhases:
    """One rank's phase records: wall (its device synchronised, the ranks
    started together at a barrier), kernel launches, ``dist.*`` counters
    (with a collector open) and the stage split (with a stage clock on
    the grid)."""

    def __init__(self, grid):
        self.grid = grid
        self.rec = {}

    def run(self, name, fn, observe=False, clock=False):
        from repro_torch import obs
        from repro_torch.dist import StageClock, comm
        from repro_torch.kernels import posit_gemm as pg
        grid = self.grid
        comm.barrier(grid)
        sync = StageClock(grid.device).sync
        sync()
        grid.clock = StageClock(grid.device) if clock else None
        before = pg.launch_counts()
        t0 = time.perf_counter()
        with obs.scoped() if observe else contextlib.nullcontext() as m:
            out = fn()
        sync()
        wall = time.perf_counter() - t0
        after = pg.launch_counts()
        self.rec[name] = dict(
            wall_s=wall, launches={k: after[k] - before[k] for k in after},
            counters=({k: v for k, v in m.to_dict()["counters"].items()
                       if k.startswith("dist.")} if observe else None),
            stages_s=dict(grid.clock.secs) if clock else None)
        grid.clock = None
        return out


def _ft_report(rep):
    return dict(detections=rep.detections, retries=rep.retries,
                failed=rep.failed, sites=list(rep.sites))


DIST_RANK_KEYS = ("gemm_a", "gemm_b", "ks_a", "ks_b", "lu", "chol", "ir_a",
                  "ir_b", "ir_spd", "ir_spd_b", "ft_lu", "ft_chol", "ft_a",
                  "ft_b")


def dist_rank(grid, cfg, ckpt_dir):
    """The body of each rank of the 2x2 grid: every [dist ...] cell in
    turn.  Rank 0 returns the gathered words and a copy of the first
    kernel GEMM of the pdgemm cells and the LU and Cholesky (operands
    and output, for phase_dist to hold to the plain version); every rank
    its records and its kernel launches (counted from zero over the whole
    body)."""
    from repro_torch import ft
    from repro_torch.dist import (distribute, p_rgesv_ir, p_rgetrf,
                                  p_rgetrf_ft, p_rposv_ir, p_rpotrf,
                                  p_rpotrf_ft, pdgemm, pdgemm_ft)
    from repro_torch.kernels import posit_gemm as pg
    dev, nb, be = grid.device, cfg["nb"], "pallas_split3"
    x = dist_inputs(cfg, DIST_RANK_KEYS, dev)
    ph = _RankPhases(grid)
    words, reports, gemms = {}, {}, []
    lead = grid.rank == 0

    def keep(name, t):
        if lead:
            words[name] = t.cpu()

    def first_gemm(fn):
        """``fn()``, rank 0 keeping its first kernel GEMM call."""
        if not lead:
            return fn()
        with GemmRecorder(limit=1) as rec:
            out = fn()
        gemms.extend(rec.calls)
        return out

    def d(name):
        return distribute(x[name], grid, nb)
    pg.reset_launch_counts()
    # [dist gemm]
    ad, bd = d("gemm_a"), d("gemm_b")
    for backend in ("pallas_split3", "xla_quire"):
        c = ph.run(f"gemm.{backend}",
                   lambda: first_gemm(lambda: pdgemm(ad, bd,
                                                     backend=backend)),
                   observe=True, clock=True)
        keep(f"gemm.{backend}", c.gather())
    ka, kb = d("ks_a"), d("ks_b")
    c = ph.run("gemm.k_split", lambda: pdgemm(ka, kb, backend="quire_exact",
                                              k_split=True), observe=True)
    keep("gemm.k_split", c.gather())
    # [dist lu], [dist chol]
    a = d("lu")
    lu, ipiv = ph.run("lu", lambda: first_gemm(lambda: p_rgetrf(a, be)),
                      observe=True, clock=True)
    keep("lu", lu.gather())
    keep("lu.ipiv", ipiv)
    a = d("chol")
    l_d = ph.run("chol", lambda: first_gemm(lambda: p_rpotrf(a, be)),
                 observe=True, clock=True)
    keep("chol", l_d.gather())
    # [dist ir]
    it = cfg["ir"]["iters"]
    a, s = d("ir_a"), d("ir_spd")
    (hi, lo), _ = ph.run("ir.rgesv_ir",
                         lambda: p_rgesv_ir(a, x["ir_b"], it, be))
    keep("ir.rgesv_ir.hi", hi)
    keep("ir.rgesv_ir.lo", lo)
    (hi, lo), _ = ph.run("ir.rposv_ir",
                         lambda: p_rposv_ir(s, x["ir_spd_b"], it, be))
    keep("ir.rposv_ir.hi", hi)
    keep("ir.rposv_ir.lo", lo)
    # [dist ft]
    a, s = d("ft_lu"), d("ft_chol")
    lu, ipiv = ph.run("ft.rgetrf", lambda: p_rgetrf(a, be))
    keep("ft.rgetrf", lu.gather())
    keep("ft.rgetrf.ipiv", ipiv)
    lu, ipiv, rep = ph.run("ft.rgetrf_ft", lambda: p_rgetrf_ft(a, be))
    keep("ft.rgetrf_ft", lu.gather())
    keep("ft.rgetrf_ft.ipiv", ipiv)
    reports["rgetrf_ft"] = _ft_report(rep)
    keep("ft.rpotrf", ph.run("ft.rpotrf", lambda: p_rpotrf(s, be)).gather())
    out, rep = ph.run("ft.rpotrf_ft", lambda: p_rpotrf_ft(s, be))
    keep("ft.rpotrf_ft", out.gather())
    reports["rpotrf_ft"] = _ft_report(rep)
    plan = ft.FaultPlan((ft.Fault(site="dist.panel", step=1, lane=5, bit=12,
                                  dev=cfg["ft"]["panel_dev"]),))
    out, rep = ph.run("ft.rpotrf_ft.panel",
                      lambda: p_rpotrf_ft(s, be, plan=plan))
    keep("ft.rpotrf_ft.panel", out.gather())
    reports["rpotrf_ft.panel"] = _ft_report(rep)
    stop = cfg["ft"]["stop_after"]
    killed = ph.run("ft.killed", lambda: p_rgetrf_ft(
        a, be, checkpoint_dir=ckpt_dir, _stop_after=stop))
    reports["killed"] = killed[0] is None
    lu, ipiv, _ = ph.run("ft.resumed", lambda: p_rgetrf_ft(
        a, be, checkpoint_dir=ckpt_dir, resume=True))
    keep("ft.resumed", lu.gather())
    keep("ft.resumed.ipiv", ipiv)
    ad, bd = d("ft_a"), d("ft_b")
    keep("ft.pdgemm", ph.run("ft.pdgemm", lambda: first_gemm(
        lambda: pdgemm(ad, bd, backend=be))).gather())
    for site in ("pdgemm.a", "pdgemm.b"):
        plan = ft.FaultPlan((ft.Fault(site=site, step=0, lane=7, bit=20,
                                      dev=cfg["ft"]["gemm_dev"]),))
        out, rep = ph.run(f"ft.{site}", lambda: pdgemm_ft(
            ad, bd, backend=be, plan=plan))
        keep(f"ft.{site}", out.gather())
        reports[site] = _ft_report(rep)
    gemms = [(name, a.cpu(), b.cpu(), kw, out.cpu())
             for name, a, b, kw, out in gemms]
    return dict(rank=grid.rank, words=words, reports=reports, gemms=gemms,
                phases=ph.rec, launches=pg.launch_counts())


def nccl_rank(grid, cfg):
    """The 1x1 NCCL grid: pdgemm and p_rgetrf at [dist ft]'s sizes, with
    the tiles and the collectives on the card."""
    from repro_torch.dist import distribute, p_rgetrf, pdgemm
    from repro_torch.kernels import posit_gemm as pg
    dev, nb, be = grid.device, cfg["nb"], "pallas_split3"
    x = dist_inputs(cfg, ("ft_a", "ft_b", "ft_lu"), dev)
    ph = _RankPhases(grid)
    pg.reset_launch_counts()
    ad = distribute(x["ft_a"], grid, nb)
    bd = distribute(x["ft_b"], grid, nb)
    c = ph.run("nccl.pdgemm", lambda: pdgemm(ad, bd, backend=be),
               observe=True)
    a = distribute(x["ft_lu"], grid, nb)
    lu, ipiv = ph.run("nccl.lu", lambda: p_rgetrf(a, be), observe=True)
    return dict(words={"pdgemm": c.gather().cpu(), "lu": lu.gather().cpu(),
                       "lu.ipiv": ipiv.cpu()},
                phases=ph.rec, launches=pg.launch_counts())


def _sum_counts(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _stage_line(rec):
    st = dict(rec["stages_s"] or {})
    st["other"] = rec["wall_s"] - sum(st.values())
    return " ".join(f"{k} {v:.2f} s" for k, v in st.items())


def phase_dist(dev, smi, main_words):
    """The distributed path on the card: a 2x2 grid of four ranks
    (spawned; gloo collectives on host copies) runs every [dist ...] cell,
    and one NCCL rank beside them runs [dist nccl]; the words are held to
    the single-device words ([main]'s Cholesky, the rest computed here
    while the ranks run: the phase is host-bound, and the card and the
    host's cores have room for all six processes), the ``dist.*``
    counters to the plans, and rank 0's
    first kernel GEMM of each kernel cell to the plain version.  Prints each
    cell's wall (the slowest rank's) and, where timed by stage, rank 0's
    split into panel, trsm, update, collective, staging and other.  The
    ``dist`` path's launches are every rank's, summed."""
    import tempfile
    from repro_torch.dist import launch
    from repro_torch.dist.layout import BlockCyclic
    from repro_torch.dist.pblas import pdgemm_collective_plan
    from repro_torch.dist.pdecomp import pfactor_collective_plan
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    _build.lib()                   # the ranks load the library built here
    cfg = dist_config()
    (p, q), nb = cfg["grid"], cfg["nb"]
    be = "pallas_split3"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        grid = launch.spawn(dist_rank, p, q, Path(tmp) / "grid",
                            args=(cfg, str(Path(tmp) / "ckpt")),
                            backend="gloo", device="cuda", host_staging=True)
        nccl_grid = launch.spawn(nccl_rank, 1, 1, Path(tmp) / "nccl",
                                 args=(cfg,), backend="nccl",
                                 device="cuda:0")
        try:
            one = _dist_single(dist_inputs(
                cfg, [k for k in DIST_RANK_KEYS if k != "chol"], dev), nb, be)
        except BaseException:
            for proc in grid.procs + nccl_grid.procs:
                proc.kill()
            raise
        one_wall = time.perf_counter() - t0
        (nccl,) = nccl_grid.join(timeout=600)
        nccl_wall = time.perf_counter() - t0
        ranks = grid.join(timeout=900)
        grid_wall = time.perf_counter() - t0
    w = ranks[0]["words"]
    calls = [(name, a.to(dev), b.to(dev), kw, out.to(dev))
             for name, a, b, kw, out in ranks[0]["gemms"]]
    n_gemm, worst = check_path_gemms("dist", calls)
    check(n_gemm == 4, f"[dist] rank 0 kept {n_gemm} GEMMs, expected 4")
    say(f"[dist] rank 0's first kernel GEMM of pdgemm {DIST_GEMM}, p_rgetrf "
        f"n={DIST_LU}, p_rpotrf n={DIST_CHOL} and pdgemm {DIST_FT['gemm']}^3: "
        + ", ".join(f"{name} {tuple(a.shape)} @ {tuple(b.shape)}"
                    f"{' (B transposed)' if b.stride(-2) == 1 else ''}"
                    for name, a, b, _, _ in calls)
        + ", held to the plain version on their own operands: within "
        "sqrt(K)*8e-8 of the exact product, fused words == encode(± kernel "
        f"f32); max|kernel-plain| {worst:.3e}")

    def wall(name):
        return max(r["phases"][name]["wall_s"] for r in ranks)

    def eq(name, want):
        return same_bits(w[name], want)
    report = dict(grid=f"{p}x{q}", grid_wall_s=grid_wall,
                  nccl_wall_s=nccl_wall,
                  phases={k: [r["phases"][k] for r in ranks]
                          for k in ranks[0]["phases"]},
                  nccl=nccl["phases"], reports=ranks[0]["reports"])

    # [dist gemm]
    m, k, n = DIST_GEMM
    la = BlockCyclic(m=m, n=k, nb=nb, p=p, q=q)
    lb = BlockCyclic(m=k, n=n, nb=nb, p=p, q=q)
    for backend in ("pallas_split3", "xla_quire"):
        name = f"gemm.{backend}"
        check(eq(name, one[name]),
              f"[dist gemm] pdgemm {backend} {DIST_GEMM} != rgemm")
        plan = pdgemm_collective_plan(la, lb)
        for r in ranks:
            got = _dist_bytes(r["phases"][name]["counters"], "pdgemm")
            check(got == plan, f"[dist gemm] rank {r['rank']} counted "
                  f"{got}, plan {plan}")
        rec = ranks[0]["phases"][name]
        say(f"[dist gemm] pdgemm {backend} {DIST_GEMM} on {p}x{q} == "
            f"single-device rgemm; wall {wall(name):.3f} s (rank 0: "
            f"{_stage_line(rec)}); launches/rank "
            f"{json.dumps({k: v for k, v in rec['launches'].items() if v})}"
            f"; bytes/rank {json.dumps(plan)} == plan [{smi}]")
    km, kk, kn = DIST_KSPLIT
    check(eq("gemm.k_split", one["gemm.k_split"]),
          f"[dist gemm] k_split {DIST_KSPLIT} != rgemm quire_exact")
    plan = pdgemm_collective_plan(BlockCyclic(m=km, n=kk, nb=nb, p=p, q=q),
                                  BlockCyclic(m=kk, n=kn, nb=nb, p=p, q=q),
                                  k_split=True)
    for r in ranks:
        got = _dist_bytes(r["phases"]["gemm.k_split"]["counters"], "pdgemm")
        check(got == plan, f"[dist gemm] k_split rank {r['rank']} counted "
              f"{got}, plan {plan}")
    say(f"[dist gemm] pdgemm quire_exact k_split {DIST_KSPLIT} == "
        f"single-device rgemm; wall {wall('gemm.k_split'):.3f} s; "
        f"bytes/rank {json.dumps(plan)} == plan [{smi}]")

    # [dist lu]: held to the single-device LU; [dist chol]: to [main]'s
    check(eq("lu", one["lu"]) and eq("lu.ipiv", one["lu.ipiv"]),
          f"[dist lu] p_rgetrf n={DIST_LU} != single-device rgetrf "
          "words/ipiv")
    check(eq("chol", main_words["rpotrf"][0]),
          f"[dist chol] p_rpotrf n={DIST_CHOL} != [main]'s rpotrf words")
    for name, algo, nn, tag in (("lu", "getrf", DIST_LU, "dist lu"),
                                ("chol", "potrf", DIST_CHOL, "dist chol")):
        lay = BlockCyclic(m=nn, n=nn, nb=nb, p=p, q=q)
        plan = pfactor_collective_plan(lay, algo)
        for r in ranks:
            got = _dist_bytes(r["phases"][name]["counters"],
                              "r" + algo)
            check(got == plan, f"[{tag}] rank {r['rank']} counted {got}, "
                  f"plan {plan}")
        rec = ranks[0]["phases"][name]
        steps = -(-nn // nb)
        strip = 4 * p * lay.lm * lay.ln
        extra = (f"; the {steps} strip gathers {steps} x "
                 f"{strip / 2**20:.0f} MiB" if algo == "getrf" else "")
        held = ("single-device words and ipiv" if algo == "getrf"
                else "[main]'s words")
        say(f"[{tag}] p_r{algo} n={nn} nb={nb} {be} on {p}x{q} == {held}; "
            f"wall {wall(name):.2f} s (rank 0: {_stage_line(rec)}); GEMM "
            f"launches/rank {rec['launches']['posit_gemm_f32']} (pre-pass "
            f"{rec['launches']['decode_planes']}); bytes/rank "
            f"{json.dumps(plan)} == plan{extra} [{smi}]")
        report[name + "_bytes"] = plan

    # [dist ir]
    it = DIST_IR["iters"]
    for drv in ("rgesv_ir", "rposv_ir"):
        check(all(eq(f"ir.{drv}.{h}", one[f"ir.{drv}.{h}"])
                  for h in ("hi", "lo")),
              f"[dist ir] p_{drv} pair != single-device {drv}")
    say(f"[dist ir] p_rgesv_ir / p_rposv_ir n={DIST_IR['n']} iters={it} "
        f"{be} on {p}x{q}: pair words == single-device rgesv_ir / "
        f"rposv_ir; wall {wall('ir.rgesv_ir'):.2f} / "
        f"{wall('ir.rposv_ir'):.2f} s [{smi}]")

    # [dist ft]
    reps = ranks[0]["reports"]
    lu1, piv1, l1, g1 = (one[k] for k in ("ft.rgetrf", "ft.rgetrf.ipiv",
                                          "ft.rpotrf", "ft.pdgemm"))
    check(eq("ft.rgetrf", lu1) and eq("ft.rgetrf.ipiv", piv1)
          and eq("ft.rpotrf", l1) and eq("ft.pdgemm", g1),
          "[dist ft] the plain drivers != single-device words")
    check(eq("ft.rgetrf_ft", lu1) and eq("ft.rgetrf_ft.ipiv", piv1)
          and reps["rgetrf_ft"]["detections"] == 0,
          f"[dist ft] p_rgetrf_ft fault-free: {reps['rgetrf_ft']}")
    check(eq("ft.rpotrf_ft", l1) and reps["rpotrf_ft"]["detections"] == 0,
          f"[dist ft] p_rpotrf_ft fault-free: {reps['rpotrf_ft']}")
    rp = reps["rpotrf_ft.panel"]
    check(eq("ft.rpotrf_ft.panel", l1) and rp["detections"] == 1
          and rp["retries"] == 1, f"[dist ft] panel fault: {rp}")
    check(reps["killed"] and eq("ft.resumed", lu1)
          and eq("ft.resumed.ipiv", piv1),
          "[dist ft] kill + resume != the uninterrupted words")
    for site in ("pdgemm.a", "pdgemm.b"):
        rs = reps[site]
        check(eq(f"ft.{site}", g1) and rs["detections"] == 1
              and rs["retries"] == 1, f"[dist ft] {site} fault: {rs}")
    say(f"[dist ft] {p}x{q} {be}: p_rgetrf_ft n={DIST_FT['lu']} and "
        f"p_rpotrf_ft n={DIST_FT['chol']} fault-free == plain == "
        f"single-device, 0 detections (walls {wall('ft.rgetrf_ft'):.2f} / "
        f"{wall('ft.rpotrf_ft'):.2f} s vs plain {wall('ft.rgetrf'):.2f} / "
        f"{wall('ft.rpotrf'):.2f} s); dist.panel fault on rank "
        f"{DIST_FT['panel_dev']}: {rp['detections']} detection, "
        f"{rp['retries']} retry, words identical; killed after step "
        f"{DIST_FT['stop_after']} and resumed: identical (walls "
        f"{wall('ft.killed'):.2f} + {wall('ft.resumed'):.2f} s); pdgemm_ft "
        f"{DIST_FT['gemm']}^3 with a fault in pdgemm.a / pdgemm.b on rank "
        f"{DIST_FT['gemm_dev']}: 1 detection + 1 retry each, words "
        f"identical [{smi}]")

    # [dist nccl]: [dist ft]'s sizes
    check(same_bits(nccl["words"]["pdgemm"], g1)
          and same_bits(nccl["words"]["lu"], lu1)
          and same_bits(nccl["words"]["lu.ipiv"], piv1),
          "[dist nccl] 1x1 NCCL words != single-device words")
    say(f"[dist nccl] 1x1 NCCL grid on the card: pdgemm "
        f"{DIST_FT['gemm']}^3 and p_rgetrf n={DIST_FT['lu']} == "
        f"single-device words; walls "
        f"{nccl['phases']['nccl.pdgemm']['wall_s']:.3f} / "
        f"{nccl['phases']['nccl.lu']['wall_s']:.2f} s (process start and "
        f"NCCL set-up included in its {nccl_wall:.1f} s from spawn to end)"
        f" [{smi}]")
    counts = _sum_counts(*(r["launches"] for r in ranks), nccl["launches"])
    report["phase_wall_s"] = time.perf_counter() - t_phase
    say(f"[dist] launches on the dist path (all ranks): "
        f"{json.dumps(counts)}; walls from the spawn: the single-device "
        f"words {one_wall:.1f} s, the NCCL rank {nccl_wall:.1f} s, the 2x2 "
        f"grid {grid_wall:.1f} s (all three at once); the phase "
        f"{report['phase_wall_s']:.1f} s")
    check(counts["posit_gemm_f32_simple"] == counts["posit_gemm_simple"] == 0,
          "the simple kernel was launched on the dist path")
    return report, counts


def _dist_single(x, nb, be):
    """The single-device words the [dist ...] cells are held to, by key
    of the ranks' words."""
    from repro_torch.kernels.ops import rgemm
    from repro_torch.lapack import decomp, refine
    one = {f"gemm.{b}": rgemm(x["gemm_a"], x["gemm_b"], backend=b)
           for b in ("pallas_split3", "xla_quire")}
    one["gemm.k_split"] = rgemm(x["ks_a"], x["ks_b"], backend="quire_exact")
    one["lu"], one["lu.ipiv"] = decomp.rgetrf(x["lu"], nb, be)
    it = DIST_IR["iters"]
    for drv, a, b in (("rgesv_ir", "ir_a", "ir_b"),
                      ("rposv_ir", "ir_spd", "ir_spd_b")):
        (one[f"ir.{drv}.hi"], one[f"ir.{drv}.lo"]), _ = getattr(
            refine, drv)(x[a], x[b], it, nb, be)
    one["ft.rgetrf"], one["ft.rgetrf.ipiv"] = decomp.rgetrf(x["ft_lu"], nb,
                                                            be)
    one["ft.rpotrf"] = decomp.rpotrf(x["ft_chol"], nb, be)
    one["ft.pdgemm"] = rgemm(x["ft_a"], x["ft_b"], backend=be)
    return one


def _dist_bytes(counters, op):
    pre, suf = f"dist.{op}.", ".bytes"
    return {k[len(pre):-len(suf)]: int(v) for k, v in counters.items()
            if k.startswith(pre) and k.endswith(suf)}


def tree_to(tree, dev):
    """A param or cache tree with every tensor moved to ``dev`` (names
    and other leaves kept)."""
    import torch
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev) if torch.is_tensor(tree) else tree


def rel_err(got, want) -> float:
    import torch
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def np_rel(got, want) -> float:
    """``rel_err`` of two numpy arrays."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def phase_models(dev, smi):
    """Each family's tiny model (policy f32) on the card against the same
    port on the CPU from the same seeded weights: the prefill forward's
    logits, then the decode path over the prompt and three steps more
    (f32 caches; the CPU's tokens fed to both), every logit vector within
    MODEL_RTOL.  A p16e1-quantized tiny qwen2 with the kernel backend:
    one skinny GEMM launch per linear (M = 16), logits within
    MODEL_QUANT_RTOL of its plain CPU run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_tiny_config
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.models import (forward_prefill, init_cache,
                                    init_params, serve_step)
    from repro_torch.serving import QuantConfig, quantize_params
    from repro_torch.serving.engine import _build_cross_kv
    report = {}
    for arch in MODEL_ARCHS:
        cfg = get_tiny_config(arch, policy="f32")
        cpu = init_params(0, cfg, device="cpu")
        gpu = tree_to(cpu, dev)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
        batch = {"tokens": toks}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        if cfg.family == "vlm":
            batch["vis"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.vis_tokens, cfg.d_model)).astype(np.float32))
        errs = [rel_err(forward_prefill(gpu, tree_to(batch, dev), cfg),
                        forward_prefill(cpu, batch, cfg))]
        caches = []
        for params, d in ((cpu, torch.device("cpu")), (gpu, dev)):
            cache = init_cache(cfg, 2, 16, dtype=torch.float32, device=d)
            if cfg.family == "encdec":
                cache = _build_cross_kv(params, cfg, cache,
                                        {"frames": batch["frames"]})
            caches.append(cache)
        tok = toks[:, :1]
        for t in range(toks.shape[1] + 3):
            c_log, caches[0] = serve_step(cpu, caches[0], tok, t, cfg)
            g_log, caches[1] = serve_step(gpu, caches[1], tok.to(dev), t,
                                          cfg)
            errs.append(rel_err(g_log, c_log))
            tok = toks[:, t + 1:t + 2] if t + 1 < toks.shape[1] else \
                torch.argmax(c_log, dim=-1).to(torch.int32)[:, None]
        worst = max(errs)
        check(worst < MODEL_RTOL, f"[models] {arch}: logits on the card "
              f"{worst:.3g} from the CPU's (relative), limit {MODEL_RTOL}")
        report[arch] = dict(family=cfg.family, rel_errs=errs)
        say(f"[models] {arch} ({cfg.family}, {cfg.n_layers} layers): "
            "prefill, then 8 prompt tokens and 3 decode steps through the "
            "decode path, max relative logit difference card vs CPU "
            f"{worst:.3e} (limit {MODEL_RTOL})")
    cfg = get_tiny_config("qwen2-0.5b", policy="f32")
    q_cpu = quantize_params(init_params(0, cfg, device="cpu"),
                            QuantConfig(fmt="p16e1", backend="pallas"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    before = pg.launch_counts()
    got = forward_prefill(tree_to(q_cpu, dev), {"tokens": toks.to(dev)}, cfg)
    torch.cuda.synchronize()
    after = pg.launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] - before[k]}
    err = rel_err(got, forward_prefill(q_cpu, {"tokens": toks}, cfg))
    want = 7 * cfg.n_layers
    check(launches == {"quant_gemm_f32": want},
          f"[models] quantized qwen2: launches {launches}, expected {want} "
          "skinny GEMM launches (one per linear) and no encode, pre-pass or "
          "tiled GEMM launch")
    check(err < MODEL_QUANT_RTOL, f"[models] quantized qwen2 on the kernel: "
          f"logits {err:.3g} from the plain CPU run, limit {MODEL_QUANT_RTOL}")
    say(f"[models] qwen2 tiny, p16e1 weights, kernel backend: {want} skinny "
        f"GEMM launches, logits {err:.3e} from the plain split3 CPU run "
        f"(limit {MODEL_QUANT_RTOL}) [{smi}]")
    report["quantized_qwen2"] = dict(rel_err=err, launches=launches)
    return report


class ServeClock:
    """Wraps the engine's decode step and its prefill: the wall of each
    call (a device sync on either side), the prompt tokens prefilled,
    and, with ``record``, the kernel GEMMs of the first decode step
    (``GemmRecorder``)."""

    def __init__(self, record=False):
        self.step_s, self.prefill_s = [], []
        self.prefill_tokens = 0
        self.record = record
        self.first_gemms = None

    def __enter__(self):
        import torch
        from repro_torch.serving import engine
        self.mod = engine
        self.saved = (engine._engine_step, engine._prefill_scan)
        step, pre = self.saved

        def timed_step(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if self.record and self.first_gemms is None:
                with GemmRecorder() as rec:
                    out = step(*a, **kw)
                self.first_gemms = rec.calls
            else:
                out = step(*a, **kw)
            torch.cuda.synchronize()
            self.step_s.append(time.perf_counter() - t0)
            return out

        def timed_prefill(params, cache, prompts, plen, cfg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pre(params, cache, prompts, plen, cfg)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)
            self.prefill_tokens += int(plen)
            return out
        engine._engine_step, engine._prefill_scan = timed_step, timed_prefill
        return self

    def __exit__(self, *exc):
        self.mod._engine_step, self.mod._prefill_scan = self.saved
        return False


def phase_serve(dev, smi):
    """qwen2-0.5b at full width through the serving path: seeded weights
    quantized to p16e1 with the kernel backend, the paged p16e1 KV pool,
    a seeded trace replayed batched (4 in flight) and sequentially (1):
    the tokens equal bit for bit; every linear of every step and prefill
    token on the skinny GEMM kernel, with no tiled, pre-pass or separate
    activation-encode launch (launches counted from zero around the two
    replays); the first sequential decode step's 168 skinny GEMMs equal to
    the tiled chain bit for bit and held to the plain version; at each of
    their four shapes, on the layer-0 leaves, the skinny kernel equal to
    the tiled chain at M in SKINNY_IDENTITY_MS and SKINNY_M_MAX, and the
    encode and pre-pass kernels to their plain versions; quant_matmul's
    kernel backend within 1e-3 of the decoded-matmul one; 2.0x weight and
    KV storage; the serve.* counters equal the engine's counts.  Times
    the replay, the decode step, the prefill per token, at each shape the
    skinny kernel and the tiled chain in turns (also at SKINNY_SWEEP_MS
    rows), the pre-pass + tiled GEMM, torch.matmul and quant_matmul, and
    profiles three decode steps."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import posit
    from repro_torch.core.formats import P16E1
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.models import init_params
    from repro_torch.serving import (Engine, QuantConfig, TrafficConfig,
                                     param_bytes, quantize_params, replay,
                                     synth_trace)
    from repro_torch.serving import quantize as qz
    from repro_torch.serving.kv_cache import kv_layer_indices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH, policy="f32")
    params = init_params(0, cfg, dev)
    n_params = param_bytes(params)["f32_bytes"] // 4
    qp = quantize_params(params, QuantConfig(fmt="p16e1", backend="pallas"))
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    pb = param_bytes(qp)
    check(pb["q_f32_bytes"] == 2 * pb["word_bytes"],
          f"[serve] weight storage {pb}: not 2.0x")
    trace = synth_trace(TrafficConfig(vocab=cfg.vocab, **SERVE_TRAFFIC))
    say(f"[serve] {cfg.name}: {n_params} params, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; p16e1 words "
        f"{pb['word_bytes']} B + scales {pb['scale_bytes']} B against "
        f"{pb['q_f32_bytes']} B f32 (2.0x); init + quantize {setup_s:.2f} s;"
        f" trace: {len(trace)} requests, prompts "
        f"{[len(r.prompt) for r in trace]}, max_new "
        f"{[r.max_new for r in trace]}")

    def engine(inflight):
        return Engine(qp, cfg, kv_fmt="p16e1", max_inflight=inflight,
                      **SERVE_ENGINE)

    pg.reset_launch_counts()
    eng_b = engine(SERVE_ENGINE["max_batch"])
    kb = eng_b.kv_bytes()
    check(kb["f32_bytes"] == 2 * kb["bytes"], f"[serve] KV pool {kb}: not "
          "2.0x")
    with obs.scoped() as m, ServeClock() as clock_b:
        rep_b = replay(eng_b, trace)
    with ServeClock(record=True) as clock_s:
        rep_s = replay(engine(1), trace)
    torch.cuda.synchronize()
    counts = pg.launch_counts()
    for rid, toks in rep_b["outputs"].items():
        check(np.array_equal(toks, rep_s["outputs"][rid]),
              f"[serve] request {rid}: batched tokens {toks.tolist()} != "
              f"sequential {rep_s['outputs'][rid].tolist()}")
    check(len(rep_b["outputs"]) == len(trace), "[serve] not every request "
          "finished")
    # every linear of every decode step and prefill token: one skinny GEMM
    # launch; every decode step and admission also encodes its K and V rows
    # once per attention layer
    linears = 7 * cfg.n_layers
    calls = sum(len(c.step_s) + c.prefill_tokens for c in (clock_b, clock_s))
    kv_writes = 2 * len(kv_layer_indices(cfg)) * sum(
        len(c.step_s) + len(c.prefill_s) for c in (clock_b, clock_s))
    check(counts["quant_gemm_f32"] == linears * calls
          and counts["encode_posit_f32"] == kv_writes
          and all(counts[k] == 0 for k in (
              "posit_gemm_f32", "decode_planes", "posit_gemm",
              "posit_gemm_f32_simple", "posit_gemm_simple",
              "decode_split_f32")),
          f"[serve] launches {counts}, expected {linears} skinny GEMM "
          f"launches for each of {calls} decode steps and prefill tokens, "
          f"{kv_writes} K/V encodes, and no tiled GEMM, pre-pass or "
          "activation-encode launch")
    c = m.to_dict()
    check(c["counters"].get("serve.steps") == rep_b["steps"]
          == eng_b.step_count and c["counters"].get("serve.tokens")
          == rep_b["tokens"] == sum(len(v) for v in
                                    rep_b["outputs"].values()),
          f"[serve] counters {c['counters']} != the engine's steps "
          f"{rep_b['steps']} / tokens {rep_b['tokens']}")
    check(0.0 <= c["gauges"]["serve.batch_occupancy"] <= 1.0
          and c["gauges"]["serve.kv_pages_in_use"] < eng_b.spec.n_pages,
          f"[serve] gauges {c['gauges']}")
    n_gemms, worst = check_quant_gemms("serve", clock_s.first_gemms)
    shapes = sorted({(a.shape[0], a.shape[1], b.shape[1])
                     for _, a, b, _, _ in clock_s.first_gemms})
    m_rows = SERVE_ENGINE["max_batch"]
    want_shapes = sorted({(m_rows, cfg.d_model, cfg.d_q),
                          (m_rows, cfg.d_model, cfg.d_kv),
                          (m_rows, cfg.d_model, cfg.d_ff),
                          (m_rows, cfg.d_ff, cfg.d_model)})
    check(n_gemms == linears and shapes == want_shapes,
          f"[serve] first decode step: {n_gemms} GEMMs at {shapes}, "
          f"expected {linears} at {want_shapes}")
    step_ms = 1e3 * float(np.mean(clock_b.step_s))
    prefill_ms = 1e3 * sum(clock_b.prefill_s) / clock_b.prefill_tokens
    say(f"[serve] batched (max_inflight {SERVE_ENGINE['max_batch']}) == "
        f"sequential tokens for all {len(trace)} requests; batched replay: "
        f"{rep_b['tokens']} tokens, {rep_b['requests']} requests in "
        f"{rep_b['wall_s']:.3f} s = {rep_b['tok_s']:.3f} tok/s, "
        f"{rep_b['req_s']:.4f} req/s, {rep_b['steps']} engine steps "
        f"({len(clock_b.step_s)} decode steps at {step_ms:.2f} ms each, "
        f"occupancy {rep_b['occupancy']:.3f}), prefill "
        f"{clock_b.prefill_tokens} tokens at {prefill_ms:.2f} ms a token; "
        f"sequential replay {rep_s['wall_s']:.3f} s ({rep_s['tok_s']:.3f} "
        f"tok/s, {len(clock_s.step_s)} decode steps) [{smi}]")
    say(f"[serve] launches on the serve path (both replays): "
        f"{json.dumps(counts)} ({linears} x {calls} GEMMs, {kv_writes} "
        f"K/V encodes); counters "
        f"{json.dumps(c['counters'])}; the first decode step's {n_gemms} "
        f"skinny GEMMs equal to the tiled chain bit for bit and within "
        f"sqrt(K)*8e-8 of the exact product, "
        f"max|kernel-plain| {worst:.3e}")

    # Per shape, on the real layer-0 leaves: the skinny kernel against the
    # tiled chain (encode, widen, pre-pass, tiled kernel, scale) bit for bit
    # at several M; the two in turns (CUDA graphs of 20) at the path's M and
    # at SKINNY_SWEEP_MS; the pre-pass + tiled GEMM alone (the serve path's
    # kernel time before the skinny kernel) and its pre-pass; the plain
    # version; torch.matmul f32 on the decoded words (the xla backend's
    # product); quant_matmul's two backends on the host clock.
    leaf_of = {(cfg.d_model, cfg.d_q): qp["layers"][0]["attn"]["wq"]["w"],
               (cfg.d_model, cfg.d_kv): qp["layers"][0]["attn"]["wk"]["w"],
               (cfg.d_model, cfg.d_ff): qp["layers"][0]["ffn"]["w_up"]["w"],
               (cfg.d_ff, cfg.d_model):
                   qp["layers"][0]["ffn"]["w_down"]["w"]}
    rng = np.random.default_rng(5)
    timings, sweep, kernel_row = [], [], None
    for shape in shapes:
        mm, kk, nn = shape
        leaf = leaf_of[(kk, nn)]
        w, sx = leaf["qw"], leaf["sexp"]

        def skinny(x_, w=w, sx=sx):
            return pg.quant_gemm_f32(x_, w, sx, P16E1)

        def chain(x_, w=w, sx=sx):
            return tiled_quant_chain(x_, w, sx, P16E1)

        def act(rows, kk=kk):
            return torch.from_numpy(rng.standard_normal((rows, kk)).astype(
                np.float32)).to(dev)
        for rows in sorted({*SKINNY_IDENTITY_MS, pg.SKINNY_M_MAX}):
            xr = act(rows)
            check(same_bits(skinny(xr), chain(xr)), f"[serve] {shape}: the "
                  f"skinny kernel != the tiled chain at M={rows}")
        x = act(mm)
        chain_ms, skinny_ms, raw = interleaved_ms(lambda: chain(x),
                                                  lambda: skinny(x))
        for rows in SKINNY_SWEEP_MS:
            xr = act(rows)
            c_ms, s_ms, _ = interleaved_ms(lambda: chain(xr),
                                           lambda: skinny(xr))
            sweep.append(dict(m=rows, k=kk, n=nn, skinny_ms=s_ms,
                              chain_ms=c_ms))
        xw, w32 = pg.encode_posit_f32(x, P16E1), w.to(torch.int32)
        tiled_ms = graph_ms(lambda: pg.posit_gemm_f32(xw, w32, bk=32,
                                                      fmt=P16E1), 20)
        prepass_ms = graph_ms(lambda: pg.decode_planes(xw, w32, P16E1), 20)
        plain_ms = cuda_ms(lambda: pg.quant_gemm_f32_plain(x, w, sx, P16E1),
                           3)
        err = float((skinny(x) - pg.quant_gemm_f32_plain(x, w, sx, P16E1))
                    .abs().max())
        af = posit.to_float32_bits(xw, P16E1)
        bf = posit.to_float32_bits(w32, P16E1)
        matmul_ms = cuda_ms(lambda: torch.matmul(af, bf), 20)
        # from the stored words: int16 words, f32 x and y, int8 exponents
        flops = 2.0 * mm * kk * nn
        nbytes = 2.0 * kk * nn + 4.0 * (mm * kk + mm * nn) + nn
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops > t_bytes else "bytes"
        # the path's other two kernels at this shape, against their plain
        # versions bit for bit: the activation encode and the pre-pass
        check(same_bits(xw, pg.encode_posit_f32_plain(x, P16E1))
              and all(p is None and q is None or same_bits(p, q)
                      for p, q in zip(pg.decode_planes(xw, w32, P16E1),
                                      pg.decode_planes_plain(xw, w32,
                                                             P16E1))),
              f"[serve] {shape}: the encode or pre-pass kernel differs "
              "from its plain version")
        xla = {**leaf, "qmeta": ("p16e1", "xla")}
        y_p, y_x = qz.quant_matmul(x, leaf), qz.quant_matmul(x, xla)
        qerr = rel_err(y_p, y_x)
        check(qerr < 1e-3, f"[serve] quant_matmul {shape}: pallas vs xla "
              f"{qerr:.3g}, the reference's bar 1e-3")
        qm_ms, _ = host_ms(lambda: qz.quant_matmul(x, leaf), 10)
        qx_ms, _ = host_ms(lambda: qz.quant_matmul(x, xla), 10)
        row = dict(shape=list(shape), skinny_ms=skinny_ms, chain_ms=chain_ms,
                   interleaved_ms=raw, tiled_ms=tiled_ms,
                   prepass_ms=prepass_ms, plain_ms=plain_ms,
                   matmul_f32_ms=matmul_ms, bound_ms=bound_ms, bound_by=by,
                   max_abs_err=err, quant_matmul_pallas_host_ms=qm_ms,
                   quant_matmul_xla_host_ms=qx_ms, pallas_vs_xla=qerr)
        timings.append(row)
        if tuple(shape) == SKINNY_ROW_SHAPE:
            kernel_row = dict(name="quant_gemm_f32", ms=skinny_ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=by, library_ms=matmul_ms,
                              max_abs_err=err, shape=list(shape))
        say(f"[serve] {shape} p16e1 bk=32: skinny kernel {skinny_ms:.4f} ms,"
            f" tiled chain (encode + widen + pre-pass + GEMM + scale) "
            f"{chain_ms:.4f} ms (chain, skinny, skinny, chain: "
            + ", ".join(f"{t:.4f}" for t in raw)
            + f"; CUDA graphs), {chain_ms / skinny_ms:.2f}x; pre-pass + "
            f"tiled GEMM {tiled_ms:.4f} ms (pre-pass {prepass_ms:.4f}); bound "
            f"{bound_ms:.5f} ms ({by}, from the int16 words), skinny at "
            f"{100 * bound_ms / skinny_ms:.1f} % of it; plain {plain_ms:.4f} "
            f"ms, max|skinny-plain| {err:.3e}; torch.matmul f32 on the "
            f"decoded words {matmul_ms:.4f} ms ({matmul_ms / skinny_ms:.2f}x "
            f"the skinny kernel); quant_matmul a call on the host clock: "
            f"pallas {qm_ms:.4f} ms, xla {qx_ms:.4f} ms, pallas vs xla "
            f"{qerr:.3e} [{smi}]")
    check(kernel_row is not None, f"[serve] no GEMM at {SKINNY_ROW_SHAPE}")
    say("[serve] skinny kernel vs tiled chain by rows M (ms, in turns; "
        f"quant_matmul takes the skinny kernel up to M={pg.SKINNY_M_MAX}): "
        + "; ".join(f"M={r['m']} ({r['k']}, {r['n']}) {r['skinny_ms']:.4f} "
                    f"/ {r['chain_ms']:.4f}" for r in sweep) + f" [{smi}]")
    busy = profile_decode_steps(engine, trace, cfg)
    table = qp["embed"]["table"]
    deq_ms = cuda_ms(lambda: qz.dequant_leaf(table), 5)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t_phase
    say(f"[serve] the tied table's dequantize ({cfg.vocab} x {cfg.d_model} "
        f"p16e1 words -> f32, every step's unembed) {deq_ms:.4f} ms; peak "
        f"device memory {peak / 2**30:.3f} GiB; phase wall {wall:.2f} s "
        f"[{smi}]")
    return dict(arch=cfg.name, n_params=n_params, param_bytes=pb,
                kv_bytes=kb, setup_s=setup_s,
                batched={k: v for k, v in rep_b.items() if k != "outputs"},
                sequential={k: v for k, v in rep_s.items() if k != "outputs"},
                decode_step_ms=step_ms, prefill_ms_per_token=prefill_ms,
                decode_steps=len(clock_b.step_s),
                prefill_tokens=clock_b.prefill_tokens,
                counters=c["counters"], first_step_gemms=n_gemms,
                max_abs_kernel_vs_plain=worst, shapes=timings,
                m_sweep=sweep, kernel_row=kernel_row,
                table_dequant_ms=deq_ms, peak_bytes=peak, profile=busy,
                wall_s=wall), counts


def dev_same_bits(x, y) -> bool:
    """``same_bits`` on the device (no copy to the host)."""
    import torch
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if not x.dtype.is_floating_point:
        return bool(torch.equal(x, y))
    ib = {8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()]
    return bool(((x.view(ib) == y.view(ib))
                 | (torch.isnan(x) & torch.isnan(y))).all())


class CodecRecorder:
    """While open, every call of the two codec kernels' wrappers (as
    ``core.policy`` makes them, through ``kernels.posit_gemm``) is held
    to the plain codec on its own operand, bit for bit: the encode's
    words to ``core.posit.from_float32_bits`` narrowed to the wire dtype,
    the decode's (hi, lo) to ``decode_split_f32_plain``.  ``calls``:
    (wrapper, format, shape, equal) per call."""

    def __init__(self):
        self.calls = []
        self.saved = None

    def open(self):
        from repro_torch.core import posit
        from repro_torch.kernels import posit_gemm as pg
        self.pg = pg
        self.saved = enc, dec = pg.encode_posit_f32, pg.decode_split_f32
        calls = self.calls

        def encode(x, fmt=pg.P32E2, out_dtype=None):
            import torch
            out_dtype = out_dtype or torch.int32
            out = enc(x, fmt, out_dtype=out_dtype)
            want = posit.from_float32_bits(x, fmt).to(out_dtype)
            calls.append(("encode_posit_f32", fmt.name, tuple(x.shape),
                          dev_same_bits(out, want)))
            return out

        def decode(p, fmt=pg.P32E2):
            hi, lo = dec(p, fmt)
            ph, pl = pg.decode_split_f32_plain(p, fmt)
            calls.append(("decode_split_f32", fmt.name, tuple(p.shape),
                          dev_same_bits(hi, ph) and dev_same_bits(lo, pl)))
            return hi, lo
        # the wrappers count their launches on the module's name, which
        # is these functions while they are open
        encode.launches, decode.launches = enc.launches, dec.launches
        pg.encode_posit_f32, pg.decode_split_f32 = encode, decode
        return self

    def close(self):
        if self.saved is not None:
            pg = self.pg
            enc, dec = self.saved
            enc.launches = pg.encode_posit_f32.launches
            dec.launches = pg.decode_split_f32.launches
            pg.encode_posit_f32, pg.decode_split_f32 = enc, dec
            self.saved = None


def _train_launches(before, after):
    return {k: after[k] - before[k] for k in after if after[k] - before[k]}


def phase_train(dev, smi):
    """qwen2-0.5b at its published widths through the training CLI's
    ``run`` (random weights from seed 0, batch/seq/lr of TRAIN_RUN):
    TRAIN_STEPS steps at each policy.  posit32: every linear's weights and
    activations through ``quantize`` on the encode and decode kernels, the
    first step's codec calls each held to the plain codec on its operand;
    bf16_opt16: the AdamW moments as p16e1 int16 words on the same
    kernels, exactly half the f32 moments' bytes.  Each run's losses are
    finite and its last below its first.  Prints each run's step time (host
    clock, a device sync a step, the steps after the first), tokens/s,
    peak memory and codec launches a step, and times the codec at the
    largest linear's weights.  Returns (report, the launches of both
    runs): the counts are set to 0 just before each ``run`` and read just
    after it, so the split step, the profiled step and the codec timings
    that follow a run are not in them."""
    import numpy as np
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import policy as pol
    from repro_torch.core.formats import P16E1, P32E2
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.launch.train import run
    cfg = get_config(TRAIN_ARCH)
    n_params = None
    report = {}
    train_counts = dict.fromkeys(pg.launch_counts(), 0)
    for policy, steps in TRAIN_STEPS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks, counts = [], []
        rec = CodecRecorder() if policy == "posit32" else None

        def on_step(step, metrics, rec=rec):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if rec is not None and step == 0:
                rec.close()
            counts.append(pg.launch_counts())
        pg.reset_launch_counts()       # before the recorder takes them
        before = pg.launch_counts()
        if rec is not None:
            rec.open()
        t0 = time.perf_counter()
        try:
            params, opt, losses = run(TRAIN_ARCH, smoke=False, steps=steps,
                                      policy=policy, device=dev,
                                      on_step=on_step, log_every=steps,
                                      **TRAIN_RUN)
        finally:
            if rec is not None:
                rec.close()
        for k, n in pg.launch_counts().items():
            train_counts[k] += n
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(w.numel() for w in tree.leaves(params))
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"[train] {policy}: losses {losses} not finite and falling")
        step_s = [b - a for a, b in zip(marks, marks[1:])]
        per_step = [_train_launches(a, b) for a, b in zip(counts, counts[1:])]
        check(all(c == per_step[0] for c in per_step)
              and all(per_step[0].get(k, 0) > 0 for k in
                      ("encode_posit_f32", "decode_split_f32")),
              f"[train] {policy}: codec launches a step {per_step}")
        step_ms = 1e3 * float(np.mean(step_s))
        tok_s = TRAIN_RUN["batch"] * TRAIN_RUN["seq"] / (step_ms / 1e3)
        r = dict(steps=steps, losses=losses, step_ms=step_ms,
                 step_ms_each=[1e3 * t for t in step_s], tokens_per_s=tok_s,
                 peak_bytes=peak, wall_s=wall, launches_per_step=per_step[0],
                 first_step_launches=_train_launches(before, counts[0]))
        extra = ""
        if rec is not None:
            bad = [c for c in rec.calls if not c[3]]
            check(rec.calls and not bad, f"[train] posit32 first step: "
                  f"{len(bad)} of {len(rec.calls)} codec calls differ from "
                  f"the plain codec: {bad[:4]}")
            kinds = {}
            for name, fmt, _, _ in rec.calls:
                kinds[f"{name}.{fmt}"] = kinds.get(f"{name}.{fmt}", 0) + 1
            r["first_step_codec_calls"] = kinds
            extra = (f"; the first step's {len(rec.calls)} codec calls "
                     f"({json.dumps(kinds)}) each equal to the plain codec "
                     "on its operand, bit for bit")
        else:
            moments = tree.leaves(opt["moments"])
            held = sum(t.numel() * t.element_size() for t in moments)
            check(all(t.dtype == torch.int16 for t in moments)
                  and 2 * held == 8 * n_params,
                  f"[train] bf16_opt16: moments {held} B, not int16 words "
                  f"half of {2 * 4 * n_params} B f32")
            r["moment_bytes"] = held
            extra = (f"; moments {len(moments)} int16 tensors, {held} B = "
                     f"half of the f32 moments' {2 * 4 * n_params} B")
        sp = train_step_split(dataclasses.replace(cfg, policy=policy),
                              params, opt, dev)
        r["split"] = sp
        report[policy] = r
        busy = ("not measured (no device time in the trace)"
                if sp["busy"] is None else
                f"device busy {sp['device_ms']:.2f} of "
                f"{sp['profiled_wall_ms']:.2f} ms ({100 * sp['busy']:.1f} %); "
                "by device time: " + "; ".join(
                    f"{t['name'][:40]} x{t['count']} {t['device_ms']:.2f} ms"
                    for t in sp["top"]))
        say(f"[train] {policy} one more step split: forward + backward "
            f"{sp['fwd_bwd_ms']:.2f} ms, AdamW {sp['adamw_ms']:.2f} ms (host "
            f"clock, syncs at the boundaries); profiled step: {busy} [{smi}]")
        say(f"[train] {cfg.name} {policy}: {n_params} params, {steps} steps "
            f"of batch {TRAIN_RUN['batch']} x seq {TRAIN_RUN['seq']}, lr "
            f"{TRAIN_RUN['lr']}: losses "
            + ", ".join(f"{v:.4f}" for v in losses)
            + f"; step {step_ms:.2f} ms (host clock, a sync a step, steps "
            f"2-{steps}: " + ", ".join(f"{1e3 * t:.2f}" for t in step_s)
            + f"), {tok_s:.1f} tokens/s; peak device memory "
            f"{peak / 2**30:.3f} GiB; codec launches a step "
            f"{json.dumps(per_step[0])}; run wall {wall:.2f} s{extra} "
            f"[{smi}]")
        if policy == "posit32":
            w = params["layers"][0]["ffn"]["w_down"]["w"]["w"]
            words = pg.encode_posit_f32(w, P32E2)
            q_ms = graph_ms(lambda: pol.quantize(w, "p32e2"), 10)
            e_ms = graph_ms(lambda: pg.encode_posit_f32(w, P32E2), 10)
            d_ms = graph_ms(lambda: pg.decode_split_f32(words, P32E2), 10)
            m16 = pol.encode_tensor(w, P16E1)
            m_ms = graph_ms(lambda: pol.decode_tensor(m16, P16E1), 10)
            n = w.numel()
            rate = PEAK_BYTES_PER_S
            ph, pl = pg.decode_split_f32_plain(words, P32E2)
            kh, kl = pg.decode_split_f32(words, P32E2)
            check(dev_same_bits(kh, ph) and dev_same_bits(kl, pl),
                  "[train] decode kernel != plain at the weight's shape")
            report["kernel_row"] = dict(
                name="decode_split_f32", ms=d_ms,
                plain_ms=cuda_ms(lambda: pg.decode_split_f32_plain(
                    words, P32E2), 3),
                bound_ms=12.0 * n / rate * 1e3, bound_by="bytes",
                library_ms=None, max_abs_err=0.0, shape=list(w.shape))
            report["codec_at_weight"] = dict(
                shape=list(w.shape), quantize_ms=q_ms, encode_ms=e_ms,
                decode_ms=d_ms, moment_decode_ms=m_ms,
                quantize_bound_ms=8.0 * n / rate * 1e3,
                encode_bound_ms=8.0 * n / rate * 1e3,
                decode_bound_ms=12.0 * n / rate * 1e3,
                moment_decode_bound_ms=6.0 * n / rate * 1e3)
            say(f"[train] the codec at the w_down weights {tuple(w.shape)} "
                f"(CUDA graphs of 10): quantize p32e2 {q_ms:.4f} ms (encode "
                f"+ decode + hi+lo; bound {8.0 * n / rate * 1e3:.4f} ms, "
                f"bytes), encode kernel {e_ms:.4f} ms (bound "
                f"{8.0 * n / rate * 1e3:.4f}), decode kernel {d_ms:.4f} ms "
                f"(bound {12.0 * n / rate * 1e3:.4f}), decode_tensor of "
                f"p16e1 moments {m_ms:.4f} ms (bound "
                f"{6.0 * n / rate * 1e3:.4f}) [{smi}]")
        del params, opt
    return report, train_counts


def train_step_split(cfg, params, opt, dev):
    """One more step of ``cfg`` on the run's final state, split on the
    host clock (a device sync at each boundary) into forward + backward
    and AdamW, then the whole step under ``torch.profiler``: the device's
    busy share (CUDA kernels' device time over the step's wall) and the
    kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ShapeCell
    from repro_torch.core.policy import torch_dtype
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import (_cast_params, _loss_and_grads,
                                          make_train_step)
    from repro_torch.optim import adamw_update
    pol = cfg.get_policy()
    batch = make_batch(cfg, ShapeCell("e2e", "train", TRAIN_RUN["seq"],
                                      TRAIN_RUN["batch"]), 1000,
                       batch_override=TRAIN_RUN["batch"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = _loss_and_grads(
        _cast_params(params, torch_dtype(pol.compute_dtype)), batch, cfg,
        remat=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(params, opt, grads, lr=TRAIN_RUN["lr"],
                 compress_moments=pol.opt_compression is not None)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    step = make_train_step(cfg, remat=False, lr=TRAIN_RUN["lr"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t3
    rows = [(getattr(e, "self_device_time_total", 0.0), e.key, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    device_s = sum(r[0] for r in rows) / 1e6
    top = sorted(rows, reverse=True)[:6]
    return dict(fwd_bwd_ms=1e3 * (t1 - t0), adamw_ms=1e3 * (t2 - t1),
                profiled_wall_ms=1e3 * wall,
                device_ms=1e3 * device_s if device_s else None,
                busy=device_s / wall if device_s else None,
                top=[dict(name=k, count=n, device_ms=t / 1e3)
                     for t, k, n in top])


def _grads_card_cpu(cfg, dev):
    """(loss, grads) of one forward/backward of tiny ``cfg`` on the CPU
    and on the card from the same seeded params and batch."""
    import torch
    from repro_torch.configs import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import _cast_params, _loss_and_grads
    from repro_torch.models import init_params
    cpu = init_params(0, cfg, device="cpu")
    batch = make_batch(cfg, ShapeCell("e2e", "train", 16, 2), 0,
                       device="cpu")
    out = []
    for p, b in ((cpu, batch), (tree_to(cpu, dev), tree_to(batch, dev))):
        loss, _, g = _loss_and_grads(_cast_params(p, torch.float32), b,
                                     cfg, remat=False)
        out.append((loss, g))
    return out


def leaves_rel(got, want) -> float:
    """``rel_err`` of two lists of tensors taken as one vector each."""
    import torch
    return rel_err(torch.cat([t.detach().cpu().double().ravel()
                              for t in got]),
                   torch.cat([t.detach().cpu().double().ravel()
                              for t in want]))


def phase_train_parity(dev, smi):
    """Card against CPU from the same seeded params and batch: the tiny
    configs of TRAIN_PARITY_ARCHS at policy f32 and posit32 (the codec
    kernels on the card, the plain codec on the host), ``forward_train``'s
    loss and its gradients (all leaves as one vector) within TRAIN_RTOL;
    then one ``make_train_step`` of tiny qwen2 at f32, posit32 and
    bf16_opt16, params and moments held the same way (bf16_opt16's bf16
    compute to TRAIN_BF16_RTOL, its p16e1 moment words counted apart and
    their largest distance in ulps printed)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import ShapeCell, get_tiny_config
    from repro_torch.core.policy import decode_tensor
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    report = {}
    for arch in TRAIN_PARITY_ARCHS:
        for policy in ("f32", "posit32"):
            cfg = get_tiny_config(arch, policy=policy)
            (cl, cg), (gl, gg) = _grads_card_cpu(cfg, dev)
            lerr = abs(float(gl) - float(cl)) / abs(float(cl))
            gerr = leaves_rel(tree.leaves(gg), tree.leaves(cg))
            worst = max(rel_err(a, b) for a, b in zip(tree.leaves(gg),
                                                      tree.leaves(cg))
                        if float(b.abs().max()) > 0)
            check(lerr < TRAIN_RTOL and gerr < TRAIN_RTOL,
                  f"[train parity] {arch} {policy}: loss {lerr:.3g}, grads "
                  f"{gerr:.3g} from the CPU's, limit {TRAIN_RTOL}")
            report[f"{arch}.{policy}"] = dict(loss_rel=lerr, grads_rel=gerr,
                                              worst_leaf_rel=worst)
            say(f"[train parity] {arch} ({cfg.family}) {policy}: loss "
                f"{float(gl):.6f} vs CPU {float(cl):.6f} ({lerr:.2e} "
                f"relative), gradients {gerr:.2e} (all leaves; worst leaf "
                f"{worst:.2e}), limit {TRAIN_RTOL}")
    for policy in ("f32", "posit32", "bf16_opt16"):
        cfg = get_tiny_config("qwen2-0.5b", policy=policy)
        compress = cfg.get_policy().opt_compression is not None
        cpu = init_params(0, cfg, device="cpu")
        batch = make_batch(cfg, ShapeCell("e2e", "train", 16, 2), 0,
                           device="cpu")
        outs = []
        for p, b in ((cpu, batch), (tree_to(cpu, dev), tree_to(batch, dev))):
            outs.append(make_train_step(cfg, remat=False, lr=1e-3)(
                p, adamw_init(p, compress_moments=compress), b))
        (cp, co, cm), (gp, go, gm) = outs
        tol = TRAIN_BF16_RTOL if policy == "bf16_opt16" else TRAIN_RTOL
        cmo, gmo = tree.leaves(co["moments"]), tree.leaves(go["moments"])
        apart = ulps = 0
        if compress:
            apart = sum(int((a.cpu() != b).sum()) for a, b in zip(gmo, cmo))
            ulps = max(int((a.cpu().int() - b.int()).abs().max())
                       for a, b in zip(gmo, cmo))
            cmo = [decode_tensor(t) for t in cmo]
            gmo = [decode_tensor(t) for t in gmo]
        lerr = abs(float(gm["loss"]) - float(cm["loss"])) / float(cm["loss"])
        perr = leaves_rel(tree.leaves(gp), tree.leaves(cp))
        merr = leaves_rel(gmo, cmo)
        check(lerr < tol and perr < tol and merr < tol,
              f"[train parity] make_train_step {policy}: loss {lerr:.3g}, "
              f"params {perr:.3g}, moments {merr:.3g}, limit {tol}")
        n = sum(t.numel() for t in cmo)
        report[f"step.{policy}"] = dict(loss_rel=lerr, params_rel=perr,
                                        moments_rel=merr, words_apart=apart,
                                        max_ulps=ulps, n_moments=n)
        say(f"[train parity] make_train_step tiny qwen2 {policy}: loss "
            f"{lerr:.2e}, params {perr:.2e}, moments {merr:.2e} relative "
            f"card vs CPU (limit {tol})"
            + (f"; p16e1 moment words: {apart} of {n} apart, at most {ulps} "
               "ulps (bf16 gradients differ by each op's bf16 rounding)"
               if compress else ""))
    return report


def phase_train_resume(dev, smi):
    """The smoke config (bf16_opt16: int16 moments in the checkpoint) on
    the card: TRAIN_RESUME['steps'] straight steps against half of them,
    a checkpoint, a fresh ``run`` that resumes from it and the rest; the
    resumed losses within 1e-5 relative of the straight run's."""
    import numpy as np
    import tempfile
    from repro_torch.launch.train import run
    steps = TRAIN_RESUME["steps"]
    kw = dict(steps=steps, batch=TRAIN_RESUME["batch"],
              seq=TRAIN_RESUME["seq"], ckpt_every=steps // 2, device=dev,
              policy=TRAIN_RESUME["policy"], log_every=steps)
    with tempfile.TemporaryDirectory() as tmp:
        _, _, straight = run(TRAIN_ARCH, ckpt_dir=f"{tmp}/a", **kw)
        run(TRAIN_ARCH, ckpt_dir=f"{tmp}/b", **dict(kw, steps=steps // 2))
        _, opt, resumed = run(TRAIN_ARCH, ckpt_dir=f"{tmp}/b", **kw)
    rel = np.abs(np.array(resumed) / np.array(straight[steps // 2:]) - 1)
    check(len(resumed) == steps - steps // 2 and int(opt["step"]) == steps
          and rel.max() < 1e-5,
          f"[train resume] resumed {resumed} vs straight {straight}")
    say(f"[train resume] smoke {TRAIN_ARCH} {TRAIN_RESUME['policy']}: "
        f"{steps} straight steps, losses "
        + ", ".join(f"{v:.6f}" for v in straight)
        + f"; {steps // 2} + checkpoint + restart + {steps - steps // 2}: "
        + ", ".join(f"{v:.6f}" for v in resumed)
        + f" (max {rel.max():.2e} relative, limit 1e-5)")
    return dict(straight=straight, resumed=resumed, max_rel=float(rel.max()))


def phase_train_dp(dev, smi):
    """Two ranks sharing the card (gloo on host copies), with nothing else
    running on it, policy posit_dp, TRAIN_DP['steps'] steps
    of ``make_train_step_compressed``: the losses within TRAIN_DP_RTOL of
    one process's ``make_train_step`` on the whole batch; the gradient
    sums' all-to-all and all-gather bytes each exactly half of an f32
    all-reduce of the compressed leaves (int16 words on both phases); the
    ranks' params equal; ``compressed_psum`` of (2, n) cases within 5e-3
    of the RMS of the plain sum.  The ranks' codec launches are not in the
    ``train`` path's count."""
    import numpy as np
    import torch_dist_cases as tdc
    from repro_torch.dist import launch
    from repro_torch.kernels import _build
    from repro_torch.launch.train import run
    _build.lib()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = launch.run(tdc.train_dp, 2, 1, Path(tmp) / "dp",
                         args=(TRAIN_DP, "all", ("all",)), timeout=600,
                         backend="gloo", device="cuda", host_staging=True)
    ranks_s = time.perf_counter() - t0
    _, _, single = run(TRAIN_DP["arch"], steps=TRAIN_DP["steps"],
                       batch=TRAIN_DP["batch"], seq=TRAIN_DP["seq"],
                       lr=TRAIN_DP["lr"], policy=TRAIN_DP["policy"],
                       device=dev, log_every=TRAIN_DP["steps"])
    rel = max(float(np.abs(np.array(r["losses"]) / np.array(single) - 1)
                    .max()) for r in res)
    check(rel < TRAIN_DP_RTOL, f"[train dp] losses "
          f"{[r['losses'] for r in res]} vs one process {single}")
    steps = TRAIN_DP["steps"]
    for r in res:
        c, half = r["counters"], 2 * r["compressed_elems"]
        check(c["dist.grads.all-to-all.bytes"] == steps * half
              and c["dist.grads.all-gather.bytes"] == steps * half,
              f"[train dp] rank {r['rank']} bytes {c}, expected {half} a "
              "step on each phase (half of f32)")
    check(all(np.array_equal(a, b) for a, b in zip(res[0]["params"],
                                                   res[1]["params"])),
          "[train dp] the ranks' params differ")
    cases = {}
    for name, x in tdc.dp_cases(2).items():
        exact = x.astype(np.float64).sum(0)
        plain = (x[0] + x[1]).astype(np.float64)
        rms = np.sqrt(np.mean(plain ** 2))
        err = max(float(np.abs(r["cases"]["sums"][f"all.{name}"] - plain)
                        .max()) / rms for r in res)
        check(err < 5e-3, f"[train dp] compressed_psum {name} {x.shape}: "
              f"{err:.3g} of the RMS from the plain psum")
        cases[name] = dict(shape=list(x.shape), err_over_rms=err,
                           exact_err=float(np.abs(plain - exact).max()))
    c = res[0]["counters"]
    say(f"[train dp] 2 ranks on the card (gloo, host-staged), smoke "
        f"{TRAIN_DP['arch']} {TRAIN_DP['policy']}, {steps} steps of batch "
        f"{TRAIN_DP['batch']} x seq {TRAIN_DP['seq']}: losses "
        + ", ".join(f"{v:.6f}" for v in res[0]["losses"])
        + f" vs one process " + ", ".join(f"{v:.6f}" for v in single)
        + f" (max {rel:.2e} relative, limit {TRAIN_DP_RTOL}); rank 0 steps "
        + ", ".join(f"{1e3 * t:.1f}" for t in res[0]["step_s"])
        + f" ms; gradient sums: all-to-all "
        f"{int(c['dist.grads.all-to-all.bytes'])} B, all-gather "
        f"{int(c['dist.grads.all-gather.bytes'])} B = each half of an f32 "
        f"psum's {int(2 * c['dist.grads.all-to-all.bytes'])} B for the "
        f"{res[0]['compressed_elems']} compressed elements; compressed_psum "
        + ", ".join(f"{k} {tuple(v['shape'])} {v['err_over_rms']:.2e}"
                    for k, v in cases.items())
        + f" of the RMS from the plain psum (limit 5e-3); the ranks' wall "
        f"{ranks_s:.2f} s [{smi}]")
    return dict(losses=[r["losses"] for r in res], single=single,
                max_rel=rel, counters=c, cases=cases,
                step_s=res[0]["step_s"])


def train_sharded_rank(grid, run, ep_path=None, go=None):
    """One rank of ``[train sharded]``: ``run['steps']`` steps of the
    sharded ``make_train_step`` of ``run['arch']`` at its published widths
    on the grid's ("data", "model") mesh, from the seeded full params and
    batches every process makes alike (each rank keeps its blocks).  The
    first step's codec calls are held to the plain codec (CodecRecorder).
    Per step: the loss, the wall (host clock, a device sync on each side),
    the codec launches, the collective bytes by kind and their seconds by
    kind (a device sync around each).  Then, with ``ep_path``, the expert
    parallelism cases of ``tests/torch_dist_cases.py`` on the card.  With
    ``go``, the steps wait until that file exists (the rank starts up
    while others run, and steps alone)."""
    import torch
    import torch_dist_cases as tdc
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.dist.grid import StageClock
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_data_model_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = grid.device
    cfg = get_config(run["arch"], policy=run["policy"])
    mesh = make_data_model_mesh(grid)
    cell = ShapeCell("e2e", "train", run["seq"], run["batch"])
    dist = shd.dist_for(cfg, cell, mesh)
    bspecs = shd.batch_shardings(cfg, cell, mesh)
    step = make_train_step(cfg, remat=False, lr=run["lr"], dist=dist)
    full = init_params(run["seed"], cfg, device=dev)
    opt = adamw_init(full, cfg.get_policy().opt_compression is not None)
    params = step.plan.shard(full)
    opt = shd.shard_tree(opt, shd.opt_shardings(opt, step.plan.specs, mesh),
                         mesh)
    table_rows = params["embed"]["table"]["w"].shape[0]
    del full
    while go is not None and not Path(go).exists():
        time.sleep(0.05)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.clock = StageClock(dev)
    out = dict(rank=grid.rank, coords=dict(mesh.coords), seq=dist.seq,
               dp=dist.dp, table_rows=table_rows, losses=[], step_ms=[],
               launches=[], counts=[], secs=[])
    rec = CodecRecorder()
    for i in range(run["steps"]):
        batch = shd.shard_tree(make_batch(cfg, cell, i, seed=run["seed"],
                                          batch_override=run["batch"],
                                          device=dev), bspecs, mesh)
        mesh.reset_counts()
        mesh.clock.secs = {}
        before = pg.launch_counts()
        if i == 0:
            rec.open()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize(dev)
        finally:
            rec.close()
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["launches"].append(_train_launches(before, pg.launch_counts()))
        out["counts"].append(dict(mesh.counts))
        out["secs"].append(dict(mesh.clock.secs))
        out["losses"].append(float(m["loss"]))
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["codec_calls"] = len(rec.calls)
    out["codec_bad"] = [c for c in rec.calls if not c[3]][:4]
    out["launch_total"] = {}
    for c in out["launches"]:
        for k, n in c.items():
            out["launch_total"][k] = out["launch_total"].get(k, 0) + n
    if ep_path is not None:
        mesh.clock = None
        out["ep"] = tdc.ep_cases(grid, ep_path)
    return out


def _sharded_one_process(dev):
    """TRAIN_SHARDED's steps in one process on the card: the losses."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    run = TRAIN_SHARDED
    cfg = get_config(run["arch"], policy=run["policy"])
    cell = ShapeCell("e2e", "train", run["seq"], run["batch"])
    params = init_params(run["seed"], cfg, device=dev)
    opt = adamw_init(params, cfg.get_policy().opt_compression is not None)
    step = make_train_step(cfg, remat=False, lr=run["lr"])
    losses = []
    for i in range(run["steps"]):
        params, opt, m = step(params, opt, make_batch(
            cfg, cell, i, seed=run["seed"], batch_override=run["batch"],
            device=dev))
        losses.append(float(m["loss"]))
    return losses


def phase_train_sharded(dev, smi):
    """The sharded training step on the card (``launch.steps.
    make_train_step`` with a ``DistContext``): four ranks sharing the card
    (gloo on host copies) as a 2x2 ("data", "model") mesh run
    TRAIN_SHARDED (qwen2-0.5b at its published widths, posit32: every
    linear's gathered weights and activations on the codec kernels), then
    one NCCL rank runs it as a 1x1 mesh (started with the four, its steps
    after theirs).  Checks: every rank's losses
    within TRAIN_SHARDED_RTOL of one process's on the same params and
    batches; TRAIN_SHARDED_CODEC encode and decode launches a step on
    every rank, the first step's codec calls equal to the plain codec;
    the collective bytes of every step and rank by kind equal to the dry
    run's plan (``launch.dryrun.build_step`` on an abstract 2x2 mesh,
    computed here while the ranks run); the granite-moe smoke config's
    ``moe_apply_ep`` on the 2x2 and 1x4 meshes against the card's local
    path (y within EP_RTOL, the gathered gradients within EP_GRAD_RTOL).
    Returns (report, the 2x2 ranks' codec launches, summed)."""
    import numpy as np
    import torch_dist_cases as tdc
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.dist import launch
    from repro_torch.kernels import _build
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    _build.lib()                   # the ranks load the library built here
    run = TRAIN_SHARDED
    cfg = get_config(run["arch"], policy=run["policy"])
    cell = ShapeCell("e2e", "train", run["seq"], run["batch"])
    with tempfile.TemporaryDirectory() as tmp:
        ep_path = Path(tmp) / "ep.npz"
        np.savez(ep_path, **tdc.ep_inputs())
        go = Path(tmp) / "go"
        t0 = time.perf_counter()
        grid = launch.spawn(train_sharded_rank, 2, 2, Path(tmp) / "grid",
                            args=(run, str(ep_path)), backend="gloo",
                            device="cuda", host_staging=True)
        # the NCCL rank starts up meanwhile and steps once the grid is done
        one = launch.spawn(train_sharded_rank, 1, 1, Path(tmp) / "nccl",
                           args=(run, None, str(go)), backend="nccl",
                           device="cuda:0")
        try:                       # the plan, on the host meanwhile
            mesh = Mesh(("data", "model"), (2, 2))
            fn, args = dryrun.build_step(cfg, cell, mesh, remat=False,
                                         lr=run["lr"])
            fn(*args)
            plan = dict(mesh.counts)
            plan_s = time.perf_counter() - t0
            ranks = grid.join(timeout=900)
        except BaseException:
            for proc in grid.procs + one.procs:
                proc.kill()
            raise
        grid_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        go.touch()
        (nccl,) = one.join(timeout=600)
        nccl_s = time.perf_counter() - t1
    single = _sharded_one_process(dev)
    for r in ranks + [nccl]:
        rel = float(np.abs(np.array(r["losses"]) / np.array(single) - 1)
                    .max())
        r["loss_rel"] = rel
        check(rel < TRAIN_SHARDED_RTOL, f"[train sharded] rank {r['rank']} "
              f"{r['coords']}: losses {r['losses']} vs one process {single}")
        check(not r["codec_bad"] and r["codec_calls"] > 0,
              f"[train sharded] rank {r['rank']}: codec calls differ from "
              f"the plain codec: {r['codec_bad']}")
        for c in r["launches"]:
            check(c.get("encode_posit_f32") == TRAIN_SHARDED_CODEC
                  and c.get("decode_split_f32") == TRAIN_SHARDED_CODEC,
                  f"[train sharded] rank {r['rank']}: launches a step {c}, "
                  f"expected {TRAIN_SHARDED_CODEC} encodes and decodes")
    for r in ranks:
        check(all(c == plan for c in r["counts"]),
              f"[train sharded] rank {r['rank']} collective bytes "
              f"{r['counts']} != the dry run's plan {plan}")
        check(r["table_rows"] == cfg.vocab // 2 and r["seq"] == "model",
              f"[train sharded] rank {r['rank']}: table rows "
              f"{r['table_rows']}, seq {r['seq']}")
    ep = {}
    y_local, g_local = tdc.ep_local(dev)
    for shape in tdc.MESHES:
        for seq in tdc.EP_SEQS:
            tag = f"{shape[0]}x{shape[1]}.{seq}"
            y, grads = tdc.ep_assemble([r["ep"] for r in ranks], tag, shape)
            gerr = max(np_rel(grads[k], g_local[k]) for k in grads)
            yerr = np_rel(y, y_local)
            check(yerr < EP_RTOL and gerr < EP_GRAD_RTOL,
                  f"[train sharded] EP {tag}: y {yerr:.3g}, gradients "
                  f"{gerr:.3g} from the card's local path")
            ep[tag] = dict(y_rel=yerr, grad_rel=gerr,
                           aux=ranks[0]["ep"][tag]["aux"])
    counts = dict.fromkeys(pg.launch_counts(), 0)
    for r in ranks:
        for k, n in r["launch_total"].items():
            counts[k] += n

    def secs(r, kind):
        return r["secs"][-1].get(kind, 0.0)
    for r in ranks + [nccl]:
        say(f"[train sharded] rank {r['rank']} mesh "
            f"{'1x1 NCCL' if r is nccl else '2x2 gloo'} {r['coords']}: "
            "losses " + ", ".join(f"{v:.6f}" for v in r["losses"])
            + f" ({r['loss_rel']:.2e} from one process); step ms "
            + ", ".join(f"{v:.1f}" for v in r["step_ms"])
            + f" (the first with its codec calls checked); last step's "
            f"all-gather {secs(r, 'all-gather'):.3f} s, reduce-scatter "
            f"{secs(r, 'reduce-scatter'):.3f} s, all-reduce "
            f"{secs(r, 'all-reduce'):.3f} s (device syncs around each); "
            f"peak device memory {r['peak_bytes'] / 2**30:.3f} GiB; codec "
            f"launches a step {json.dumps(r['launches'][-1])} [{smi}]")
    say(f"[train sharded] {cfg.name} {run['policy']} batch {run['batch']} x "
        f"seq {run['seq']}, {run['steps']} steps: one process's losses "
        + ", ".join(f"{v:.6f}" for v in single)
        + f"; collective bytes a step on every 2x2 rank {json.dumps(plan)} "
        f"= the dry run's plan (computed in {plan_s:.1f} s on the host); "
        f"embedding table rows a rank {ranks[0]['table_rows']}; EP "
        + "; ".join(f"{k}: y {v['y_rel']:.2e}, grads {v['grad_rel']:.2e}, "
                    f"aux {v['aux']:.6f}" for k, v in ep.items())
        + f" (limits {EP_RTOL}, {EP_GRAD_RTOL}); walls: 2x2 ranks "
        f"{grid_s:.1f} s, NCCL rank {nccl_s:.1f} s after them (started "
        f"with them) [{smi}]")
    return dict(single=single, plan=plan, ep=ep, grid_s=grid_s,
                nccl_s=nccl_s, ranks=[{k: v for k, v in r.items()
                                       if k != "ep"} for r in ranks],
                nccl=nccl), counts


# --------------------------------------------------------------------------
# the port's example scripts
# --------------------------------------------------------------------------

def _digits_apart(x, y) -> float:
    import math
    return abs(math.log10(max(x, 1e-300) / max(y, 1e-300)))


def _claims_quickstart(out, dev):
    """Section 1's words and the faithful GEMM's equal the CPU's, the
    xla_quire words within one ulp of them (two f64 dots); posit beats
    binary32 at sigma=1; the formats' errors grow as they narrow; rgels_ir
    on the least-squares floor; three observed sweeps; 2.0x weights."""
    import numpy as np
    import torch
    from repro_torch.core import posit
    from repro_torch.kernels.ops import rgemm
    x = torch.tensor([1.0, 3.141592653589793, -0.001, 1e6],
                     dtype=torch.float64)
    words = posit.from_float64(x)
    check(np.array_equal(out["words"], words.numpy()) and np.array_equal(
        out["sum_words"], posit.add(words, words).numpy()),
        "quickstart: section 1's words on the card != the CPU's")
    a, b = (torch.from_numpy(out[k]) for k in ("gemm_a", "gemm_b"))
    got = out["gemm_words"]
    check(np.array_equal(got["faithful"],
                         rgemm(a, b, backend="faithful").numpy()),
          "quickstart: faithful GEMM words on the card != the CPU's")
    ulps = np.abs(got["quire"].astype(np.int64) - rgemm(
        a, b, backend="xla_quire").numpy().astype(np.int64)).max()
    check(ulps <= 1, f"quickstart: xla_quire words {ulps} ulps from the "
          "CPU's")
    check(out["lu"][1.0].digits > 0, f"quickstart: {out['lu'][1.0]}")
    e = [r.e_posit for r in out["formats"].values()]
    check(e == sorted(e), f"quickstart: format errors {e} not ordered")
    ls = out["ls"]
    check(_digits_apart(ls["rgels_ir"], ls["optimum"]) < 0.1, f"ls {ls}")
    check(out["observed"]["counters"]["ir.sweeps"] == 3
          and out["weight_ratio"] == 2.0, "quickstart: sweeps / weights")
    return (f"LU sigma=1 {out['lu'][1.0].digits:+.2f} digits, GEMM words "
            "(faithful; xla_quire <= 1 ulp) == CPU's")


def _claims_cholesky_lu_accuracy(out, dev):
    """Posit(32,2) beats binary32 in the golden zone (sigma 1e-2, 1)."""
    import numpy as np
    for (algo, sigma), r in out.items():
        check(np.isfinite(r.e_posit) and r.e_posit > 0, f"{algo} {r}")
        if sigma <= 1.0:
            check(r.digits > 0, f"cholesky_lu_accuracy: {r}")
    return "digits " + ", ".join(f"{a} {s:g}: {r.digits:+.2f}"
                                 for (a, s), r in out.items())


def _claims_quire_refine(out, dev):
    """>= 2 digits gained (tests/test_quire.py:172-181); every right-hand
    side to < 1e-12; the mixed-precision solve on the full-width floor."""
    for algo, r in out["studies"].items():
        check(r.digits_gained >= 2.0, f"quire_refine {algo}: {r}")
    check(out["batched"].max() < 1e-12, f"batched {out['batched']}")
    check(_digits_apart(out["mp"], out["batched"][0]) < 0.5,
          f"quire_refine: mp {out['mp']} vs IR {out['batched'][0]}")
    return "digits gained " + ", ".join(
        f"{a} {r.digits_gained:+.2f}" for a, r in out["studies"].items())


def _claims_observe_solve(out, dev):
    """Six ir.sweep rows a solve, >= 2 digits at sigma=1, each A's
    golden-zone occupancy equal to the CPU's on the same words, a trace."""
    import torch
    from repro_torch import obs
    for sigma, row in out["sigmas"].items():
        check([r["sweep"] for r in row["sweeps"]] == list(range(6)),
              f"observe_solve sigma={sigma}: {len(row['sweeps'])} rows")
        check(row["occupancy"] == obs.golden_zone_fraction(
            torch.from_numpy(row["a_words"])),
            f"observe_solve sigma={sigma}: occupancy != the CPU's")
    one = out["sigmas"][1.0]
    check(one["sweeps"][-1]["digits_gained"] >= 2.0 and one["error"] < 1e-12
          and out["trace_events"] > 0, f"observe_solve sigma=1: {one}")
    return (f"sigma=1 {one['sweeps'][-1]['digits_gained']:+.2f} digits, "
            f"{out['trace_events']} trace events")


def _claims_fault_tolerant_solve(out, dev):
    """Every seeded fault detected, every recovery bit-identical."""
    check(out["gemm"]["detections"] == 1 and out["gemm"]["identical"]
          and out["lu"]["detections"] >= 1 and out["lu"]["identical"]
          and out["faulted"]["report"].detections >= 1
          and out["faulted"]["identical"]
          and out["benign"]["report"].outcome == "converged",
          f"fault_tolerant_solve: {out}")
    return (f"benign {out['benign']['report'].solver}, cond 1e5 "
            f"{out['hard']['report'].solver}, recoveries bit-identical")


def _claims_dist_solve(out, dev):
    """The grid's words equal one process's on the card."""
    check(all(out["identical"].values()) and out["residuals"].max() < 1e-12,
          f"dist_solve: {out['identical']}, residuals {out['residuals']}")
    return (f"x_hi, x_lo, LU, k-split GEMM words == one process's; "
            f"residuals <= {out['residuals'].max():.2e}")


def _claims_serve_posit(out, dev):
    """2.0x weights and KV; batched tokens == sequential tokens."""
    import numpy as np
    rep, seq = out["replay"], out["sequential"]
    check(out["weight_ratio"] == 2.0 and out["kv_ratio"] == 2.0,
          f"serve_posit: storage {out['weight_ratio']} {out['kv_ratio']}")
    check(rep["requests"] == 6 and set(seq) == set(rep["outputs"])
          and all(np.array_equal(rep["outputs"][k], seq[k]) for k in seq),
          "serve_posit: batched != sequential")
    return f"{rep['tokens']} tokens, batched == sequential, 2.0x storage"


def _claims_serve_batched(out, dev):
    """(2, 8) tokens a model; each row equal to its prompt served alone."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import generate
    prompts = np.array([[5, 6, 7, 8], [1, 2, 3, 4]], np.int32)
    for arch, toks in out.items():
        cfg = get_smoke_config(arch)
        check(toks.shape == (2, 8) and 0 <= toks.min()
              and toks.max() < cfg.vocab, f"serve_batched {arch}: {toks}")
        params = init_params(0, cfg, device=dev)
        for row in range(2):
            alone = generate(params, cfg, prompts[row:row + 1], max_new=8)
            check(np.array_equal(alone[0], toks[row]),
                  f"serve_batched {arch}: row {row} != served alone")
    return "rows == served alone"


def _losses_fall(what, losses):
    import numpy as np
    check(len(losses) > 1 and all(np.isfinite(losses))
          and losses[-1] < losses[0], f"{what}: losses {losses}")
    return f"{losses[0]:.4f} -> {losses[-1]:.4f}"


def _claims_posit_training(out, dev):
    """Each policy's losses finite and falling."""
    return "; ".join(f"{p} {_losses_fall(p, l)}" for p, l in out.items())


def _claims_train_100m(out, dev):
    """Losses finite and falling at the full 100M widths."""
    return (f"{out['params'] / 1e6:.1f}M params, loss "
            f"{_losses_fall('train_100m', out['losses'])}")


def run_examples(dev, names) -> dict:
    """``names``' scripts (``examples/torch_<name>.py``) on the card
    through their ``main()``, one after another, with EXAMPLE_ARGS.  Each
    one's launches are counted from zero around its ``main``, the kernels
    of EXAMPLE_KERNELS must be among them, and its own claims are checked
    (``_claims_<name>``: the CPU tests' checks, against the CPU where the
    tests hold to the reference); the GEMM kernel calls it made (the
    quickstart's pallas_split3) are held to the plain version on their
    operands (fused words = encode(kernel f32 output)).  {name: report}."""
    import io
    import torch
    from repro_torch.kernels import posit_gemm as pg
    import torch_inputs as ti
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            cut = EXAMPLE_ARGS[name]
            argv = cut + {"observe_solve": ["--trace", f"{tmp}/trace.json"],
                          "train_100m": ["--ckpt-dir", f"{tmp}/ckpt"]
                          }.get(name, [])
            main = ti.load_example(name).main
            printed = io.StringIO()
            with GemmRecorder() as rec:
                pg.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    out = main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = pg.launch_counts()
            launched = {k: v for k, v in counts.items() if v}
            for kernel in EXAMPLE_KERNELS.get(name, ()):
                check(counts[kernel] > 0, f"[examples] {name} launched no "
                      f"{kernel}: {launched}")
            summary = globals()[f"_claims_{name}"](out, dev)
            if rec.calls:
                n_calls, worst = check_path_gemms(f"[examples] {name}",
                                                  rec.calls)
                summary += (f"; kernel GEMM calls held to the plain version: "
                            f"{n_calls} (max |kernel - plain| {worst:.3g})")
            report[name] = dict(argv=cut, wall_s=wall, launches=counts,
                                summary=summary, printed=printed.getvalue())
    return report


def child_main(calls, dev, path):
    """``fn(torch.device(dev), *args)`` for each (name, args) of ``calls``
    in turn, in a child process, so that the parent's phases run
    meanwhile: one intra-op thread (the children and the parent share the
    host's cores), the kernel library loaded from the parent's build, and
    what they printed and returned (or the traceback) saved to ``path``."""
    import io
    import traceback
    import torch
    from repro_torch.kernels import _build
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    printed = io.StringIO()
    out = {"results": [], "walls": {}}
    try:
        _build.lib()
        with contextlib.redirect_stdout(printed):
            for name, args in calls:
                t0 = time.perf_counter()
                out["results"].append(globals()[name](torch.device(dev),
                                                      *args))
                out["walls"][name] = time.perf_counter() - t0
    except Exception:
        out["error"] = traceback.format_exc()
    out["printed"] = printed.getvalue()
    torch.save(out, path)


def start_child(calls, dev, path):
    """Start ``child_main`` on ``calls`` (a spawned process: it may spawn
    ranks of its own); returns the job ``join_child`` takes."""
    proc = multiprocessing.get_context("spawn").Process(
        target=child_main, args=(calls, str(dev), str(path)))
    proc.start()
    return [name for name, _ in calls], proc, Path(path)


def join_child(job, walls):
    """Wait for a ``start_child`` job, print what it printed, add its
    calls' walls to ``walls`` (under "<child>.<name>") and return its
    results; raises if it failed."""
    import torch
    names, proc, path = job
    proc.join(1800)
    if proc.is_alive():
        proc.kill()
        proc.join()
    check(path.exists(), f"{names} in a child: it exited "
          f"{proc.exitcode} and left no report")
    got = torch.load(path, weights_only=False)
    print(got["printed"], end="", flush=True)
    check("error" not in got, f"{names} in a child:\n"
          f"{got.get('error', '')[-4000:]}")
    walls.update({f"{path.stem}.{name.removeprefix('phase_')}": secs
                  for name, secs in got["walls"].items()})
    return got["results"]


def phase_examples(reports, smi):
    """Print each example's checks, launches and wall (taken in a child
    beside the parent's phases and the other children) from the
    ``run_examples`` reports.  Returns ({name: report}, the launches
    summed over the examples)."""
    report = {}
    for r in reports:
        report.update(r)
    total = {}
    for name in EXAMPLE_ARGS:
        r = report[name]
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
        launched = {k: v for k, v in r["launches"].items() if v}
        say(f"[examples] {' '.join([name, *r['argv']])}: {r['summary']}; "
            f"launches {launched}; wall {r['wall_s']:.2f} s")
    walls = sum(r["wall_s"] for r in report.values())
    say(f"[examples] the ten scripts in two child processes beside "
        f"[refine], [mp] and the other children: {walls:.1f} s of main()s;"
        f" launches {({k: v for k, v in total.items() if v})} [{smi}]")
    return report, total


def profile_decode_steps(engine, trace, cfg, steps=3):
    """The device's busy share over ``steps`` decode steps at full width:
    four of the trace's prompts cut to two tokens are admitted (a short
    prefill), then ``torch.profiler`` traces the steps; busy = the sum of
    the CUDA kernels' device time over the window's host-clock wall.
    Prints the kernels that took the most device time."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng = engine(SERVE_ENGINE["max_batch"])
    for r in trace[:SERVE_ENGINE["max_batch"]]:
        eng.submit(dataclasses.replace(r, prompt=r.prompt[:2],
                                       max_new=steps + 2))
    eng.step()                      # admits all four, decodes one token
    torch.cuda.synchronize()
    check(eng.n_inflight() == SERVE_ENGINE["max_batch"],
          "[serve] profile: not every request in flight")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(getattr(e, "self_device_time_total", 0.0), e.key, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    device_s = sum(r[0] for r in rows) / 1e6
    top = sorted(rows, reverse=True)[:6]
    if device_s == 0.0:
        say("[serve] profile: the trace holds no device time (not "
            "measured)")
        return dict(wall_s=wall, device_s=None, busy=None)
    say(f"[serve] profile of {steps} decode steps at width "
        f"{SERVE_ENGINE['max_batch']}: wall {wall * 1e3:.2f} ms, device "
        f"busy {device_s * 1e3:.2f} ms ({100 * device_s / wall:.1f} %, "
        f"idle {100 - 100 * device_s / wall:.1f} %); by device time: "
        + "; ".join(f"{k[:48]} x{n} {t / 1e3:.2f} ms" for t, k, n in top))
    return dict(wall_s=wall, device_s=device_s, busy=device_s / wall,
                top=[dict(name=k, count=n, device_ms=t / 1e3)
                     for t, k, n in top])


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

    # The first trailing update of an n=1024 LU (nb=64; the refinement
    # LU, each matrix of the ensemble LU), in p16e1 (the mixed study's
    # factor format) and p32e2.
    m2, k2, n2 = MIXED_SHAPE
    for fmt in (P16E1, P32E2):
        a = ti.posits(rng, (m2, k2), -4, 4, fmt, dev)
        b = ti.posits(rng, (k2, n2), -4, 4, fmt, dev)
        flops = (6.0 if fmt.nbits > 16 else 2.0) * m2 * k2 * n2
        nbytes = 4.0 * (m2 * k2 + k2 * n2 + m2 * n2)
        bound_ms = max(flops / flops_rate, nbytes / bytes_rate) * 1e3
        kernel_ms = graph_ms(lambda: pg.posit_gemm_f32(a, b, fmt=fmt), 20)
        ah, al = pg.decode_split_f32_plain(a, fmt)
        bh, bl = pg.decode_split_f32_plain(b, fmt)
        a32, b32 = ah + al, bh + bl
        a64, b64 = posit.to_float64(a, fmt), posit.to_float64(b, fmt)
        f32_ms = cuda_ms(lambda: torch.matmul(a32, b32), 20)
        f64_ms = cuda_ms(lambda: torch.matmul(a64, b64), 20)
        plain_ms = cuda_ms(lambda: pg.posit_gemm_f32_plain(a, b, fmt=fmt),
                           5)
        by = ("operations" if flops / flops_rate >= nbytes / bytes_rate
              else "bytes")
        extra[f"mixed_{fmt.name}"] = dict(
            shape=[m2, k2, n2], kernel_ms=kernel_ms, bound_ms=bound_ms,
            bound_by=by, plain_ms=plain_ms, matmul_f32_ms=f32_ms,
            matmul_f64_ms=f64_ms)
        say(f"[time] {fmt.name} split3 f32 {(m2, k2, n2)} (an n=1024 "
            f"LU's first update): kernel {kernel_ms:.4f} ms (pre-pass + "
            f"GEMM, CUDA graph), bound {bound_ms:.4f} ms ({by}), plain "
            f"{plain_ms:.4f} ms, torch.matmul f32 {f32_ms:.4f} / f64 "
            f"{f64_ms:.4f} ms [{smi}]")

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
    # The encode as the serve path runs it: p16e1 at 2^24 values into
    # int32 and straight into the int16 wire words, and encode_kv on one
    # layer's K rows at decode width (max_batch rows of n_kv_heads x
    # d_head), the call each decode step makes per layer for K and for V.
    from repro_torch.configs import get_config
    from repro_torch.serving.kv_cache import encode_kv
    scfg = get_config(SERVE_ARCH)
    kv = torch.randn(SERVE_ENGINE["max_batch"], scfg.n_kv_heads,
                     scfg.d_head, device=dev)
    enc = {}
    for label, fn, nbytes in (
            ("p16e1_int32", lambda: pg.encode_posit_f32(vals, P16E1),
             8.0 * nw),
            ("p16e1_int16", lambda: pg.encode_posit_f32(
                vals, P16E1, out_dtype=torch.int16), 6.0 * nw),
            ("kv_row_p16e1", lambda: encode_kv(kv, "p16e1"),
             6.0 * kv.numel())):
        enc[label] = dict(ms=graph_ms(fn, 20),
                          bound_ms=nbytes / bytes_rate * 1e3)
    extra["encode"] = dict(enc, kv_shape=list(kv.shape))
    say("[time] encode_posit_f32 " + "; ".join(
        f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.5f} ms, bytes)"
        for k, v in enc.items()) + f"; 2^24 values, K/V rows "
        f"{tuple(kv.shape)} [{smi}]")
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
    # fails outside a checkout of the repo
    import repro_torch.serving.study  # noqa: F401  (the whole serving path)
    import repro_torch.lapack.error_eval  # noqa: F401
    import repro_torch.dist  # noqa: F401
    import repro_torch.launch.train  # noqa: F401  (training: steps, optim)
    import repro_torch.launch.collectives  # noqa: F401
    import repro_torch.launch.dryrun  # noqa: F401  (sharded training)
    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules),
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
    phase_s = {}

    def run(fn, *a, name=None):
        """``fn(*a)``, its wall kept in ``phase_s`` under ``name`` (its
        own name by default)."""
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name or fn.__name__.removeprefix("phase_")] = (
            time.perf_counter() - t0)
        return out
    build_s, ptxas = run(phase_build)
    ref_pool = multiprocessing.get_context("spawn").Pool(1)
    ref_job = ref_pool.apply_async(reference_backend_studies, (str(dev),))
    run(phase_plain_codec, dev)
    encode_all_s, codec_s = run(phase_codec_kernels, dev)
    worst = run(phase_gemm, dev)
    compared = run(phase_bit_identity, dev)
    report, counts, main_words = run(phase_main_path, dev, smi)
    run(phase_fused_rgemm, dev)
    run(phase_reference_backend, report, ref_job)
    ref_pool.close()
    ref_pool.join()
    run(phase_word_parity, dev)
    quire = run(phase_quire, dev, smi)
    # the examples and the check-only [parity], [lstsq], [ft soak] and
    # [guarded] in child processes beside [refine] and [mp]; "children" is
    # the parent's wait for them after [mp]
    child_dir = tempfile.mkdtemp()
    children = ([("run_examples", (EXAMPLE_GROUPS[0],)),
                 ("phase_guarded", (smi,))],
                [("run_examples", (EXAMPLE_GROUPS[1],)),
                 ("phase_ft_soak", (smi,))],
                [("phase_refine_parity", ()), ("phase_lstsq", (smi,))])
    jobs = [start_child(calls, dev, f"{child_dir}/{i}.pt")
            for i, calls in enumerate(children)]
    refine_report, refine_counts = run(phase_refine, dev, smi)
    mp_cells = run(phase_mp_cells, dev, smi)
    child_s = {}
    (ex_a, guarded), (ex_b, soak), (_, lstsq) = run(
        lambda: [join_child(job, child_s) for job in jobs], name="children")
    shutil.rmtree(child_dir)
    examples, examples_counts = run(phase_examples, (ex_a, ex_b), smi)
    qr_report, qr_counts = run(phase_qr, dev, smi)
    ens_report, ens_counts = run(phase_ensemble, dev, smi)
    run(phase_qr_parity, dev)
    batched = run(phase_batched_gemm, dev, smi)
    obs_report = run(phase_obs, dev, smi)
    golden, golden_counts = run(phase_golden, dev, smi)
    ft_report, ft_counts = run(phase_ft, dev, smi)
    dist_report, dist_counts = run(phase_dist, dev, smi, main_words)
    models = run(phase_models, dev, smi)
    serve, serve_counts = run(phase_serve, dev, smi)
    train, train_counts = run(phase_train, dev, smi)
    train_parity = run(phase_train_parity, dev, smi)
    train_resume = run(phase_train_resume, dev, smi)
    train_dp = run(phase_train_dp, dev, smi)
    train_sharded, sharded_counts = run(phase_train_sharded, dev, smi)
    rows, grid, extra = run(phase_timings, dev, worst, smi)
    rows["quant_gemm_f32"] = serve["kernel_row"]
    rows["decode_split_f32"] = train["kernel_row"]

    by_path = dict(main=counts, refine=refine_counts, qr=qr_counts,
                   ensemble=ens_counts, golden=golden_counts, ft=ft_counts,
                   dist=dist_counts, serve=serve_counts, train=train_counts,
                   train_sharded=sharded_counts, examples=examples_counts)
    for path, names in ON_PATH.items():
        for name in names:
            check(by_path[path][name] > 0,
                  f"{name} was not launched on the {path} path")
    src = "src/repro_torch/kernels/csrc/"

    def home(name):
        """The first path of ON_PATH that launches the kernel (main if
        none does): its ``launches`` are that path's run's."""
        return next((p for p, names in ON_PATH.items() if name in names),
                    "main")
    kernels = [dict(name=name, route="cuda", source=src + SOURCES[name],
                    replaces=REPLACES[name],
                    launches=by_path[home(name)][name],
                    launches_path=home(name),
                    launches_by_path={path: c[name]
                                      for path, c in by_path.items()},
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    on_main_path=any(name in names
                                     for names in ON_PATH.values()))
               for name, r in rows.items()]
    total_s = time.perf_counter() - t_start
    say(f"[done] all phases passed in {total_s:.1f} s (build {build_s:.1f} s)"
        "; seconds by phase "
        + json.dumps({k: round(v, 1) for k, v in phase_s.items()})
        + "; in the children beside [refine] and [mp] "
        + json.dumps({k: round(v, 1) for k, v in child_s.items()}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=smi, kind=kind,
                 peaks=dict(fp32_flops=PEAK_FP32_FLOPS,
                            bytes_per_s=PEAK_BYTES_PER_S),
                 build_s=build_s, ptxas=ptxas, total_s=total_s,
                 phase_s=phase_s, child_s=child_s,
                 encode_exhaustive_s=encode_all_s,
                 codec_exhaustive_s=codec_s,
                 identity_comparisons=compared, studies=report,
                 quire=quire, refine=refine_report, mp_cells=mp_cells,
                 qr=qr_report, lstsq=lstsq, ensemble=ens_report,
                 batched=batched, obs=obs_report, golden=golden,
                 ft=ft_report, ft_soak=soak, guarded=guarded,
                 dist=dist_report, models=models, serve=serve,
                 train=train, train_parity=train_parity,
                 train_resume=train_resume, train_dp=train_dp,
                 train_sharded=train_sharded, examples=examples,
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
