"""Rank bodies and inputs of the port's distributed tests.

It imports neither jax nor the JAX package: the bodies run in the ranks
that ``repro_torch.dist.launch`` spawns (fresh interpreters, which import
this module by name), on the CPU for tests/test_torch_dist*.py and on a
GPU for the card leg of tests/test_torch_cuda.py.  Each body returns
plain numpy arrays and Python values, which the test holds to the port's
single-device words and to the JAX package's distributed words.

The inputs are float64 arrays made with numpy from a seed and written to
an npz file, which the JAX package's subprocess and the ranks both read,
so both packages encode the same values (``from_float64`` is
bit-identical across them).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import posit
from repro_torch.core.formats import P16E1
from repro_torch.dist import (distribute, p_residual_quire, p_rgesv_ir,
                              p_rgetrf, p_rgetrf_ft, p_rposv_ir, p_rpotrf,
                              p_rpotrf_ft, pdgemm, pdgemm_ft)
from repro_torch.ft import Fault, FaultPlan, make_plan

# The reference tests' sizes (tests/test_dist.py, tests/test_ft.py):
# (96, 80) @ (80, 64) and n=96, nb=32 on every grid.
NB = 32
N = 96
GEMM = (96, 80, 64)
BACKENDS = ("xla_quire", "quire_exact", "pallas_split3",
            "pallas_split3_comp", "faithful")
POTRF_BACKENDS = ("xla_quire", "quire_exact", "pallas_split3")
GETRF_BACKENDS = ("xla_quire", "quire_exact")
# The factorizations the JAX package also runs on its 2x2 grid (each
# costs it ~17 s of compiling); the port runs every backend above.
REF_POTRF = ("pallas_split3",)
REF_GETRF = ("xla_quire",)
P16_CASES = (("xla_quire", False), ("quire_exact", False),
             ("quire_exact", True))
IR_ITERS = 2
# The protected drivers' faults (tests/test_ft.py:355, :373, :398).
PANEL_FAULT = dict(site="dist.panel", step=1, lane=5, bit=12)
PLAN_SEED = dict(seed=21, site="dist.panel", size=96 * 32, steps=3, n=1,
                 devs=4)
GEMM_FAULT = dict(step=0, lane=7, bit=20, dev=1)
GEMM_FT_SITES = ("pdgemm.a", "pdgemm.b")


def make_inputs(seed: int = 7) -> dict:
    """float64 inputs of every distributed case."""
    rng = np.random.default_rng(seed)

    def pm(shape, lo=-6, hi=6):
        return rng.standard_normal(shape) * np.exp2(rng.uniform(lo, hi,
                                                                shape))
    m, k, n = GEMM
    g = rng.standard_normal((N, N))
    spd = g.T @ g + N * np.eye(N)
    x2 = rng.standard_normal((N, 2))
    xs = rng.standard_normal(N)
    return {"a": pm((m, k)), "b": pm((k, n)), "c0": pm((m, n)),
            "a16": rng.standard_normal((m, k)),
            "b16": rng.standard_normal((k, n)),
            "g": g, "spd": spd, "b_g": g @ x2, "x_g": x2,
            "b_spd": spd @ xs}


def load_words(path, device="cpu") -> dict:
    """The npz inputs as posit words (p32e2; ``a16``/``b16`` p16e1)."""
    raw = np.load(path)
    out = {}
    for name in raw.files:
        fmt = P16E1 if name.endswith("16") else None
        x = torch.from_numpy(raw[name]).to(device)
        out[name] = (posit.from_float64(x, fmt) if fmt
                     else posit.from_float64(x))
    return out


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _counters(fn):
    """(fn(), the ``dist.*`` counters it recorded)."""
    with obs.scoped() as m:
        out = fn()
    return out, {k: v for k, v in m.to_dict()["counters"].items()
                 if k.startswith("dist.")}


def dist_words(grid, path, ir: bool = True):
    """Every plain distributed routine of the tests on this grid: the
    gathered words, and the ``dist.*`` counters of one call of each
    (``ir``: also the two refinement drivers)."""
    w = load_words(path, grid.device)
    res, counters = {}, {}
    ad, bd = distribute(w["a"], grid, NB), distribute(w["b"], grid, NB)
    for backend in BACKENDS:
        out, cnt = _counters(lambda: pdgemm(ad, bd, backend=backend))
        res[f"pdgemm.{backend}"] = _np(out.gather())
        counters[f"pdgemm.{backend}"] = cnt
    out, cnt = _counters(lambda: pdgemm(ad, bd, backend="quire_exact",
                                        k_split=True))
    res["pdgemm.k_split"] = _np(out.gather())
    counters["pdgemm.k_split"] = cnt
    cd = distribute(w["c0"], grid, NB)
    res["pdgemm.k_split.ab"] = _np(pdgemm(
        ad, bd, cd, alpha=-1.0, beta=1.0, backend="quire_exact",
        k_split=True).gather())
    a16, b16 = distribute(w["a16"], grid, NB), distribute(w["b16"], grid, NB)
    for backend, ks in P16_CASES:
        res[f"pdgemm.p16e1.{backend}.{ks}"] = _np(pdgemm(
            a16, b16, backend=backend, k_split=ks,
            fmt=P16E1).gather())
    spd, g = distribute(w["spd"], grid, NB), distribute(w["g"], grid, NB)
    for backend in POTRF_BACKENDS:
        out, cnt = _counters(lambda: p_rpotrf(spd, gemm_backend=backend))
        res[f"rpotrf.{backend}"] = _np(out.gather())
        counters[f"rpotrf.{backend}"] = cnt
    for backend in GETRF_BACKENDS:
        (lu, ipiv), cnt = _counters(lambda: p_rgetrf(g, gemm_backend=backend))
        res[f"rgetrf.{backend}"] = _np(lu.gather())
        res[f"rgetrf.{backend}.ipiv"] = _np(ipiv)
        counters[f"rgetrf.{backend}"] = cnt
    xg = w["x_g"][:, 0]
    r, cnt = _counters(lambda: p_residual_quire(g, xg, w["b_g"][:, 0]))
    res["residual"] = _np(r)
    res["residual.pair"] = _np(p_residual_quire(g, xg, w["b_g"][:, 0], xg))
    counters["residual"] = cnt
    if ir:
        (hi, lo), _ = p_rgesv_ir(g, w["b_g"], iters=IR_ITERS)
        res["rgesv_ir.hi"], res["rgesv_ir.lo"] = _np(hi), _np(lo)
        (hi, lo), _ = p_rposv_ir(spd, w["b_spd"], iters=IR_ITERS)
        res["rposv_ir.hi"], res["rposv_ir.lo"] = _np(hi), _np(lo)
    return {"rank": grid.rank, "coords": (grid.r, grid.c), "words": res,
            "counters": counters}


def _report(rep) -> dict:
    return dict(detections=rep.detections, retries=rep.retries,
                failed=rep.failed, sites=list(rep.sites))


def dist_ft_words(grid, path, ckpt_dir):
    """The protected drivers on this grid: fault-free and recovered words
    with their reports, the seeded plan, and the kill/resume runs
    (checkpoints under ``ckpt_dir``)."""
    w = load_words(path, grid.device)
    res, reps = {}, {}
    ad, bd = distribute(w["a"], grid, NB), distribute(w["b"], grid, NB)
    res["pdgemm"] = _np(pdgemm(ad, bd).gather())
    out, rep = pdgemm_ft(ad, bd)
    res["pdgemm_ft"], reps["pdgemm_ft"] = _np(out.gather()), _report(rep)
    for site in GEMM_FT_SITES:
        plan = FaultPlan((Fault(site=site, **GEMM_FAULT),))
        out, rep = pdgemm_ft(ad, bd, plan=plan)
        res[f"pdgemm_ft.{site}"] = _np(out.gather())
        reps[f"pdgemm_ft.{site}"] = _report(rep)
    spd, g = distribute(w["spd"], grid, NB), distribute(w["g"], grid, NB)
    res["rpotrf"] = _np(p_rpotrf(spd).gather())
    lu, ipiv = p_rgetrf(g)
    res["rgetrf"], res["rgetrf.ipiv"] = _np(lu.gather()), _np(ipiv)
    out, rep = p_rpotrf_ft(spd)
    res["rpotrf_ft"], reps["rpotrf_ft"] = _np(out.gather()), _report(rep)
    lu, ipiv, rep = p_rgetrf_ft(g)
    res["rgetrf_ft"], res["rgetrf_ft.ipiv"] = _np(lu.gather()), _np(ipiv)
    reps["rgetrf_ft"] = _report(rep)
    plan = FaultPlan((Fault(dev=min(3, grid.p * grid.q - 1),
                            **PANEL_FAULT),))
    out, rep = p_rpotrf_ft(spd, plan=plan)
    res["rpotrf_ft.panel"], reps["rpotrf_ft.panel"] = (_np(out.gather()),
                                                       _report(rep))
    seeded = make_plan(**PLAN_SEED)
    for run in range(2):
        lu, ipiv, rep = p_rgetrf_ft(g, plan=seeded)
        res[f"rgetrf_ft.seeded{run}"] = _np(lu.gather())
        res[f"rgetrf_ft.seeded{run}.ipiv"] = _np(ipiv)
        reps[f"rgetrf_ft.seeded{run}"] = _report(rep)
    # kill after a step, then resume from the checkpoint
    ck = f"{ckpt_dir}/lu"
    out, _, _ = p_rgetrf_ft(g, checkpoint_dir=ck, _stop_after=1)
    res["killed.lu"] = out is None
    lu, ipiv, _ = p_rgetrf_ft(g, checkpoint_dir=ck, resume=True)
    res["resumed.lu"], res["resumed.lu.ipiv"] = _np(lu.gather()), _np(ipiv)
    ck = f"{ckpt_dir}/chol"
    out, _ = p_rpotrf_ft(spd, checkpoint_dir=ck, _stop_after=2)
    res["killed.chol"] = out is None
    out, _ = p_rpotrf_ft(spd, checkpoint_dir=ck, resume=True)
    res["resumed.chol"] = _np(out.gather())
    res["resumed.chol.public"] = _np(p_rpotrf(spd, checkpoint_dir=ck)
                                     .gather())
    return {"rank": grid.rank, "words": res, "reports": reps}


def resume_lu(grid, path, ckpt_dir):
    """``p_rgetrf_ft`` resumed from the checkpoint in ``ckpt_dir``."""
    g = distribute(load_words(path, grid.device)["g"], grid, NB)
    lu, ipiv, _ = p_rgetrf_ft(g, checkpoint_dir=ckpt_dir, resume=True)
    return {"lu": _np(lu.gather()), "ipiv": _np(ipiv)}


def card_rgetrf(grid, n: int, nb: int, seed: int = 0):
    """A host-staged p_rgetrf on the card (``pallas_split3``): the
    gathered words and pivots, and the kernel launches of this rank."""
    from repro_torch.kernels import posit_gemm as pg
    from repro_torch.lapack.error_eval import make_general
    a = posit.from_float64(torch.from_numpy(make_general(n, 1.0, seed))
                           .to(grid.device))
    pg.reset_launch_counts()
    lu, ipiv = p_rgetrf(distribute(a, grid, nb),
                        gemm_backend="pallas_split3")
    launches = pg.launch_counts()
    return {"lu": _np(lu.gather()), "ipiv": _np(ipiv),
            "launches": launches}


def dp_cases(p: int, seed: int = 10) -> dict:
    """Operands of ``compressed_sums`` for ``p`` ranks: (p, ...) f32
    arrays, row r rank r's (the reference's (p, 1024) test case, a length
    padded to a multiple of p, a matrix of small gradients)."""
    rng = np.random.default_rng(seed + p)
    return {"vec": (rng.standard_normal((p, 1024)) * 0.03).astype(
                np.float32),
            "pad": (rng.standard_normal((p, 4999)) * 0.03).astype(
                np.float32),
            "mat": (rng.standard_normal((p, 64, 96)) * 3e-4).astype(
                np.float32)}


def compressed_sums(grid, axes=("all",), seed: int = 10) -> dict:
    """``launch.collectives.compressed_psum`` of ``dp_cases`` over each
    axis of ``axes``: the sums and the bytes each sum's collectives
    counted, by "<axis>.<case>"."""
    from repro_torch.launch.collectives import compressed_psum
    sums = {}
    with obs.scoped() as m:
        for axis in axes:
            me = grid.axis_index(axis)
            for name, x in dp_cases(grid.axis_size(axis), seed).items():
                xt = torch.from_numpy(np.array(x[me])).to(grid.device)
                with grid.counting(f"cpsum.{axis}.{name}"):
                    sums[f"{axis}.{name}"] = _np(
                        compressed_psum(xt, grid, axis))
        counters = {k: v for k, v in m.to_dict()["counters"].items()
                    if k.startswith("dist.")}
    return {"rank": grid.rank, "sums": sums, "counters": counters}


def train_dp(grid, run: dict, axis: str = "all",
             sum_axes: tuple = ()) -> dict:
    """``steps`` steps of ``launch.steps.make_train_step_compressed`` over
    ``axis`` of ``grid`` (``run``: arch, policy, steps, batch, seq, lr,
    seed; the smoke config), each rank on its shard of the global batch:
    the losses and grad norms, the ``dist.*`` bytes of the gradient sums
    (counted as ``dist.grads``), the compressed leaves' element count,
    and this rank's params after the last step.  With ``sum_axes``, also
    ``compressed_sums`` over them."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step_compressed
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_smoke_config(run["arch"]),
                              policy=run["policy"])
    dev = grid.device
    params = init_params(run["seed"], cfg, device=dev)
    opt = adamw_init(params, cfg.get_policy().opt_compression is not None)
    step_fn = make_train_step_compressed(cfg, grid, axis=axis, remat=False,
                                         lr=run["lr"])
    cell = ShapeCell("e2e", "train", run["seq"], run["batch"])
    losses, gnorms, step_s = [], [], []
    with obs.scoped() as m:
        for step in range(run["steps"]):
            batch = make_batch(cfg, cell, step, seed=run["seed"],
                               batch_override=run["batch"], device=dev)
            t0 = time.perf_counter()
            with grid.counting("grads"):
                params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
            gnorms.append(float(metrics["grad_norm"]))
        counters = {k: v for k, v in m.to_dict()["counters"].items()
                    if k.startswith("dist.")}
    compressed = sum(w.numel() for w in tree.leaves(params)
                     if w.numel() >= 1 << 12)
    out = {"rank": grid.rank, "losses": losses, "grad_norms": gnorms,
           "step_s": step_s, "counters": counters,
           "compressed_elems": compressed,
           "params": [_np(w) for w in tree.leaves(params)]}
    if sum_axes:
        out["cases"] = compressed_sums(grid, sum_axes)
    return out
