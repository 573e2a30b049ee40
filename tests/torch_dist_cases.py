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
    return t.detach().cpu().numpy()


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


# --------------------------------------------------------------------------
# the sharded launch layer (tests/test_torch_launch.py,
# tests/test_torch_sharded.py): each body takes a 2x2 grid and builds the
# 2x2 ("data", "model") mesh and the 1x4 one on its four ranks
# --------------------------------------------------------------------------

MESHES = ((2, 2), (1, 4))
EP_SEQS = (None, "model")
EP_CAPACITY = 4.0
EXPERT_KEYS = ("router", "w_gate", "w_up", "w_down")


def ep_inputs(seed: int = 30) -> dict:
    """x, the cotangent c and the granite-moe smoke config's MoE weights
    (d_model 64, 4 experts, d_ff 64), numpy from a seed."""
    rng = np.random.default_rng(seed)
    d, e, f = 64, 4, 64
    return {"x": rng.standard_normal((4, 8, d)).astype(np.float32),
            "c": rng.standard_normal((4, 8, d)).astype(np.float32),
            "router": (rng.standard_normal((d, e)) / 8).astype(np.float32),
            "w_gate": (rng.standard_normal((e, d, f)) / 8).astype(np.float32),
            "w_up": (rng.standard_normal((e, d, f)) / 8).astype(np.float32),
            "w_down": (rng.standard_normal((e, f, d)) / 8).astype(np.float32)}


def ep_config(policy: str = "f32"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                               policy=policy)


def moe_params(ws: dict, device) -> dict:
    """The MoE param dict of ``ws`` (EXPERT_KEYS -> arrays) on ``device``,
    every weight requiring a gradient."""
    from repro_torch.tree import Axes

    def p(a, axes):
        return {"w": torch.from_numpy(np.array(a)).to(device)
                .requires_grad_(True), "axes": Axes(axes)}
    return {"router": {"w": p(ws["router"], (None, None))},
            "w_gate": p(ws["w_gate"], ("experts", None, "mlp")),
            "w_up": p(ws["w_up"], ("experts", None, "mlp")),
            "w_down": p(ws["w_down"], ("experts", "mlp", None))}


def ep_rank(grid, inputs: dict, shape, seq, policy: str = "f32") -> dict:
    """``moe_apply_ep`` on this rank of the ``shape`` mesh: x its batch
    rows, the experts its shard; the loss share sum(y * c) / (model ranks)
    and its gradients (x's and the router's partial, the experts' this
    rank's shard, each still to be summed over the ranks that share it)."""
    from repro_torch.launch.context import DistContext
    from repro_torch.launch.mesh import make_data_model_mesh
    from repro_torch.launch.sharding import P, block
    from repro_torch.models.ffn import moe_apply_ep
    cfg = ep_config(policy)
    mesh = make_data_model_mesh(grid, *shape)
    ctx = DistContext(mesh=mesh, dp=("data",), seq=seq)
    dev = grid.device
    rows = P("data", None, None)
    x = block(torch.from_numpy(inputs["x"]), rows, mesh).to(dev) \
        .requires_grad_(True)
    c = block(torch.from_numpy(inputs["c"]), rows, mesh).to(dev)
    ws = {k: inputs[k] if k == "router" else
          block(torch.from_numpy(inputs[k]), P("model", None, None),
                mesh).numpy() for k in EXPERT_KEYS}
    params = moe_params(ws, dev)
    y, aux = moe_apply_ep(params, x, cfg, cfg.get_policy(), torch.float32,
                          ctx, capacity_factor=EP_CAPACITY)
    share = torch.sum(y * c) / mesh.shape["model"]
    leaves = [x, params["router"]["w"]["w"]] + [params[k]["w"]
                                                 for k in EXPERT_KEYS[1:]]
    grads = torch.autograd.grad(share, leaves)
    return {"coords": dict(mesh.coords), "y": _np(y), "aux": float(aux.detach()),
            "grads": dict(zip(("x",) + EXPERT_KEYS, map(_np, grads))),
            "counts": dict(mesh.counts)}


def ep_cases(grid, path) -> dict:
    """``ep_rank`` on every mesh of MESHES and every EP_SEQS choice, on
    the inputs in the npz file ``path``."""
    inputs = dict(np.load(path))
    return {f"{s[0]}x{s[1]}.{seq}": ep_rank(grid, inputs, s, seq)
            for s in MESHES for seq in EP_SEQS}


EMBED_FORMS = ("embed", "tied")


def embed_inputs(seed: int = 31) -> dict:
    rng = np.random.default_rng(seed)
    vocab, d = 64, 8
    return {"table": rng.standard_normal((vocab, d)).astype(np.float32),
            "ids": rng.integers(0, vocab, (4, 8)).astype(np.int32),
            "c": rng.standard_normal((4, 8, d)).astype(np.float32),
            "c2": rng.standard_normal((4, 8, vocab)).astype(np.float32)}


def embed_loss(table, ids, c, c2, form: str):
    """(y, logits or None, sum(y * c) [+ sum(logits * c2)]): ``embed``'s
    rows of ``ids`` (vocab-parallel under a context: ``table`` is then
    this rank's rows of the ``c2.shape[-1]`` words) and, for the "tied"
    form, their logits against the tied table as ``lm._logits`` takes it
    from ``lm._logit_params``."""
    import types

    from repro_torch.models.common import embed, unembed
    from repro_torch.models.lm import _logit_params
    from repro_torch.tree import Axes
    vocab = c2.shape[-1]
    params = {"embed": {"table": {"w": table,
                                  "axes": Axes(("vocab", "embed"))}}}
    y = embed(params["embed"], ids, torch.float32, vocab=vocab)
    loss = torch.sum(y * c)
    logits = None
    if form == "tied":
        cfg = types.SimpleNamespace(vocab=vocab, tie_embeddings=True)
        logits = unembed(_logit_params(params, cfg)["embed"], y,
                         torch.float32)
        loss = loss + torch.sum(logits * c2)
    return y, logits, loss


def embed_rank(grid, inputs: dict, shape, form: str) -> dict:
    """The vocab-parallel ``embed`` on this rank of the ``shape`` mesh:
    the ids of its batch rows against the table's rows of its "model"
    coordinate (``embed_loss`` of ``form`` under the context); y, the
    logits and the gradient, with respect to those rows, of the loss of
    the first model rank (the others' times zero: every model rank has
    the same rows)."""
    from repro_torch.launch import context as dist_ctx
    from repro_torch.launch.mesh import make_data_model_mesh
    from repro_torch.launch.sharding import P, block
    mesh = make_data_model_mesh(grid, *shape)
    ctx = dist_ctx.DistContext(mesh=mesh, dp=("data",))
    dev = grid.device
    table = block(torch.from_numpy(inputs["table"]), P("model", None), mesh)
    table = table.clone().to(dev).requires_grad_(True)
    rows = [block(torch.from_numpy(inputs[k]), P("data"), mesh).to(dev)
            for k in ("ids", "c", "c2")]
    with dist_ctx.use(ctx):
        y, logits, loss = embed_loss(table, *rows, form)
        if mesh.coords["model"]:
            loss = loss * 0.0
        (g,) = torch.autograd.grad(loss, [table])
    return {"coords": dict(mesh.coords), "y": _np(y),
            "logits": None if logits is None else _np(logits),
            "grad": _np(g), "counts": dict(mesh.counts)}


def fsdp_case(grid) -> dict:
    """A 4M-element leaf with the llama3-405b rule's spec on the 2x2 mesh
    (TP over "model", FSDP over "data"): this rank's block through
    ``shard_tree`` and the whole leaf back through ``gather_tree``."""
    from repro_torch.launch.mesh import make_data_model_mesh
    from repro_torch.launch.sharding import (_spec_for_axes, gather_tree,
                                             shard_tree)
    mesh = make_data_model_mesh(grid)
    rng = np.random.default_rng(32)
    shape = (4096, 1024)
    full = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    spec = _spec_for_axes((None, "mlp"), shape, mesh, fsdp=True)
    tree = {"w": full.to(grid.device), "b": {"x": full[:8, :8].clone()}}
    specs = {"w": spec, "b": {"x": type(spec)(None, None)}}
    blocks = shard_tree(tree, specs, mesh)
    back = gather_tree(blocks, specs, mesh)
    return {"spec": tuple(spec), "block_shape": tuple(blocks["w"].shape),
            "identical": bool(torch.equal(back["w"].cpu(), full)
                              and torch.equal(back["b"]["x"].cpu(),
                                              full[:8, :8])),
            "counts": dict(mesh.counts)}


def launch_cases(grid, path) -> dict:
    """test_torch_launch.py's rank body: ``embed_rank`` on every mesh of
    MESHES in both EMBED_FORMS, ``fsdp_case``, and this rank's
    coordinates on each mesh."""
    from repro_torch.launch.mesh import make_data_model_mesh, make_grid_mesh
    inputs = dict(np.load(path))
    out = {f"{s[0]}x{s[1]}.{form}": embed_rank(grid, inputs, s, form)
           for s in MESHES for form in EMBED_FORMS}
    out["fsdp"] = fsdp_case(grid)
    out["coords"] = {"grid": make_grid_mesh(grid).coords, **{
        f"{s[0]}x{s[1]}": make_data_model_mesh(grid, *s).coords
        for s in MESHES}}
    return out


def sharded_run(grid, case: dict) -> dict:
    """``case["steps"]`` steps of the sharded ``make_train_step`` of the
    tiny config of ``case["arch"]`` at ``case["policy"]`` on the
    ``case["mesh"]`` mesh (``seq_shard`` as given), from the seeded
    params and batches every process makes alike: the losses and grad
    norms, the params and moments gathered back to full leaves and, with
    ``case["aux"]``, ``sharded_aux`` before the first step."""
    from repro_torch import tree
    from repro_torch.configs import ShapeCell, get_tiny_config
    from repro_torch.data import make_batch
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_data_model_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    cfg = get_tiny_config(case["arch"], policy=case["policy"])
    mesh = make_data_model_mesh(grid, *case["mesh"])
    cell = ShapeCell("e2e", "train", case["seq"], case["batch"])
    dist = shd.dist_for(cfg, cell, mesh, seq_shard=case["seq_shard"])
    bspecs = shd.batch_shardings(cfg, cell, mesh,
                                 seq_shard=case["seq_shard"])
    step = make_train_step(cfg, remat=case["remat"], lr=case["lr"],
                           dist=dist)
    full = init_params(case["seed"], cfg, device=grid.device)
    compress = cfg.get_policy().opt_compression is not None
    opt = adamw_init(full, compress_moments=compress)
    ospecs = shd.opt_shardings(opt, step.plan.specs, mesh)
    params, opt = step.plan.shard(full), shd.shard_tree(opt, ospecs, mesh)
    aux = sharded_aux(step, cfg, dist, params, shd.shard_tree(make_batch(
        cfg, cell, 0, seed=case["seed"], device=grid.device), bspecs,
        mesh)) if case.get("aux") else None
    mesh.reset_counts()
    losses, gnorms = [], []
    for i in range(case["steps"]):
        batch = make_batch(cfg, cell, i, seed=case["seed"],
                           device=grid.device)
        params, opt, m = step(params, opt, shd.shard_tree(batch, bspecs,
                                                          mesh))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    params = shd.gather_tree(params, step.plan.specs, mesh)
    opt = shd.gather_tree(opt, ospecs, mesh)
    return {"losses": losses, "grad_norms": gnorms, "aux": aux,
            "seq": dist.seq, "dp": dist.dp,
            "params": [_np(w) for w in tree.leaves(params)],
            "moments": [_np(w) for w in tree.leaves(opt["moments"])],
            "counts": dict(mesh.counts)}


def sharded_aux(step, cfg, dist, params, batch) -> float:
    """The summed MoE load-balance loss of the layers in the sharded
    step's forward on this rank's ``params`` and ``batch`` blocks."""
    from repro_torch.core.policy import torch_dtype
    from repro_torch.launch import context as dist_ctx
    from repro_torch.launch.mesh import all_gather
    from repro_torch.launch.steps import _cast_params
    from repro_torch.models.lm import _backbone
    tokens = batch["tokens"]
    with torch.no_grad(), dist_ctx.use(dist):
        if dist.seq is not None:
            tokens = all_gather(tokens, dist.mesh, dist.seq, 1)
        full = step.plan.gather(_cast_params(
            params, torch_dtype(cfg.get_policy().compute_dtype)))
        _, aux = _backbone(full, dict(batch, tokens=tokens), cfg)
    return float(aux)


def sharded_runs(grid, cases: dict) -> dict:
    return {name: sharded_run(grid, case) for name, case in cases.items()}


def sharded_cases(grid, ep_path, runs: dict) -> dict:
    """test_torch_sharded.py's rank body: ``ep_cases`` on the inputs in
    ``ep_path``, then ``sharded_runs`` of ``runs``."""
    return {"ep": ep_cases(grid, ep_path), "runs": sharded_runs(grid, runs)}


def ep_assemble(ranks, tag: str, shape):
    """``ep_cases``' per-rank results of ``tag`` on the ``shape`` mesh put
    together: y by batch rows; x's gradient summed over "model" by batch
    rows, the router's over every rank, each expert stack's summed over
    "data" and concatenated over "model".  ``ranks``: each rank's
    ``ep_cases`` dict."""
    p, q = shape
    x = ep_inputs()["x"]
    rows = x.shape[0] // p
    y, gx = np.zeros_like(x), np.zeros_like(x)
    grads = {"router": 0.0}
    experts = {k: [0.0] * q for k in EXPERT_KEYS[1:]}
    for r in ranks:
        got = r[tag]
        d, m = got["coords"]["data"], got["coords"]["model"]
        y[d * rows:(d + 1) * rows] = got["y"]
        gx[d * rows:(d + 1) * rows] += got["grads"]["x"]
        grads["router"] = grads["router"] + got["grads"]["router"]
        for k in experts:
            experts[k][m] = experts[k][m] + got["grads"][k]
    grads["x"] = gx
    grads.update({k: np.concatenate(v) for k, v in experts.items()})
    return y, grads


def ep_local(device="cpu"):
    """One process's ``moe_apply_local`` on ``ep_inputs()`` on ``device``:
    y and the gradients of sum(y * c), numpy."""
    from repro_torch.models.ffn import moe_apply_local
    inputs = ep_inputs()
    cfg = ep_config()
    params = moe_params(inputs, device)
    x = torch.from_numpy(inputs["x"]).to(device).requires_grad_(True)
    y, _ = moe_apply_local(params, x, cfg, cfg.get_policy(), torch.float32)
    leaves = [x, params["router"]["w"]["w"]] + [params[k]["w"]
                                                 for k in EXPERT_KEYS[1:]]
    grads = torch.autograd.grad(torch.sum(
        y * torch.from_numpy(inputs["c"]).to(device)), leaves)
    return _np(y), dict(zip(("x",) + EXPERT_KEYS, map(_np, grads)))


def card_sharded_codec(grid, case: dict) -> dict:
    """``sharded_run`` of ``case`` with every call of the two codec
    kernels' wrappers held to the plain codec on its own operand, bit for
    bit (the encode's words to ``core.posit.from_float32_bits`` narrowed
    to the wire dtype, the decode's pair to ``decode_split_f32_plain``):
    the run, the number of calls, the calls that differ and the launches
    the wrappers counted."""
    from repro_torch.kernels import posit_gemm as pg
    enc, dec = pg.encode_posit_f32, pg.decode_split_f32
    calls = []

    def same(a, b):
        return bool(torch.equal(a.view(torch.int32) if a.is_floating_point()
                                else a, b.view(torch.int32)
                                if b.is_floating_point() else b))

    def encode(x, fmt=pg.P32E2, out_dtype=torch.int32):
        out = enc(x, fmt, out_dtype=out_dtype)
        want = posit.from_float32_bits(x, fmt).to(out_dtype)
        calls.append(("encode", fmt.name, same(out, want)))
        return out

    def decode(p, fmt=pg.P32E2):
        hi, lo = dec(p, fmt)
        ph, pl = pg.decode_split_f32_plain(p, fmt)
        calls.append(("decode", fmt.name, same(hi, ph) and same(lo, pl)))
        return hi, lo
    pg.reset_launch_counts()
    encode.launches = decode.launches = 0
    pg.encode_posit_f32, pg.decode_split_f32 = encode, decode
    try:
        out = sharded_run(grid, case)
    finally:
        enc.launches, dec.launches = encode.launches, decode.launches
        pg.encode_posit_f32, pg.decode_split_f32 = enc, dec
    out.update(calls=len(calls), bad=[c for c in calls if not c[2]][:4],
               launches=pg.launch_counts())
    return out
