"""The port's distributed routines (repro_torch.dist) on gloo ranks:
their words equal (a) the port's single-device words and (b) the JAX
package's words on a 2x2 grid, bit for bit.

One spawn per grid (2x2, 1x4, 4x1), the three at once, each rank a fresh
process joined through a rendezvous file under ``tmp_path``
(``repro_torch.dist.launch``), at the reference tests' sizes
((96, 80) @ (80, 64), n=96, nb=32; tests/test_dist.py).  The reference's
2x2 words come from one subprocess with 8 forced host devices (the
``multi_device`` fixture), read back on the host as
``gather_array(np.asarray(d.data), d.layout)`` — its own
``DistMatrix.gather`` fails on sharded arrays under this jax.  The
refinement drivers gather their factors themselves in the reference, so
the port's pair words are held to its single-device ``rgesv_ir`` /
``rposv_ir`` instead (the reference's contract: equal words).
The factorizations run every backend in the port and one each in the
reference (``REF_POTRF``/``REF_GETRF``: its distributed programs compile
for ~17 s apiece).  The ``dist.*`` counters, counted at the port's
collectives, equal the port's plans, which equal the reference's.
"""
import numpy as np
import pytest

from repro.core import formats as JF
from repro.dist import pblas as JB
from repro.dist import pdecomp as JD
from repro_torch.core.formats import P16E1
from repro_torch.dist import launch
from repro_torch.dist.layout import BlockCyclic
from repro_torch.dist.pblas import p_residual_plan, pdgemm_collective_plan
from repro_torch.dist.pdecomp import pfactor_collective_plan
from repro_torch.kernels.ops import rgemm
from repro_torch.lapack import decomp, refine

import torch_dist_cases as tc
import cpu_tests  # noqa: F401  (one PyTorch thread)

GRIDS = [(2, 2), (1, 4), (4, 1)]
GIDS = [f"{p}x{q}" for p, q in GRIDS]

_REF = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import posit as P
from repro.core.formats import P16E1
from repro.dist import (distribute, make_grid_mesh, pdgemm,
                        p_residual_quire, p_rpotrf, p_rgetrf)
from repro.dist.layout import gather_array
from repro.lapack import refine

raw = np.load(%(inp)r)
def enc(keys, *fmt):
    # one encode of all the arrays, flat (the codec is elementwise): one
    # compile a format instead of one a shape
    flat = np.concatenate([raw[k].ravel() for k in keys])
    words, i, w = np.asarray(P.from_float64(jnp.asarray(flat), *fmt)), 0, {}
    for k in keys:
        w[k] = jnp.asarray(words[i:i + raw[k].size].reshape(raw[k].shape))
        i += raw[k].size
    return w
w = {**enc([k for k in raw.files if not k.endswith("16")]),
     **enc([k for k in raw.files if k.endswith("16")], P16E1)}
mesh = make_grid_mesh(2, 2)
nb = %(nb)d
def g(d):
    return np.asarray(gather_array(np.asarray(d.data), d.layout))
out = {}
for k in raw.files:
    out["in." + k] = np.asarray(w[k])
ad, bd = distribute(w["a"], mesh, nb), distribute(w["b"], mesh, nb)
for backend in %(backends)r:
    out["pdgemm." + backend] = g(pdgemm(ad, bd, backend=backend))
out["pdgemm.k_split"] = g(pdgemm(ad, bd, backend="quire_exact",
                                 k_split=True))
out["pdgemm.k_split.ab"] = g(pdgemm(ad, bd, distribute(w["c0"], mesh, nb),
                                    alpha=-1.0, beta=1.0,
                                    backend="quire_exact", k_split=True))
a16, b16 = distribute(w["a16"], mesh, nb), distribute(w["b16"], mesh, nb)
for backend, ks in %(p16)r:
    out["pdgemm.p16e1.%%s.%%s" %% (backend, ks)] = g(pdgemm(
        a16, b16, backend=backend, k_split=ks, fmt=P16E1))
spd, gd = distribute(w["spd"], mesh, nb), distribute(w["g"], mesh, nb)
for backend in %(potrf)r:
    out["rpotrf." + backend] = g(p_rpotrf(spd, gemm_backend=backend))
for backend in %(getrf)r:
    lu, ipiv = p_rgetrf(gd, gemm_backend=backend)
    out["rgetrf." + backend] = g(lu)
    out["rgetrf." + backend + ".ipiv"] = np.asarray(ipiv)
xg = w["x_g"][:, 0]
out["residual"] = np.asarray(p_residual_quire(gd, xg, w["b_g"][:, 0]))
out["residual.pair"] = np.asarray(p_residual_quire(gd, xg, w["b_g"][:, 0],
                                                   xg))
(hi, lo), _ = refine.rgesv_ir(w["g"], w["b_g"], iters=%(iters)d, nb=nb)
out["rgesv_ir.hi"], out["rgesv_ir.lo"] = np.asarray(hi), np.asarray(lo)
(hi, lo), _ = refine.rposv_ir(w["spd"], w["b_spd"], iters=%(iters)d, nb=nb)
out["rposv_ir.hi"], out["rposv_ir.lo"] = np.asarray(hi), np.asarray(lo)
np.savez(%(out)r, **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, multi_device):
    """(reference 2x2 words, {grid: per-rank results}, input words)."""
    d = tmp_path_factory.mktemp("dist")
    inp = d / "in.npz"
    np.savez(inp, **tc.make_inputs())
    ranks = {g: launch.spawn(tc.dist_words, *g, d / f"grid{g[0]}x{g[1]}",
                             args=(str(inp), g == (2, 2)),
                             backend="gloo", device="cpu")
             for g in GRIDS}
    out = d / "ref.npz"
    assert "DONE" in multi_device(_REF % dict(
        inp=str(inp), out=str(out), nb=tc.NB, backends=tc.BACKENDS,
        p16=tc.P16_CASES, potrf=tc.REF_POTRF, getrf=tc.REF_GETRF,
        iters=tc.IR_ITERS), timeout=900)
    res = {g: r.join(timeout=900) for g, r in ranks.items()}
    return dict(np.load(out)), res, tc.load_words(inp)


def _words(res, grid, key):
    """Rank 0's gathered words of ``key``; every rank gathered the same."""
    got = res[grid][0]["words"][key]
    for r in res[grid][1:]:
        assert np.array_equal(r["words"][key], got), (grid, key, r["rank"])
    return got


_SINGLE = {}


def _check(runs, grid, key, single):
    """Equal to the port's single-device words (``single()``, computed
    once for the three grids) and, where the reference ran the case on its
    2x2 grid, to those."""
    ref, res, _ = runs
    got = _words(res, grid, key)
    if key not in _SINGLE:
        _SINGLE[key] = single()
    assert np.array_equal(got, _SINGLE[key]), (grid, key,
                                               "!= single-device port")
    if key.split(".")[0] in ("rpotrf", "rgetrf") and key not in ref:
        return
    assert np.array_equal(got, ref[key]), (grid, key, "!= reference 2x2")


def test_inputs_encode_alike(runs):
    ref, _, w = runs
    for k, v in w.items():
        assert np.array_equal(v.numpy(), ref["in." + k]), k


@pytest.mark.parametrize("backend", tc.BACKENDS)
@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_pdgemm_backends(runs, grid, backend):
    w = runs[2]
    _check(runs, grid, f"pdgemm.{backend}",
           lambda: rgemm(w["a"], w["b"], backend=backend).numpy())


@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_pdgemm_k_split(runs, grid):
    w = runs[2]
    _check(runs, grid, "pdgemm.k_split",
           lambda: rgemm(w["a"], w["b"], backend="quire_exact").numpy())
    _check(runs, grid, "pdgemm.k_split.ab",
           lambda: rgemm(w["a"], w["b"], w["c0"], alpha=-1.0, beta=1.0,
                         backend="quire_exact").numpy())


@pytest.mark.parametrize("backend,ks", tc.P16_CASES,
                         ids=[f"{b}-k_split={k}" for b, k in tc.P16_CASES])
@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_pdgemm_p16e1(runs, grid, backend, ks):
    w = runs[2]
    _check(runs, grid, f"pdgemm.p16e1.{backend}.{ks}",
           lambda: rgemm(w["a16"], w["b16"], backend=backend,
                         fmt=P16E1).numpy())


@pytest.mark.parametrize("backend", tc.POTRF_BACKENDS)
@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_p_rpotrf(runs, grid, backend):
    w = runs[2]
    _check(runs, grid, f"rpotrf.{backend}",
           lambda: decomp.rpotrf(w["spd"], nb=tc.NB,
                                 gemm_backend=backend).numpy())


@pytest.mark.parametrize("backend", tc.GETRF_BACKENDS)
@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_p_rgetrf(runs, grid, backend):
    w, lu_ipiv = runs[2], []

    def single(i):
        if not lu_ipiv:
            lu_ipiv.extend(t.numpy() for t in decomp.rgetrf(
                w["g"], nb=tc.NB, gemm_backend=backend))
        return lu_ipiv[i]
    _check(runs, grid, f"rgetrf.{backend}", lambda: single(0))
    _check(runs, grid, f"rgetrf.{backend}.ipiv", lambda: single(1))


@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_p_residual_quire(runs, grid):
    w = runs[2]
    x, b = w["x_g"][:, 0], w["b_g"][:, 0]
    _check(runs, grid, "residual",
           lambda: refine.residual_quire(w["g"], x, b).numpy())
    _check(runs, grid, "residual.pair",
           lambda: refine.residual_quire(w["g"], x, b, x).numpy())


@pytest.mark.parametrize("driver", ["rgesv_ir", "rposv_ir"])
def test_p_refinement_pair_words(runs, driver):
    """2x2: the pair words equal the reference's single-device driver's
    and the port's."""
    w = runs[2]
    if driver == "rgesv_ir":
        (hi, lo), _ = refine.rgesv_ir(w["g"], w["b_g"], iters=tc.IR_ITERS,
                                      nb=tc.NB)
    else:
        (hi, lo), _ = refine.rposv_ir(w["spd"], w["b_spd"],
                                      iters=tc.IR_ITERS, nb=tc.NB)
    _check(runs, (2, 2), f"{driver}.hi", hi.numpy)
    _check(runs, (2, 2), f"{driver}.lo", lo.numpy)


def _bytes(counters, op):
    pre, suf = f"dist.{op}.", ".bytes"
    return {k[len(pre):-len(suf)]: int(v) for k, v in counters.items()
            if k.startswith(pre) and k.endswith(suf)}


@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_dist_counters_equal_plans(runs, grid):
    """On every rank, the bytes counted at the collectives equal the
    port's plan, which equals the reference's; one call each."""
    p, q = grid
    m, k, n = tc.GEMM
    la, lb = (BlockCyclic(m=m, n=k, nb=tc.NB, p=p, q=q),
              BlockCyclic(m=k, n=n, nb=tc.NB, p=p, q=q))
    jla, jlb = (JB.BlockCyclic(m=m, n=k, nb=tc.NB, p=p, q=q),
                JB.BlockCyclic(m=k, n=n, nb=tc.NB, p=p, q=q))
    lsq = BlockCyclic(m=tc.N, n=tc.N, nb=tc.NB, p=p, q=q)
    jsq = JB.BlockCyclic(m=tc.N, n=tc.N, nb=tc.NB, p=p, q=q)
    want = {
        "pdgemm.xla_quire": ("pdgemm", pdgemm_collective_plan(la, lb),
                             JB.pdgemm_collective_plan(jla, jlb)),
        "pdgemm.k_split": ("pdgemm",
                           pdgemm_collective_plan(la, lb, k_split=True),
                           JB.pdgemm_collective_plan(jla, jlb,
                                                     k_split=True)),
        "rpotrf.xla_quire": ("rpotrf", pfactor_collective_plan(lsq, "potrf"),
                             JD.pfactor_collective_plan(jsq, "potrf")),
        "rgetrf.xla_quire": ("rgetrf", pfactor_collective_plan(lsq, "getrf"),
                             JD.pfactor_collective_plan(jsq, "getrf")),
        "residual": ("p_residual", p_residual_plan(lsq),
                     JB.p_residual_plan(jsq, fmt=JF.P32E2)),
    }
    for rank in runs[1][grid]:
        for key, (op, plan, jplan) in want.items():
            cnt = rank["counters"][key]
            assert _bytes(cnt, op) == plan == jplan, (rank["rank"], key)
            assert cnt[f"dist.{op}.calls"] == 1.0, (rank["rank"], key)


@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_rank_is_linear_grid_id(runs, grid):
    p, q = grid
    assert [(r["rank"], r["coords"]) for r in runs[1][grid]] == [
        (i, divmod(i, q)) for i in range(p * q)]
