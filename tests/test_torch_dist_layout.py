"""The port's block-cyclic index math and collective plans equal the
reference's, in-process (repro_torch.dist.layout / pblas / pdecomp
against repro.dist): no ranks are spawned.

Grids 1x1, 2x2, 1x4, 4x1 and 2x3, with shapes that do not divide by the
block, so the padding blocks and ranks that hold only padding are
covered.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from repro.core import formats as JF
from repro.dist import layout as JL
from repro.dist import pblas as JB
from repro.dist import pdecomp as JD
from repro_torch.core import formats as TF
from repro_torch.dist import layout as TL
from repro_torch.dist import pblas as TB
from repro_torch.dist import pdecomp as TD

import torch
import cpu_tests  # noqa: F401  (one PyTorch thread)

GRIDS = [(1, 1), (2, 2), (1, 4), (4, 1), (2, 3)]
# (m, k, n, nb): A (m, k), B (k, n)
SHAPES = [(96, 80, 64, 32), (67, 45, 130, 16)]
# jitted once per layout: eager jnp compiles op by op
_j_scatter = jax.jit(JL.scatter_array, static_argnums=1)
_j_gather = jax.jit(JL.gather_array, static_argnums=1)
CASES = [(p, q, s) for p, q in GRIDS for s in SHAPES]
IDS = [f"{p}x{q}-{s[0]}x{s[1]}x{s[2]}nb{s[3]}" for p, q, s in CASES]


def _lays(p, q, shape):
    m, k, n, nb = shape
    mk = dict(p=p, q=q, nb=nb)
    return ((JL.BlockCyclic(m=m, n=k, **mk), JL.BlockCyclic(m=k, n=n, **mk)),
            (TL.BlockCyclic(m=m, n=k, **mk), TL.BlockCyclic(m=k, n=n, **mk)))


@pytest.mark.parametrize("p,q,shape", CASES, ids=IDS)
def test_block_cyclic_descriptor(p, q, shape):
    for jl, tl in zip(*_lays(p, q, shape)):
        for prop in ("mb", "nbk", "lmb", "lnb", "lm", "ln"):
            assert getattr(tl, prop) == getattr(jl, prop), prop
        for bi in range(jl.mb):
            for bj in range(jl.nbk):
                assert tl.block_owner(bi, bj) == jl.block_owner(bi, bj)
        for j in range(jl.n):
            assert tl.col_block_home(j) == jl.col_block_home(j), j
        for g, lb in ((p, jl.lmb), (q, jl.lnb)):
            assert TL._perm(g, 0, lb) == JL._perm(g, 0, lb)


@pytest.mark.parametrize("p,q,shape", CASES, ids=IDS)
def test_scatter_gather_and_local_tiles(p, q, shape):
    rng = np.random.default_rng(sum(shape) + p * 10 + q)
    for jl, tl in zip(*_lays(p, q, shape)):
        x = rng.integers(-2**31, 2**31, (jl.m, jl.n), dtype=np.int64)
        x = x.astype(np.int32)
        want = np.asarray(_j_scatter(jnp.asarray(x), jl))
        got = TL.scatter_array(torch.from_numpy(x), tl)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(TL.gather_array(got, tl).numpy(),
                              np.asarray(_j_gather(want, jl)))
        assert np.array_equal(TL.gather_array(got, tl).numpy(), x)
        for r in range(p):
            for c in range(q):
                tile = TL.local_tile(torch.from_numpy(x), tl, r, c)
                assert np.array_equal(
                    tile.numpy(), want[r * tl.lm:(r + 1) * tl.lm,
                                       c * tl.ln:(c + 1) * tl.ln]), (r, c)


@pytest.mark.parametrize("p,q,shape", CASES, ids=IDS)
def test_local_gidx_unshuffle_select(p, q, shape):
    rng = np.random.default_rng(3)
    jl, tl = _lays(p, q, shape)[0][0], _lays(p, q, shape)[1][0]
    for axis, g in ((0, p), (1, q)):
        for coord in range(g):
            assert np.array_equal(
                TL.local_gidx(tl, axis, coord).numpy(),
                np.asarray(JL.local_gidx(jl, axis, coord)))
    for g in (p, q):
        x = rng.integers(-2**31, 2**31, (g, 2 * tl.nb, 3), dtype=np.int64)
        x = x.astype(np.int32)
        assert np.array_equal(TL.unshuffle(torch.from_numpy(x), g,
                                           tl.nb).numpy(),
                              np.asarray(JL.unshuffle(jnp.asarray(x), g,
                                                      jl.nb)))
    a_loc = rng.integers(-2**31, 2**31, (tl.lm, tl.ln), dtype=np.int64)
    a_loc = a_loc.astype(np.int32)
    for j in range(0, jl.n, jl.nb):
        w = min(jl.nb, jl.n - j)
        for coord in range(q):
            got = TL.select_block_col(torch.from_numpy(a_loc), tl, coord, j,
                                      w)
            want = JL.select_block_col(jnp.asarray(a_loc), jl, coord, j, w)
            assert np.array_equal(got.numpy(), np.asarray(want)), (j, coord)
    assert np.array_equal(TB._dist_col_order(tl).numpy(),
                          np.asarray(JB._dist_col_order(jl)))


@pytest.mark.parametrize("p,q,shape", CASES, ids=IDS)
def test_collective_plans(p, q, shape):
    (ja, jb), (ta, tb) = _lays(p, q, shape)
    for name in ("P32E2", "P16E1", "P8E0"):
        jf, tf = getattr(JF, name), getattr(TF, name)
        for ks in (False, True):
            assert (TB.pdgemm_collective_plan(ta, tb, k_split=ks, fmt=tf)
                    == JB.pdgemm_collective_plan(ja, jb, k_split=ks,
                                                 fmt=jf)), (name, ks)
        for nrhs in (1, 2):
            assert (TB.p_residual_plan(ta, nrhs=nrhs, fmt=tf)
                    == JB.p_residual_plan(ja, nrhs=nrhs, fmt=jf))
    for lay_j, lay_t in ((ja, ta), (jb, tb)):
        for algo in ("getrf", "potrf"):
            assert (TD.pfactor_collective_plan(lay_t, algo)
                    == JD.pfactor_collective_plan(lay_j, algo)), algo
    with pytest.raises(ValueError):
        TD.pfactor_collective_plan(ta, "geqrf")



@pytest.mark.parametrize("gpus,kw,err,match", [
    (0, {}, RuntimeError, "no CUDA device"),
    (1, {}, ValueError, "one GPU per rank"),
    (1, dict(backend="gloo", device="cuda"), ValueError, "host_staging"),
    (1, dict(backend="nccl", device="cuda", host_staging=True), ValueError,
     "without host staging"),
], ids=["default-no-gpu", "nccl-4-ranks-1-gpu", "gloo-cuda-unstaged",
        "nccl-staged"])
def test_launch_checks_placement_in_parent(monkeypatch, tmp_path, gpus, kw,
                                           err, match):
    """``launch.spawn``/``run`` default to the card (NCCL, ``cuda``) and
    check the placement in the parent, before starting a rank."""
    from repro_torch.dist import launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    for start in (launch.spawn, launch.run):
        with pytest.raises(err, match=match):
            start(print, 2, 2, tmp_path / start.__name__, **kw)
        assert not (tmp_path / start.__name__).exists()
