"""The port's batch axis (repro_torch.lapack.decomp/solve/error_eval and
the GEMM) and its word-domain loop drivers, against the JAX package and
against the port's own 2-D words.

* ``rpotrf_loop``/``rgetrf_loop`` run the word-domain panels (per-op
  fast-backend words, |word| pivots): bit-identical to the reference's
  loop drivers and to the port's chain-form ``rpotrf``/``rgetrf``.
* ``rpotrf_batched``/``rgetrf_batched`` carry a leading batch axis through
  the panels, sweeps and GEMMs: every matrix's factor and pivots equal the
  reference's batched program and the port's 2-D call, bit for bit.
* ``backward_error_ensemble`` gives each cell the reference ensemble's
  ``e_posit`` and the port's 2-D study's, with the same backend; its
  binary32 side is batched library LAPACK, held to 0.5 digits.
* ``rgemm`` on 3-D operands gives each matrix the 2-D call's words
  (``xla_quire``, a batched f64 matmul, within the reference's bound).
* The GEMM sources built for the host (tests/host_kernels.py): one
  batched pre-pass + GEMM launch equals the per-matrix launches bit for
  bit, on ragged K (below one 16-row stage), N = 1, transposed and
  batch-strided views, p32e2 and p16e1, f32 and fused ±encode.

Faithful GEMMs, n = 25 (panels 8, 8, 8, 1 at nb = 8) and one batch of six
matrices keep the reference's compiles few and shared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import host_kernels as hk
import torch_inputs as ti
from repro.lapack import decomp as JD
from repro.lapack import error_eval as JE
from repro_torch.core import formats as TF
from repro_torch.core import posit as TP
from repro_torch.kernels import ops as TO
from repro_torch.kernels import posit_gemm as TG
from repro_torch.lapack import decomp as TD
from repro_torch.lapack import error_eval as TE
from repro_torch.lapack import solve as TS

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


N, NB, SIGMAS, SEEDS = 25, 8, (1e-2, 1.0, 1e2), (0, 1)
KW = dict(nb=NB, gemm_backend="faithful")


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return np.array_equal(np.asarray(got), np.asarray(want))


def _stack(make):
    """The ensemble's six matrices as p32e2 words (its cells, in order)."""
    a64 = np.stack([make(N, s, sd) for s in SIGMAS for sd in SEEDS])
    return TP.from_float64(torch.from_numpy(a64)).numpy()


def test_loop_drivers_bit_identical():
    """Word-domain panels, with a NaR in the LU's first panel column (its
    |word| wraps to -2^31, so it never pivots)."""
    spd = _stack(TE.make_spd)[1]
    gen = _stack(TE.make_general)[3]
    l_p = TD.rpotrf_loop(_t(spd), **KW)
    assert _same(l_p, JD.rpotrf_loop(jnp.asarray(spd), **KW))
    assert torch.equal(l_p, TD.rpotrf(_t(spd), **KW))
    for a in (gen, np.where(np.arange(N)[:, None] * N + np.arange(N) == 3 * N,
                            np.int32(-2**31), gen)):
        lu, piv = TD.rgetrf_loop(_t(a), **KW)
        lu_j, piv_j = JD.rgetrf_loop(jnp.asarray(a), **KW)
        assert _same(lu, lu_j) and _same(piv, piv_j)
        lu2, piv2 = TD.rgetrf(_t(a), **KW)
        assert torch.equal(lu, lu2) and torch.equal(piv, piv2)
    assert piv[0].item() != 3


def test_batched_drivers_bit_identical():
    gen, spd = _stack(TE.make_general), _stack(TE.make_spd)
    lu, piv = TD.rgetrf_batched(_t(gen), **KW)
    lu_j, piv_j = JD.rgetrf_batched(jnp.asarray(gen), **KW)
    assert _same(lu, lu_j) and _same(piv, piv_j)
    l_p = TD.rpotrf_batched(_t(spd), **KW)
    assert _same(l_p, JD.rpotrf_batched(jnp.asarray(spd), **KW))
    assert len(set(map(tuple, piv.tolist()))) > 1    # pivots per matrix
    for i in (0, 5):
        lu2, piv2 = TD.rgetrf(_t(gen[i]), **KW)
        assert torch.equal(lu[i], lu2) and torch.equal(piv[i], piv2)
        assert torch.equal(l_p[i], TD.rpotrf(_t(spd[i]), **KW))
    b = TP.from_float64(torch.from_numpy(
        np.random.default_rng(3).standard_normal((6, N))))
    x = TS.rgetrs(lu, piv, b)
    assert torch.equal(x[2], TS.rgetrs(lu[2], piv[2], b[2]))
    x = TS.rpotrs(l_p, b)
    assert torch.equal(x[4], TS.rpotrs(l_p[4], b[4]))
    with pytest.raises(ValueError):
        TD.rgetrf_batched(_t(gen[0]))


@pytest.mark.parametrize("algo", ["lu", "cholesky"])
def test_ensemble_matches_reference_and_2d_study(algo):
    cells = TE.backward_error_ensemble(N, SIGMAS, algo, SEEDS, device="cpu",
                                       **KW)
    want = JE.backward_error_ensemble(N, SIGMAS, algo, SEEDS, **KW)
    assert [(c.sigma, c.n, c.algo) for c in cells] == \
        [(w.sigma, w.n, w.algo) for w in want]
    for c, w in zip(cells, want):
        assert c.e_posit == w.e_posit, (c, w)
        assert abs(np.log10(c.e_binary32 / w.e_binary32)) < 0.5, (c, w)
    for i in (0, 3):
        sigma, seed = SIGMAS[i // 2], SEEDS[i % 2]
        study = TE.backward_error_study(N, sigma, algo, seed=seed,
                                        device="cpu", **KW)
        assert cells[i].e_posit == study.e_posit


@pytest.mark.parametrize("backend", ["faithful", "quire_exact",
                                     "pallas_split3", "xla_quire"])
def test_rgemm_batched_equals_per_matrix(backend):
    """The trailing-update form and the fused form (alpha=-1, beta=0) on
    3-D operands, B transposed through the last two axes."""
    rng = np.random.default_rng(4)
    a = ti.posits(rng, (3, 17, 9), -4, 4)
    b = ti.posits(rng, (3, 11, 9), -4, 4)
    c = ti.posits(rng, (3, 17, 11), -4, 4)
    for alpha, beta in ((-1.0, 1.0), (-1.0, 0.0)):
        got = TO.rgemm(a, b, c, alpha, beta, trans_b=True, backend=backend)
        for i in range(3):
            one = TO.rgemm(a[i], b[i], c[i], alpha, beta, trans_b=True,
                           backend=backend)
            if backend == "xla_quire":
                av, bv = TP.to_float64(a[i]), TP.to_float64(b[i]).T
                if beta:
                    err = ti.gemm_rel_err(TP.to_float64(got[i]), av, bv,
                                          TP.to_float64(c[i]))
                else:
                    err = ti.gemm_rel_err(-TP.to_float64(got[i]), av, bv)
                assert err < 1e-8, (alpha, beta, err)
            else:
                assert torch.equal(got[i], one), (backend, alpha, beta, i)


@pytest.fixture(scope="module")
def host_gemm_lib(tmp_path_factory):
    return hk.build_host_gemm_lib(tmp_path_factory.mktemp("host_gemm_b"))


@pytest.mark.parametrize("name", ["p32e2", "p16e1"])
def test_host_batched_launch_equals_per_matrix(host_gemm_lib, name):
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(5)

    def words(shape):
        return ti.posits(rng, shape, -4, 4, fmt).numpy()
    big = words((3, 50, 60))
    cases = [("ragged K", words((3, 40, 7)), words((3, 7, 30)), 16),
             ("N = 1", words((3, 33, 20)), words((3, 20, 1)), 16),
             ("transposed A", words((3, 20, 37)).transpose(0, 2, 1),
              words((3, 20, 5)), 128),
             ("strided views", big[:, 3:40, 5:45], big[:, 10:50, 20:29], 16)]
    for label, a, b, kc in cases:
        for mode in TG.MODES:
            for emit, negate in ((False, False), (True, False), (True, True)):
                got, planes = hk.host_tiled(host_gemm_lib, a, b, fmt, kc,
                                            mode, emit, negate)
                for i in range(3):
                    one, one_planes = hk.host_tiled(
                        host_gemm_lib, a[i], b[i], fmt, kc, mode, emit,
                        negate)
                    assert np.array_equal(got[i].view(np.int32),
                                          one.view(np.int32)), \
                        (label, mode, emit, negate, i)
                    for p, q in zip(planes, one_planes):
                        assert (p is None) == (q is None)
                        if p is not None:
                            assert np.array_equal(p[i].view(np.int32),
                                                  q.view(np.int32))
