"""The paper's §5.1 numerical-error protocol (Eqs. 4-5), counterpart of
``repro.lapack.error_eval``.

x_sol = (1/sqrt(N)) * ones; b = A @ x_sol in binary64; solve in posit
format ``fmt`` (Rpotrf+Rpotrs or Rgetrf+Rgetrs) and in binary32
(Spotrf+Spotrs / Sgetrf+Sgetrs); report

    e = |b - A x_hat| / |b|           (relative backward error, 2-norm)
    digits = log10(e_binary32 / e_posit)   (paper Fig. 7; > 0 => posit wins)

``backward_error_ensemble`` runs the protocol over a (sigma x seed) grid
as one batched factorization and solve; ``refinement_study`` compares a
plain solve with the quire-refined pair from the same factorization;
``mixed_precision_study`` compares the mixed-precision drivers (p16e1
factor + p32e2 quire refinement) with the full-width ones;
``least_squares_study`` runs the protocol on an over-determined system
through the QR solvers.

The inputs are made with numpy from ``seed`` exactly as the reference
makes them, so the same cell gives the same posit words in both packages.
Not ported yet: ``golden_zone_study`` (observability, ROADMAP A8).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.lapack import decomp, qr, refine, solve


def make_spd(n: int, sigma: float, seed: int = 0) -> np.ndarray:
    """A = X^T X with X ~ N(0, sigma) — the paper's Rpotrf input."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)) * sigma
    return x.T @ x


def make_general(n: int, sigma: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) * sigma


@dataclasses.dataclass
class ErrorResult:
    n: int
    sigma: float
    algo: str
    e_posit: float
    e_binary32: float
    fmt: str = "p32e2"

    @property
    def digits(self) -> float:
        return float(np.log10(self.e_binary32 / self.e_posit))


def _backward_error(a64: np.ndarray, xhat64: np.ndarray, b64: np.ndarray
                    ) -> float:
    r = b64 - a64 @ xhat64
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def backward_error_study(n: int, sigma: float, algo: str = "lu",
                         seed: int = 0, nb: int = 32,
                         gemm_backend: str = "faithful",
                         fmt: PositFormat = P32E2,
                         device="cuda") -> ErrorResult:
    """Run the full §5.1 protocol for one (N, sigma, algorithm, format)
    cell on ``device`` (raises if it names CUDA and no GPU is present)."""
    dev = _device.resolve(device)
    if algo == "cholesky":
        a64 = make_spd(n, sigma, seed)
    elif algo == "lu":
        a64 = make_general(n, sigma, seed)
    else:
        raise ValueError(algo)
    x_sol = np.full((n,), 1.0 / np.sqrt(n))
    b64 = a64 @ x_sol

    # posit path
    a_p = posit.from_float64(torch.from_numpy(a64).to(dev), fmt)
    b_p = posit.from_float64(torch.from_numpy(b64).to(dev), fmt)
    if algo == "cholesky":
        l_p = decomp.rpotrf(a_p, nb=nb, gemm_backend=gemm_backend, fmt=fmt)
        xhat_p = solve.rpotrs(l_p, b_p, fmt=fmt)
    else:
        lu_p, ipiv = decomp.rgetrf(a_p, nb=nb, gemm_backend=gemm_backend,
                                   fmt=fmt)
        xhat_p = solve.rgetrs(lu_p, ipiv, b_p, fmt=fmt)
    xhat64 = posit.to_float64(xhat_p, fmt).cpu().numpy()
    e_posit = _backward_error(a64, xhat64, b64)

    # binary32 path
    a32 = torch.from_numpy(a64).to(device=dev, dtype=torch.float32)
    b32 = torch.from_numpy(b64).to(device=dev, dtype=torch.float32)
    if algo == "cholesky":
        xhat32 = solve.spotrs(decomp.spotrf(a32), b32)
    else:
        lu32, piv = decomp.sgetrf(a32)
        xhat32 = solve.sgetrs(lu32, piv, b32)
    e_b32 = _backward_error(a64, xhat32.cpu().numpy().astype(np.float64),
                            b64)

    return ErrorResult(n=n, sigma=sigma, algo=algo, e_posit=e_posit,
                       e_binary32=e_b32, fmt=fmt.name)


# --------------------------------------------------------------------------
# batched ensemble protocol: many (sigma, seed) cells as one batched run
# --------------------------------------------------------------------------

def backward_error_ensemble(n: int, sigmas, algo: str = "lu", seeds=(0, 1),
                            nb: int = 32, gemm_backend: str = "xla_quire",
                            fmt: PositFormat = P32E2,
                            device="cuda") -> list[ErrorResult]:
    """The §5.1 protocol over a (sigma x seed) grid, batched: every posit
    factorization of the grid runs as one ``rpotrf_batched`` /
    ``rgetrf_batched`` (one kernel launch per trailing update for the
    whole batch with ``pallas_split3``), and the triangular solves carry
    the same batch axis.  Each cell's ``e_posit`` equals
    ``backward_error_study``'s with the SAME ``gemm_backend`` and ``nb``
    (``xla_quire``'s batched f64 matmul may order its sums otherwise);
    the binary32 side is batched library LAPACK, which may differ from the
    2-D calls at f32 rounding.  The defaults differ from the study's
    (``nb=32`` and ``xla_quire`` here, ``faithful`` there), as in the
    reference: pass them explicitly to compare the two."""
    dev = _device.resolve(device)
    make = {"cholesky": make_spd, "lu": make_general}.get(algo)
    if make is None:
        raise ValueError(algo)
    cells = [(s, sd) for s in sigmas for sd in seeds]
    a64 = np.stack([make(n, s, sd) for s, sd in cells])
    b64 = a64 @ np.full((n,), 1.0 / np.sqrt(n))

    a_p = posit.from_float64(torch.from_numpy(a64).to(dev), fmt)
    b_p = posit.from_float64(torch.from_numpy(b64).to(dev), fmt)
    if algo == "cholesky":
        l_p = decomp.rpotrf_batched(a_p, nb=nb, gemm_backend=gemm_backend,
                                    fmt=fmt)
        xhat_p = solve.rpotrs(l_p, b_p, fmt=fmt)
    else:
        lu_p, ipiv = decomp.rgetrf_batched(a_p, nb=nb,
                                           gemm_backend=gemm_backend,
                                           fmt=fmt)
        xhat_p = solve.rgetrs(lu_p, ipiv, b_p, fmt=fmt)
    xhat64 = posit.to_float64(xhat_p, fmt).cpu().numpy()

    a32 = torch.from_numpy(a64).to(device=dev, dtype=torch.float32)
    b32 = torch.from_numpy(b64).to(device=dev, dtype=torch.float32)[..., None]
    if algo == "cholesky":
        xhat32 = solve.spotrs(decomp.spotrf(a32), b32)
    else:
        lu32, piv = decomp.sgetrf(a32)
        xhat32 = solve.sgetrs(lu32, piv, b32)
    xhat32 = xhat32[..., 0].cpu().numpy().astype(np.float64)
    return [ErrorResult(n=n, sigma=s, algo=algo,
                        e_posit=_backward_error(a64[i], xhat64[i], b64[i]),
                        e_binary32=_backward_error(a64[i], xhat32[i],
                                                   b64[i]),
                        fmt=fmt.name)
            for i, (s, sd) in enumerate(cells)]


def _study_inputs(n, sigma, algo, seed, dev):
    """The §5.1 cell as the refinement studies pose it: (A, b) as p32e2
    words on ``dev`` and their exact f64 values (the problem the solver
    actually sees)."""
    if algo == "cholesky":
        a64 = make_spd(n, sigma, seed)
    elif algo == "lu":
        a64 = make_general(n, sigma, seed)
    else:
        raise ValueError(algo)
    b64 = a64 @ np.full((n,), 1.0 / np.sqrt(n))
    a_p = posit.from_float64(torch.from_numpy(a64).to(dev))
    b_p = posit.from_float64(torch.from_numpy(b64).to(dev))
    return (a_p, b_p, posit.to_float64(a_p).cpu().numpy(),
            posit.to_float64(b_p).cpu().numpy())


def _pair_error(a64q, b64q, x_hi, x_lo) -> float:
    return _backward_error(
        a64q, refine.pair_to_float64(x_hi, x_lo).cpu().numpy(), b64q)


# --------------------------------------------------------------------------
# beyond-paper: quire iterative refinement vs plain posit solve
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RefineResult:
    n: int
    sigma: float
    algo: str
    iters: int
    e_plain: float      # plain Rgetrs/Rpotrs from the same factorization
    e_ir: float         # after quire-exact iterative refinement

    @property
    def digits_gained(self) -> float:
        """Decimal digits of backward error recovered by refinement."""
        return float(np.log10(self.e_plain / max(self.e_ir, 1e-300)))


def refinement_study(n: int, sigma: float = 1.0, algo: str = "lu",
                     seed: int = 0, nb: int = 32, iters: int = 3,
                     gemm_backend: str = "xla_quire",
                     device="cuda") -> RefineResult:
    """§5.1 protocol (sigma=1) comparing the plain posit solve against
    rgesv_ir/rposv_ir from the SAME factorization, on ``device``.
    Backward errors are measured against the posit-held (A, b) the solver
    was given (decoded exactly to binary64)."""
    dev = _device.resolve(device)
    a_p, b_p, a64q, b64q = _study_inputs(n, sigma, algo, seed, dev)
    if algo == "cholesky":
        (x_hi, x_lo), l_p = refine.rposv_ir(a_p, b_p, iters=iters, nb=nb,
                                            gemm_backend=gemm_backend)
        x_plain = solve.rpotrs(l_p, b_p)
    else:
        (x_hi, x_lo), (lu, ipiv) = refine.rgesv_ir(
            a_p, b_p, iters=iters, nb=nb, gemm_backend=gemm_backend)
        x_plain = solve.rgetrs(lu, ipiv, b_p)
    e_plain = _backward_error(a64q, posit.to_float64(x_plain).cpu().numpy(),
                              b64q)
    return RefineResult(n=n, sigma=sigma, algo=algo, iters=iters,
                        e_plain=e_plain,
                        e_ir=_pair_error(a64q, b64q, x_hi, x_lo))


# --------------------------------------------------------------------------
# mixed-precision IR vs full-width IR on the §5.1 sigma grid
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MixedPrecisionResult:
    n: int
    sigma: float
    algo: str
    e_ir: float         # full-width (p32e2) factorization + refinement
    e_mp: float         # narrow (factor_fmt) factorization + p32e2 refinement
    factor_fmt: str = "p16e1"

    @property
    def digits_lost(self) -> float:
        """Decimal digits of backward error the narrow factorization costs
        AFTER refinement (~0 wherever the mp loop converges)."""
        return float(np.log10(max(self.e_mp, 1e-300)
                              / max(self.e_ir, 1e-300)))


def mixed_precision_study(n: int, sigma: float = 1.0, algo: str = "lu",
                          seed: int = 0, nb: int = 32, iters_ir: int = 3,
                          iters_mp: int | None = None,
                          gemm_backend: str = "xla_quire",
                          device="cuda") -> MixedPrecisionResult:
    """§5.1 protocol comparing ``rgesv_mp``/``rposv_mp`` (p16e1 factor +
    p32e2 quire refinement) against ``rgesv_ir``/``rposv_ir`` on the same
    (A, b) cell, on ``device``.  ``iters_mp=None`` uses each driver's
    default (8 LU / 16 Cholesky)."""
    dev = _device.resolve(device)
    a_p, b_p, a64q, b64q = _study_inputs(n, sigma, algo, seed, dev)
    mp_kw = {} if iters_mp is None else {"iters": iters_mp}
    if algo == "cholesky":
        ir, mp = refine.rposv_ir, refine.rposv_mp
    else:
        ir, mp = refine.rgesv_ir, refine.rgesv_mp
    (h_ir, l_ir), _ = ir(a_p, b_p, iters=iters_ir, nb=nb,
                         gemm_backend=gemm_backend)
    (h_mp, l_mp), _ = mp(a_p, b_p, nb=nb, gemm_backend=gemm_backend, **mp_kw)
    return MixedPrecisionResult(n=n, sigma=sigma, algo=algo,
                                e_ir=_pair_error(a64q, b64q, h_ir, l_ir),
                                e_mp=_pair_error(a64q, b64q, h_mp, l_mp))


# --------------------------------------------------------------------------
# the §5.1 protocol on the over-determined (least-squares) scenario
# --------------------------------------------------------------------------

def make_rect(m: int, n: int, sigma: float, seed: int = 0) -> np.ndarray:
    """A = X with X ~ N(0, sigma), (m, n) over-determined: the §5.1
    ensemble on the least-squares scenario (well conditioned, so the
    sigma sweep isolates the golden-zone scale effect)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)) * sigma


@dataclasses.dataclass
class LeastSquaresResult:
    m: int
    n: int
    sigma: float
    e_qr: float         # plain rgels (QR + back-substitution)
    e_ir: float         # rgels_ir (quire-exact CSNE refinement)
    e_mp: float         # rgels_mp (narrow factor + working-fmt refinement)
    e_opt: float        # the f64 lstsq optimum on the SAME posit-held data
    e_binary32: float   # sgels baseline
    factor_fmt: str = "p16e1"

    @property
    def digits(self) -> float:
        """Plain posit QR vs binary32 (paper Fig. 7 convention)."""
        return float(np.log10(self.e_binary32 / self.e_qr))

    @property
    def digits_gained(self) -> float:
        """Decimal digits of backward error the refinement recovers."""
        return float(np.log10(self.e_qr / max(self.e_ir, 1e-300)))

    @property
    def digits_from_opt(self) -> float:
        """Distance of the refined solve from the LS optimum of the
        posit-held problem (~0: the refinement reached it).  Quantizing
        (A, b) makes the system inconsistent, so even the exact LS
        solution keeps a residual ~ ||b|| eps_posit: ``e_opt``."""
        return float(np.log10(max(self.e_ir, 1e-300)
                              / max(self.e_opt, 1e-300)))

    @property
    def digits_lost(self) -> float:
        """Digits the narrow factorization costs after refinement."""
        return float(np.log10(max(self.e_mp, 1e-300)
                              / max(self.e_ir, 1e-300)))


def least_squares_study(m: int, n: int, sigma: float = 1.0, seed: int = 0,
                        nb: int = 16, iters_ir: int = 3,
                        iters_mp: int | None = None,
                        gemm_backend: str = "xla_quire",
                        device="cuda") -> LeastSquaresResult:
    """The §5.1 protocol on an over-determined system, on ``device``:
    x_sol = (1/sqrt(n)) ones, b = A x_sol in binary64, solved by plain
    ``rgels``, ``rgels_ir``, ``rgels_mp`` and binary32 ``sgels``.  Posit
    errors are measured against the posit-held (A, b) the solvers see,
    ``e_opt`` is ``np.linalg.lstsq``'s on the same data, and the binary32
    error is against the f64 originals."""
    dev = _device.resolve(device)
    a64 = make_rect(m, n, sigma, seed)
    b64 = a64 @ np.full((n,), 1.0 / np.sqrt(n))
    a_p = posit.from_float64(torch.from_numpy(a64).to(dev))
    b_p = posit.from_float64(torch.from_numpy(b64).to(dev))
    a64q = posit.to_float64(a_p).cpu().numpy()
    b64q = posit.to_float64(b_p).cpu().numpy()

    x_plain, _ = qr.rgels(a_p, b_p, nb=nb, gemm_backend=gemm_backend)
    (h_ir, l_ir), _ = qr.rgels_ir(a_p, b_p, iters=iters_ir, nb=nb,
                                  gemm_backend=gemm_backend)
    mp_kw = {} if iters_mp is None else {"iters": iters_mp}
    (h_mp, l_mp), _ = qr.rgels_mp(a_p, b_p, nb=nb, gemm_backend=gemm_backend,
                                  **mp_kw)
    e_qr = _backward_error(a64q, posit.to_float64(x_plain).cpu().numpy(),
                           b64q)
    x_opt = np.linalg.lstsq(a64q, b64q, rcond=None)[0]
    x32 = qr.sgels(torch.from_numpy(a64).to(device=dev, dtype=torch.float32),
                   torch.from_numpy(b64).to(device=dev, dtype=torch.float32))
    return LeastSquaresResult(
        m=m, n=n, sigma=sigma, e_qr=e_qr,
        e_ir=_pair_error(a64q, b64q, h_ir, l_ir),
        e_mp=_pair_error(a64q, b64q, h_mp, l_mp),
        e_opt=_backward_error(a64q, x_opt, b64q),
        e_binary32=_backward_error(
            a64, x32.cpu().numpy().astype(np.float64), b64))
