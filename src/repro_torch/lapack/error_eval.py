"""The paper's §5.1 numerical-error protocol (Eqs. 4-5), counterpart of
``repro.lapack.error_eval``.

x_sol = (1/sqrt(N)) * ones; b = A @ x_sol in binary64; solve in posit
format ``fmt`` (Rpotrf+Rpotrs or Rgetrf+Rgetrs) and in binary32
(Spotrf+Spotrs / Sgetrf+Sgetrs); report

    e = |b - A x_hat| / |b|           (relative backward error, 2-norm)
    digits = log10(e_binary32 / e_posit)   (paper Fig. 7; > 0 => posit wins)

The inputs are made with numpy from ``seed`` exactly as the reference
makes them, so the same cell gives the same posit words in both packages.
``backward_error_ensemble`` and the refinement / mixed-precision /
least-squares studies wait for ROADMAP A5-A7.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.lapack import decomp, solve


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
