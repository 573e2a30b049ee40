"""Quire-exact iterative refinement on the PyTorch/CUDA port (beyond
paper Fig. 7): the port of ``examples/quire_refine.py``.

Factorize once in Posit(32,2), then recover f64-class solutions with the
posit-standard quire: exact residuals, one rounding each, and a
double-posit (hi + lo) iterate.  The multi-RHS block shows the "many
scenarios" path: one factorization, the refinement run over a batch of
right-hand sides.

    PYTHONPATH=src python examples/torch_quire_refine.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when torch
sees no GPU.
"""
import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import posit as P
from repro_torch.lapack import refine, solve
from repro_torch.lapack.error_eval import make_general, refinement_study


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=256, help="matrix size")
    ap.add_argument("--nb", type=int, default=32, help="block size")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n, nb = args.n, args.nb
    out = {}

    print(f"== paper §5.1 protocol, N={n}, phi=0 ensemble ==")
    print(f"{'algo':10s} {'e_plain':>12s} {'e_ir':>12s} "
          f"{'digits gained':>14s}")
    out["studies"] = {}
    for algo in ("lu", "cholesky"):
        r = refinement_study(n, 1.0, algo, nb=nb, iters=3, device=dev)
        out["studies"][algo] = r
        print(f"{algo:10s} {r.e_plain:12.3e} {r.e_ir:12.3e} "
              f"{r.digits_gained:+14.2f}")

    print("\n== one factorization, many right-hand sides (batched IR) ==")
    a64 = make_general(n, 1.0, seed=7)
    rng = np.random.default_rng(8)
    nrhs = 16
    b64 = a64 @ rng.standard_normal((n, nrhs))          # 16 scenarios
    a_p = P.from_float64(torch.from_numpy(a64).to(dev))
    b_p = P.from_float64(torch.from_numpy(b64).to(dev))

    (x_hi, x_lo), (lu, ipiv) = refine.rgesv_ir(a_p, b_p, iters=3, nb=nb)
    x64 = refine.pair_to_float64(x_hi, x_lo).cpu().numpy()
    a64q = P.to_float64(a_p).cpu().numpy()
    b64q = P.to_float64(b_p).cpu().numpy()
    res = (np.linalg.norm(b64q - a64q @ x64, axis=0)
           / np.linalg.norm(b64q, axis=0))
    out["batched"] = res
    print(f"batched backward errors over {nrhs} RHS: "
          f"max={res.max():.3e} median={np.median(res):.3e}")
    x_plain = P.to_float64(solve.rgetrs(lu, ipiv, b_p[:, 0])).cpu().numpy()
    e_plain = float(np.linalg.norm(b64q[:, 0] - a64q @ x_plain)
                    / np.linalg.norm(b64q[:, 0]))
    out["plain"] = e_plain
    print(f"(plain posit32 solve for comparison: {e_plain:.3e})")

    print("\n== mixed precision: factorize p16e1, refine with p32e2 quire ==")
    # The HPL-AI play: the O(n^3) factorization runs in the cheap
    # half-width format; quire-exact p32e2 residual sweeps recover the
    # full-width floor.  Same answer, cheaper factorization.
    (m_hi, m_lo), _ = refine.rgesv_mp(a_p, b_p[:, 0], iters=8, nb=nb)
    x_mp = refine.pair_to_float64(m_hi, m_lo).cpu().numpy()
    e_mp = float(np.linalg.norm(b64q[:, 0] - a64q @ x_mp)
                 / np.linalg.norm(b64q[:, 0]))
    out["mp"] = e_mp
    print(f"rgesv_mp (p16e1 factor + p32e2 refine): {e_mp:.3e} "
          f"(vs full-width IR {res[0]:.3e})")
    return out


if __name__ == "__main__":
    main()
