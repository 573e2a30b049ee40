"""Distributed posit solve on the PyTorch/CUDA port: a grid of ranks,
bit-identical words.  The port of ``examples/dist_solve.py``.

Factor A in Posit(32,2) across a P x Q grid of ranks (2 x 4 by default;
block-cyclic layout, SUMMA trailing updates), refine with DISTRIBUTED
quire residuals (limb-plane psum), and check the refined pair is
word-for-word the single-device result — the posit determinism story
surviving distribution.

    PYTHONPATH=src python examples/torch_dist_solve.py [--device cpu]

The ranks are processes started by ``dist.launch``.  On the GPU they all
share one card (gloo collectives on host copies, since NCCL takes one
GPU per rank); with ``--device cpu`` they run gloo on the host.  Raises
when torch sees no GPU and ``--device cpu`` is not given.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import posit as P
from repro_torch.dist import distribute, launch, p_rgesv_ir, pdgemm
from repro_torch.kernels.ops import rgemm
from repro_torch.lapack import refine


def solve_rank(grid, a_words, b_words, nb):
    """One rank's part: the distributed IR solve and the k-split quire
    GEMM; rank 0 returns the gathered words."""
    a_d = distribute(torch.from_numpy(a_words), grid, nb)
    b_p = torch.from_numpy(b_words).to(grid.device)
    (x_hi, x_lo), (lu_d, _) = p_rgesv_ir(a_d, b_p, iters=3)
    lu = lu_d.gather()
    c = pdgemm(a_d, a_d, backend="quire_exact", k_split=True).gather()
    if grid.rank == 0:
        return {k: t.cpu() for k, t in
                dict(x_hi=x_hi, x_lo=x_lo, lu=lu, c=c).items()}
    return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=128, help="matrix size")
    ap.add_argument("--nb", type=int, default=32, help="block size")
    ap.add_argument("--p", type=int, default=2, help="grid rows")
    ap.add_argument("--q", type=int, default=4, help="grid columns")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n, nb, nrhs, p, q = args.n, args.nb, 4, args.p, args.q
    kw = dict(backend="gloo", device=dev, host_staging=dev.type == "cuda")
    print(f"ranks: {p * q} (gloo, tiles on {dev.type})")

    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((n, n))
    x_true = rng.standard_normal((n, nrhs))
    a_p = P.from_float64(torch.from_numpy(a64).to(dev))
    b_p = P.from_float64(torch.from_numpy(a64 @ x_true).to(dev))

    print(f"\n== distributed IR solve, N={n}, grid {p}x{q}, nb={nb}, "
          f"{nrhs} right-hand sides ==")
    with tempfile.TemporaryDirectory() as workdir:
        ranks = launch.spawn(solve_rank, p, q, workdir,
                             args=(a_p.cpu().numpy(), b_p.cpu().numpy(), nb),
                             **kw)
        # the single-device words, while the ranks run
        (x_hi_s, x_lo_s), (lu_s, _) = refine.rgesv_ir(a_p, b_p, iters=3,
                                                      nb=nb)
        c_s = rgemm(a_p, a_p, backend="quire_exact")
        got = ranks.join(timeout=1800)[0]

    a64q = P.to_float64(a_p).cpu().numpy()
    b64q = P.to_float64(b_p).cpu().numpy()
    x64 = refine.pair_to_float64(got["x_hi"], got["x_lo"]).numpy()
    res = (np.linalg.norm(b64q - a64q @ x64, axis=0)
           / np.linalg.norm(b64q, axis=0))
    print("relative residuals per RHS:", np.array2string(res, precision=2))

    single = dict(x_hi=x_hi_s, x_lo=x_lo_s, lu=lu_s, c=c_s)
    same = {k: bool(torch.equal(got[k], single[k].cpu())) for k in single}
    print("\n== bit-identity vs single-device rgesv_ir ==")
    print("x_hi words identical:", same["x_hi"])
    print("x_lo words identical:", same["x_lo"])
    print("LU words identical:  ", same["lu"])
    print("\n== distributed GEMM check: L@U in quire k-split schedule ==")
    print("pdgemm(k_split) identical:", same["c"])
    return dict(residuals=res, identical=same, a_words=a_p.cpu().numpy(),
                c_words=got["c"].numpy())


if __name__ == "__main__":
    main()
