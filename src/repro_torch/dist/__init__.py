"""Distributed-memory posit linear algebra over ``torch.distributed``
(counterpart of ``repro.dist``, ScaLAPACK flavour).

The distributed routines keep every output word **bit-identical** to the
single-device routines: sharding is a pure schedule change, because each
rank's local product is the same backend reduction over the same full-K
operands, and the quire's cross-rank reduction is exact integer limb
adds.

    grid.py     the P x Q process grid (rank = r*Q + c), its row/column
                groups, host staging for several ranks on one GPU
    comm.py     the collectives (all-gather, psum, reduce-scatter,
                all-to-all, limb_psum) with the ``dist.*`` byte counters
    layout.py   2-D block-cyclic DistMatrix (each rank holds its tile)
    pblas.py    pdgemm (SUMMA owner-computes / quire limb K-split),
                p_residual_quire, pdgemm_ft
    pdecomp.py  p_rpotrf / p_rgetrf / p_rgesv_ir / p_rposv_ir and the
                protected p_rpotrf_ft / p_rgetrf_ft with checkpoints
    launch.py   start a grid of ranks on one host (spawn + file
                rendezvous) and collect their results

Every rank calls every routine (they meet in the collectives).  On a CUDA
grid each rank's ``pallas_split3`` product is the Hopper GEMM kernel.
"""
from repro_torch.dist.grid import Grid, StageClock, make_grid
from repro_torch.dist.layout import (BlockCyclic, DistMatrix, dist_array,
                                     distribute, gather_array, local_tile,
                                     scatter_array)
from repro_torch.dist.pblas import (p_residual_plan, p_residual_quire,
                                    pdgemm, pdgemm_collective_plan,
                                    pdgemm_ft)
from repro_torch.dist.pdecomp import (p_rgesv_ir, p_rgetrf, p_rgetrf_ft,
                                      p_rposv_ir, p_rpotrf, p_rpotrf_ft,
                                      pfactor_collective_plan)

__all__ = [
    "Grid", "StageClock", "make_grid", "BlockCyclic", "DistMatrix",
    "distribute", "scatter_array", "gather_array", "local_tile",
    "dist_array", "pdgemm", "p_residual_quire", "pdgemm_ft",
    "pdgemm_collective_plan", "p_residual_plan", "p_rpotrf", "p_rgetrf",
    "p_rgesv_ir", "p_rposv_ir", "p_rpotrf_ft", "p_rgetrf_ft",
    "pfactor_collective_plan",
]
