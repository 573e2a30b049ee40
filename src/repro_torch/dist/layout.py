"""2-D block-cyclic layouts for distributed posit matrices (counterpart of
``repro.dist.layout``).

A posit matrix is int32 words.  Global block (bi, bj) — ``nb x nb`` words
— is owned by grid position (bi mod P, bj mod Q) and stored at that
rank's local block (bi // P, bj // Q), ScaLAPACK's descriptor:

        global blocks                rank (r, c) local tiles
      bj:  0    1    2    3            holds bi ≡ r (mod P),
    bi 0  0,0  0,1  0,0  0,1                 bj ≡ c (mod Q)
       1  1,0  1,1  1,0  1,1        e.g. P=Q=2, rank (0,1):
       2  0,0  0,1  0,0  0,1             blocks (0,1) (0,3)
       3  1,0  1,1  1,0  1,1                    (2,1) (2,3)

**Representation.**  The reference holds ONE (P*lm, Q*ln) array, rank
(r, c)'s (lm, ln) tile at rows [r*lm, (r+1)*lm) — the "dist array", a
row/column permutation of the zero-padded global matrix.  Here each rank
holds its own tile (``DistMatrix.data``); ``scatter_array`` /
``gather_array`` are the same index math on the whole dist array (pure,
any device), ``local_tile`` cuts one rank's tile out of a replicated
matrix, and ``dist_array`` / ``DistMatrix.gather`` assemble the tiles
with one all-gather.  Padding blocks hold word 0 (value 0) and are the
highest-indexed global blocks.

Rank-side helpers (the grid coordinate is this rank's, a Python int):
``local_gidx`` (global index of every local row/col), ``unshuffle``
(gathered tiles -> global order) and ``select_block_col`` (one global
block column of the local tile, or zeros off its owner).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import comm
from repro_torch.dist.grid import Grid

__all__ = ["BlockCyclic", "DistMatrix", "distribute", "scatter_array",
           "gather_array", "local_tile", "dist_array", "local_gidx",
           "unshuffle", "select_block_col"]


@dataclasses.dataclass(frozen=True)
class BlockCyclic:
    """Layout descriptor: (m, n) global posit matrix, nb x nb blocks,
    P x Q grid.  Hashable."""
    m: int
    n: int
    nb: int
    p: int
    q: int

    @property
    def mb(self) -> int:                     # global block rows
        return -(-self.m // self.nb)

    @property
    def nbk(self) -> int:                    # global block cols
        return -(-self.n // self.nb)

    @property
    def lmb(self) -> int:                    # local block rows per rank
        return -(-self.mb // self.p)

    @property
    def lnb(self) -> int:                    # local block cols per rank
        return -(-self.nbk // self.q)

    @property
    def lm(self) -> int:                     # local rows per rank
        return self.lmb * self.nb

    @property
    def ln(self) -> int:                     # local cols per rank
        return self.lnb * self.nb

    def block_owner(self, bi: int, bj: int) -> tuple[int, int]:
        return bi % self.p, bj % self.q

    def col_block_home(self, j: int) -> tuple[int, int, int]:
        """Global column j -> (owner grid column, local block col index,
        offset within the local tile)."""
        bj = j // self.nb
        return bj % self.q, bj // self.q, (bj // self.q) * self.nb + j % self.nb


def _perm(g: int, blocks: int, lb: int):
    """Dist-order block index list: entry k = (k // lb) + g * (k % lb)
    (position (grid coord, local t) holds global block coord + g*t)."""
    return [(k // lb) + g * (k % lb) for k in range(g * lb)]


def scatter_array(x, lay: BlockCyclic) -> torch.Tensor:
    """Replicated (m, n) posit words -> (P*lm, Q*ln) dist array (index
    permutation + zero padding)."""
    x = torch.as_tensor(x).to(torch.int32)
    if tuple(x.shape) != (lay.m, lay.n):
        raise ValueError(f"shape {tuple(x.shape)} does not match {lay}")
    full = torch.zeros((lay.p * lay.lm, lay.q * lay.ln), dtype=torch.int32,
                       device=x.device)
    full[:lay.m, :lay.n] = x
    t = full.reshape(lay.p * lay.lmb, lay.nb, lay.q * lay.lnb, lay.nb)
    bi = torch.tensor(_perm(lay.p, lay.mb, lay.lmb), device=x.device)
    bj = torch.tensor(_perm(lay.q, lay.nbk, lay.lnb), device=x.device)
    return t[bi][:, :, bj].reshape(lay.p * lay.lm, lay.q * lay.ln)


def gather_array(d, lay: BlockCyclic) -> torch.Tensor:
    """(P*lm, Q*ln) dist array -> replicated (m, n) posit words (inverse
    of ``scatter_array``)."""
    d = torch.as_tensor(d)
    t = d.reshape(lay.p, lay.lmb, lay.nb, lay.q, lay.lnb, lay.nb)
    # dist block (r, t) holds global block r + P*t: ascending global order
    # is (t outer, r inner); padding blocks land at the end of each axis.
    g = t.permute(1, 0, 2, 4, 3, 5).reshape(lay.p * lay.lm, lay.q * lay.ln)
    return g[:lay.m, :lay.n]


def local_gidx(lay: BlockCyclic, axis: int, coord: int,
               device=None) -> torch.Tensor:
    """Global row (axis=0) / column (axis=1) index of every local row/col
    of the rank at grid coordinate ``coord``: local position t*nb + u maps
    to global (coord + g*t)*nb + u.  Padding rows/cols map past m/n —
    callers mask with ``< lay.m`` / ``< lay.n``.  int64 (index dtype)."""
    g, lb = (lay.p, lay.lmb) if axis == 0 else (lay.q, lay.lnb)
    t = torch.arange(lb, dtype=torch.int64, device=device)
    u = torch.arange(lay.nb, dtype=torch.int64, device=device)
    return ((coord + g * t[:, None]) * lay.nb + u[None, :]).reshape(-1)


def local_tile(x: torch.Tensor, lay: BlockCyclic, r: int,
               c: int) -> torch.Tensor:
    """Rank (r, c)'s (lm, ln) tile of the replicated (m, n) words ``x``:
    block (r, c) of ``scatter_array(x, lay)``, cut without building the
    rest."""
    x = torch.as_tensor(x).to(torch.int32)
    gr = local_gidx(lay, 0, r, x.device)
    gc = local_gidx(lay, 1, c, x.device)
    tile = x[gr.clamp(max=lay.m - 1)][:, gc.clamp(max=lay.n - 1)]
    keep = (gr < lay.m)[:, None] & (gc < lay.n)[None, :]
    return torch.where(keep, tile, 0)


def unshuffle(gathered: torch.Tensor, g: int, nb: int) -> torch.Tensor:
    """(g, lb*nb, ...) gathered local tiles -> (g*lb*nb, ...) rows in
    GLOBAL order (gathered[r', t] holds global block r' + g*t, so
    ascending order is t-major)."""
    lb = gathered.shape[1] // nb
    t = gathered.reshape((g, lb, nb) + tuple(gathered.shape[2:]))
    t = t.movedim(0, 1)
    return t.reshape((g * lb * nb,) + tuple(gathered.shape[2:]))


def select_block_col(a_loc: torch.Tensor, lay: BlockCyclic, coord: int,
                     j: int, w: int) -> torch.Tensor:
    """Global columns [j, j+w) of a local tile: the owner grid column's
    (lm, w) slice, zeros elsewhere — so a psum along "col" broadcasts the
    panel to the grid row.  The panel may not straddle a block boundary
    (j % nb + w <= nb, the LAPACK panel shape)."""
    c_star, _, off = lay.col_block_home(j)
    if j % lay.nb + w > lay.nb:
        raise ValueError(f"panel [{j}, {j + w}) straddles a block of "
                         f"{lay.nb}")
    sl = a_loc[:, off:off + w]
    return sl if coord == c_star else torch.zeros_like(sl)


def dist_array(tile: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Every rank's (lm, ln) tile as the reference's (P*lm, Q*ln) dist
    array (one all-gather over the world), on every rank."""
    g = comm.all_gather(tile, grid, "all")             # (P*Q, lm, ln)
    lm, ln = tile.shape
    return g.reshape(grid.p, grid.q, lm, ln).permute(0, 2, 1, 3).reshape(
        grid.p * lm, grid.q * ln)


@dataclasses.dataclass
class DistMatrix:
    """A block-cyclic distributed posit matrix as this rank sees it:
    ``data`` is its (lm, ln) int32 tile, on the grid's device."""
    data: torch.Tensor
    layout: BlockCyclic
    grid: Grid

    @property
    def shape(self):
        return (self.layout.m, self.layout.n)

    def gather(self) -> torch.Tensor:
        """The global (m, n) words, on every rank (a collective: every
        rank calls it)."""
        return gather_array(dist_array(self.data, self.grid), self.layout)

    def with_data(self, data: torch.Tensor) -> "DistMatrix":
        return DistMatrix(data=data, layout=self.layout, grid=self.grid)


def distribute(x, grid: Grid, nb: int = 32) -> DistMatrix:
    """A replicated (m, n) posit-word matrix (the same on every rank) ->
    this rank's tile of it, on the grid's device."""
    x = torch.as_tensor(x).to(torch.int32)
    lay = BlockCyclic(m=x.shape[0], n=x.shape[1], nb=nb, p=grid.p, q=grid.q)
    tile = local_tile(x.to(grid.device), lay, grid.r, grid.c)
    return DistMatrix(data=tile, layout=lay, grid=grid)
