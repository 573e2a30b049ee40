"""Posit-compressed gradient collectives (counterpart of
``repro.launch.collectives``), over one axis of a ``dist.grid.Grid``.

``compressed_psum`` is the two-phase all-reduce with both wire phases
carried as Posit(16,1) words (int16) after golden-zone re-centering by
``_GRAD_SCALE``: the reduce-scatter is an all-to-all of the encoded
chunks, after which each rank decodes the P chunks it received and sums
them; the all-gather carries each rank's encoded sum.  2 x n x 2 bytes
on the wire against an f32 all-reduce's 2 x n x 4.  The codec is
``core.policy``'s: the hand-written kernels on the card.

The decoded chunks are summed one after another in source order
(``((c0 + c1) + c2) + ...``), the order of the reference's
``jnp.sum(..., axis=0)`` on the host, so the two packages give the same
words.  Every collective goes through ``dist.comm``, which counts the
bytes of its result under ``grid.counting``: int16 words on both phases.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.core.policy import decode_tensor, encode_tensor
from repro_torch.dist import comm
from repro_torch.dist.comm import limb_psum  # noqa: F401  (the reference's)
from repro_torch.dist.grid import Grid

_GRAD_SCALE = 2.0 ** 8     # golden-zone re-centering for layer-norm'd grads


def compressed_psum(x: torch.Tensor, grid: Grid, axis: str = "all",
                    scale: float = _GRAD_SCALE) -> torch.Tensor:
    """Sum ``x`` over ``axis`` with p16e1 words on the wire (reduce-scatter
    as an all-to-all of encoded chunks, then an all-gather of the encoded
    chunk sums); the result in ``x``'s dtype and shape on every rank."""
    p = grid.axis_size(axis)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % p
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(p, -1)
    sc = torch.tensor(scale, dtype=torch.float32, device=x.device)
    enc = encode_tensor(chunks * sc, "p16e1")                     # int16
    recv = comm.all_to_all(enc, grid, axis, 0, 0)                 # (p, m)
    dec = decode_tensor(recv, "p16e1")
    own = dec[0]
    for i in range(1, p):
        own = own + dec[i]
    full = comm.all_gather(encode_tensor(own, "p16e1"), grid, axis)
    inv = torch.tensor(1.0 / scale, dtype=torch.float32, device=x.device)
    out = decode_tensor(full, "p16e1") * inv
    return out.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def compressed_psum_tree(tree, grid: Grid, axis: str = "all",
                         min_size: int = 1 << 12):
    """``compressed_psum`` on the floating leaves of at least
    ``min_size`` elements; the other leaves take a plain psum."""
    def one(g):
        if g.numel() >= min_size and g.dtype.is_floating_point:
            return compressed_psum(g, grid, axis)
        return comm.psum(g, grid, axis)
    return _tree.map(one, tree)
