"""Paged posit-word KV-cache for the continuous-batching engine
(counterpart of ``repro.serving.kv_cache``).

K/V are stored as posit words in the format's wire dtype (int16 for
p16e1: half the bytes of f32), in fixed-size pages, so a request holds
only the pages its length needs.

Layout
------
One pool pair per attention layer (kinds ``attn``/``local``; the SSM
state and the hybrid's shared block stay dense f32 in the engine)::

    k_pool, v_pool : (n_pages * page_size, n_kv_heads, d_head)

in the storage dtype (the wire dtype, or f32 when ``fmt is None``).  The
reference keeps one pool per period slot with a leading stacked-layer
axis; the port keeps one per layer, the same bytes.

A shared **block table** (max_batch, max_pages) int32 maps each request
row's page index to a physical page; -1 means unallocated and gathers
**page 0**, the reserved zero page that is never written.  Pages are
allocated in positional order, so row b's gathered dense cache is
position-contiguous: gathered slot s holds absolute position s.  Slots
past the row's valid length hold stale but finite words and are masked
exactly in attention.

Scatters address the flat pool by linear index ``page * page_size +
offset``.  Inactive rows (and prefill padding) carry one shared
out-of-bounds index; the reference drops those writes (``mode="drop"``).
PyTorch has no drop mode, so the port masks the out-of-bounds entries
out of the index set before it writes: they are never clamped onto a
real page.

The allocator is host-side (a free list and the numpy block table):
page churn is O(requests), not O(tokens).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.formats import get_format
from repro_torch.core.policy import wire_dtype
from repro_torch.kernels.posit_gemm import encode_posit_f32
from repro_torch.models.common import ArchConfig
from repro_torch.models.lm import slot_kinds
from repro_torch.serving.quantize import decode_words


@dataclasses.dataclass(frozen=True)
class PagedKVSpec:
    """Static shape of a paged pool set."""
    page_size: int = 16
    n_pages: int = 64            # physical pages (incl. reserved page 0)
    max_batch: int = 4           # decode width (static: bit-identity)
    max_pages: int = 8           # block-table columns = max seq / page_size
    fmt: str | None = "p16e1"    # wire storage; None = f32 baseline

    @property
    def s_gather(self) -> int:
        """Dense gathered length (= max supported sequence length)."""
        return self.max_pages * self.page_size

    def pages_for(self, seq_len: int) -> int:
        return -(-seq_len // self.page_size)


def kv_slot_indices(cfg: ArchConfig) -> list[int]:
    """Period-slot indices that carry an attention KV cache (the
    reference's pool keys)."""
    return [j for j, k in enumerate(slot_kinds(cfg))
            if k in ("attn", "local")]


def kv_layer_indices(cfg: ArchConfig) -> list[int]:
    """Layer indices that carry an attention KV cache (the port's pool
    keys)."""
    return [i for i, k in enumerate(cfg.layer_kinds())
            if k in ("attn", "local")]


def encode_kv(x: torch.Tensor, fmt_name: str | None) -> torch.Tensor:
    """f32 K/V -> storage words (identity when fmt is None): the
    reference's ``from_float32_bits`` rounding, by the elementwise encode
    kernel on a CUDA tensor, which writes the wire words in its one launch
    (its plain version on a CPU one)."""
    if fmt_name is None:
        return x.to(torch.float32)
    fmt = get_format(fmt_name)
    return encode_posit_f32(x.to(torch.float32), fmt,
                            out_dtype=wire_dtype(fmt))


def decode_kv(w: torch.Tensor, fmt_name: str | None,
              dtype=torch.float32) -> torch.Tensor:
    """storage words -> f32 K/V (identity when fmt is None)."""
    if fmt_name is None:
        return w.to(dtype)
    return decode_words(w, fmt_name).to(dtype)


def gather_linear_indices(block_table, page_size: int) -> torch.Tensor:
    """(B, P) block table -> (B, P*page_size) linear pool indices.
    Unallocated (-1) pages map to page 0 (the zero page)."""
    bt = torch.as_tensor(block_table).to(torch.int64).clamp(min=0)
    off = torch.arange(page_size, dtype=torch.int64, device=bt.device)
    lin = bt[:, :, None] * page_size + off[None, None, :]
    return lin.reshape(bt.shape[0], -1)


def gather_dense(pool: torch.Tensor, lin_idx: torch.Tensor, fmt_name,
                 dtype=torch.float32) -> torch.Tensor:
    """pool (n_pages*ps, H, D) + lin (B, Sg) -> dense (B, Sg, H, D)
    decoded K/V."""
    return decode_kv(pool[lin_idx], fmt_name, dtype)


def _scatter_in_bounds(pool, idx, words):
    """A copy of ``pool`` with ``words[r]`` at ``idx[r]`` for every
    in-bounds index; out-of-bounds entries (inactive rows, padding) are
    left out of the index set, the reference's ``mode="drop"``.  The
    in-bounds rows are picked where ``idx`` lives: the engine keeps its
    indices on the host, so picking them waits for no device work."""
    idx = torch.as_tensor(idx).to(torch.int64)
    sel = torch.nonzero((idx >= 0) & (idx < pool.shape[0])).squeeze(1)
    out = pool.clone()
    out[idx[sel].to(pool.device)] = words[sel.to(words.device)].to(
        pool.dtype)
    return out


def scatter_rows(pool: torch.Tensor, idx, rows: torch.Tensor,
                 fmt_name) -> torch.Tensor:
    """Write one (B, H, D) row batch into the flat pool at linear indices
    idx (B,); out-of-bounds indices are dropped.  Returns the new pool."""
    return _scatter_in_bounds(pool, idx, encode_kv(rows, fmt_name))


class PagePool:
    """Host-side page allocator and the device pools of every attention
    layer (``pools[i] = {"k", "v"}``)."""

    def __init__(self, cfg: ArchConfig, spec: PagedKVSpec, device="cuda"):
        self.cfg, self.spec = cfg, spec
        dev = _device.resolve(device)
        dt = (torch.float32 if spec.fmt is None
              else wire_dtype(get_format(spec.fmt)))
        shape = (spec.n_pages * spec.page_size, cfg.n_kv_heads, cfg.d_head)
        self.pools = {
            i: {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}
            for i in kv_layer_indices(cfg)}
        # page 0 is the reserved zero page
        self.free: list[int] = list(range(1, spec.n_pages))
        self.block_table = np.full((spec.max_batch, spec.max_pages),
                                   -1, np.int32)

    # -- allocation (host) -------------------------------------------------
    def can_alloc(self, n_pages: int) -> bool:
        return len(self.free) >= n_pages

    def alloc_row(self, row: int, n_pages: int) -> None:
        """Reserve n_pages for request row (positional order)."""
        if n_pages > self.spec.max_pages:
            raise ValueError(f"{n_pages} pages exceed the block table's "
                             f"{self.spec.max_pages} columns")
        if not self.can_alloc(n_pages):
            raise RuntimeError("page pool exhausted")
        if not (self.block_table[row] == -1).all():
            raise RuntimeError(f"row {row} not free")
        for i in range(n_pages):
            self.block_table[row, i] = self.free.pop()

    def free_row(self, row: int) -> None:
        for p in self.block_table[row]:
            if p >= 0:
                self.free.append(int(p))
        self.block_table[row] = -1

    def pages_in_use(self) -> int:
        return int((self.block_table >= 0).sum())

    def linear_index(self, row: int, pos: int) -> int:
        """Linear pool index of (row, absolute position); the
        out-of-bounds sentinel (a dropped scatter) if the position has
        no page."""
        ps = self.spec.page_size
        page = self.block_table[row, pos // ps]
        if page < 0:
            return self.spec.n_pages * ps
        return int(page) * ps + pos % ps

    # -- accounting --------------------------------------------------------
    def bytes(self) -> dict:
        """Stored pool bytes vs the f32-equivalent."""
        b = f32 = 0
        for kv in self.pools.values():
            for a in kv.values():
                b += a.numel() * a.element_size()
                f32 += a.numel() * 4
        return {"bytes": b, "f32_bytes": f32}
