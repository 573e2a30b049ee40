"""Serving engine: prefill through the decode step, and continuous
batching over a paged posit KV-cache (counterpart of
``repro.serving.engine``).

Two layers:

* ``prefill`` / ``generate`` — per-token greedy decode over the dense
  ring caches of ``models.lm``.  ``prefill`` feeds the prompt through the
  decode step one token at a time, as the reference's scanned
  ``_prefill_scan`` does; ``prefill_loop``, the reference's per-token
  pin of its scan, is the same function here.

* ``Engine`` — requests are admitted into a fixed ``max_batch``-wide
  decode step as pages free up; each step decodes every in-flight
  request one token against the paged posit-word KV pools
  (``serving.kv_cache``), and finished requests release their pages at
  once.  Weights may be posit-quantized (``serving.quantize``): with
  ``backend="pallas"`` every linear of the step runs on the Hopper posit
  GEMM kernel.

Bit-identity of batched and sequential decode: the decode step runs at a
FIXED batch width; no row's content reaches another row (row-wise
matmuls at fixed shapes, per-row masks and scans; the posit kernel's
accumulation order is fixed per output); inactive rows are padding whose
scatters are dropped; and a request's gathered cache is
position-contiguous whichever physical pages back it.  The sequential
reference is the same engine with admission capped at one in-flight
request: the same step at the same width.  On a GPU this also needs
every library op to choose its algorithm by shape alone, never by
content (TF32 off; ``torch.matmul`` at the same fixed shapes in both).

Rounding contract for posit KV: a step's incoming K/V enters its own
attention in f32 and is rounded to the posit lattice once, at the pool
scatter; every later step reads the rounded words.

Counters (``repro_torch.obs``, with a collector open): ``serve.steps``
and ``serve.tokens`` (counters), ``serve.batch_occupancy`` and
``serve.kv_pages_in_use`` (gauges), as the reference records them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ArchConfig
from repro_torch.models.lm import (_dtype, _encoder, _layer_cache,
                                   init_cache, period_of, serve_step)
from repro_torch.serving.kv_cache import (PagedKVSpec, PagePool, encode_kv,
                                          gather_dense, gather_linear_indices,
                                          kv_layer_indices, scatter_rows,
                                          _scatter_in_bounds)


def _params_device(params) -> torch.device:
    t = params["embed"]["table"]
    return (t["qw"] if "qw" in t else t["w"]).device


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B, 1) int32: the first maximum, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def _step(params, cache, tok, pos, cfg: ArchConfig):
    logits, cache = serve_step(params, cache, tok, pos, cfg)
    return _greedy(logits), cache


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def _build_cross_kv(params, cfg, cache, extras):
    policy, dtype = _dtype(cfg)
    dev = _params_device(params)
    frames = torch.as_tensor(extras["frames"], device=dev)
    enc = _encoder(params, frames, cfg, policy, dtype)
    cache["cross_kv"] = [
        attn_mod.cross_kv_init(lp["xattn"], enc, cfg, policy, dtype)
        for lp in params["layers"]]
    return cache


def _prefill_scan(params, cache, prompts, plen: int, cfg: ArchConfig):
    """Feed ``prompts`` (B, nsteps) through the decode step.  Columns at
    i >= plen are padding: the reference runs them with its carry frozen,
    the port stops at plen, which leaves the same cache and last-token
    prediction.  Returns (cache, last (B, 1) int32)."""
    dev = _params_device(params)
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                           device=dev)
    last = torch.zeros((toks.shape[0], 1), dtype=torch.int32, device=dev)
    for i in range(min(plen, toks.shape[1])):
        nxt, cache = _step(params, cache, toks[:, i:i + 1], i, cfg)
        if i == plen - 1:
            last = nxt
    return cache, last


def prefill(params, cfg: ArchConfig, prompts: np.ndarray, cache_len: int,
            extras: dict[str, Any] | None = None):
    """Feed prompt tokens through the decode path to fill the cache.

    prompts: (B, P) int.  Returns (cache, last_token, next_pos)."""
    b, plen = prompts.shape
    cache = init_cache(cfg, b, cache_len, device=_params_device(params))
    if cfg.family == "encdec":
        cache = _build_cross_kv(params, cfg, cache, extras)
    cache, tok = _prefill_scan(params, cache, prompts, plen, cfg)
    return cache, tok, plen


# The reference keeps its per-token dispatch loop to pin the scanned
# prefill against; here ``prefill`` is already that loop.
prefill_loop = prefill


def generate(params, cfg: ArchConfig, prompts: np.ndarray, max_new: int = 16,
             cache_len: int | None = None, eos_id: int | None = None,
             extras: dict[str, Any] | None = None) -> np.ndarray:
    """Greedy decode: returns (B, max_new) generated token ids (fewer
    columns if every row met ``eos_id``; a finished row repeats it)."""
    b, plen = prompts.shape
    cache_len = cache_len or (plen + max_new)
    cache, tok, pos = prefill(params, cfg, prompts, cache_len, extras)
    out = []
    done = np.zeros((b,), bool)
    for t in range(max_new):
        nxt, cache = _step(params, cache, tok, pos + t, cfg)
        ids = nxt[:, 0].cpu().numpy()
        if eos_id is not None:
            done |= ids == eos_id
            ids = np.where(done, eos_id, ids)
        out.append(ids)
        tok = torch.as_tensor(ids[:, None], dtype=torch.int32,
                              device=nxt.device)
        if eos_id is not None and done.all():
            break
    return np.stack(out, axis=1)


# --------------------------------------------------------------------------
# continuous-batching engine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (plen,) int32
    max_new: int = 16
    eos_id: Optional[int] = None
    arrival: int = 0                   # traffic-replay step index


def _dense_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, device):
    """Like ``init_cache`` but with NO ring truncation for local layers:
    the engine's gathered caches are position-contiguous over the full
    page span, so every KV layer is a flat (B, seq_len, H, D)."""
    def layer(kind):
        return _layer_cache(cfg, "attn" if kind == "local" else kind, batch,
                            seq_len, dtype, device)

    cache: dict[str, Any] = {"layers": [layer(k) for k in cfg.layer_kinds()]}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        cache["shared"] = [layer("shared") for _ in
                           range(cfg.n_layers // period_of(cfg))]
    return cache


def _split_state(cfg, cache):
    """Engine-held dense state = everything that is NOT a paged KV layer
    (SSM conv/h state and the hybrid's shared attention block)."""
    state = {"ssm": {i: cache["layers"][i]
                     for i, k in enumerate(cfg.layer_kinds()) if k == "ssm"}}
    if "shared" in cache:
        state["shared"] = cache["shared"]
    return state


def _engine_step(params, pools, state, bt, tok, pos, scatter_idx,
                 cfg: ArchConfig, spec: PagedKVSpec):
    """One continuous-batching decode step at the fixed batch width.

    Gather each row's pages into a position-contiguous dense cache, run
    ``serve_step`` with per-row positions, then encode the new K/V rows
    to posit words and scatter them into the pools (inactive rows carry
    the out-of-bounds index and are dropped; ``scatter_idx`` may stay on
    the host).
    Returns (next tokens (B, 1), logits, new pools, new state)."""
    _, dtype = _dtype(cfg)
    lin = gather_linear_indices(bt, spec.page_size)
    layers = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "ssm":
            layers.append(state["ssm"][i])
        else:
            layers.append({"kv": {
                "k": gather_dense(pools[i]["k"], lin, spec.fmt, dtype),
                "v": gather_dense(pools[i]["v"], lin, spec.fmt, dtype)}})
    cache: dict[str, Any] = {"layers": layers}
    if "shared" in state:
        cache["shared"] = state["shared"]

    logits, new_cache = serve_step(params, cache, tok, pos, cfg)
    nxt = _greedy(logits)

    rows = torch.arange(pos.shape[0], device=pos.device)
    at = pos.to(torch.int64)
    new_pools = {}
    for i in kv_layer_indices(cfg):
        kv = new_cache["layers"][i]["kv"]
        new_pools[i] = {
            "k": scatter_rows(pools[i]["k"], scatter_idx, kv["k"][rows, at],
                              spec.fmt),
            "v": scatter_rows(pools[i]["v"], scatter_idx, kv["v"][rows, at],
                              spec.fmt)}
    return nxt, logits, new_pools, _split_state(cfg, new_cache)


def _set_row(state, pstate, row: int):
    """A copy of the state tree with row ``row`` of every tensor set from
    row 0 of the prefilled state's matching tensor."""
    if isinstance(state, dict):
        return {k: _set_row(v, pstate[k], row) for k, v in state.items()}
    if isinstance(state, list):
        return [_set_row(s, p, row) for s, p in zip(state, pstate)]
    out = state.clone()
    out[row] = pstate[0].to(out.dtype)
    return out


def _admit_write(pools, state, pcache, lin_idx, row: int,
                 cfg: ArchConfig, spec: PagedKVSpec):
    """Install a prefilled request: scatter its prompt K/V (encoded to
    the storage format) into the row's pages and copy its dense state
    (SSM / shared block) into engine row ``row``.  ``lin_idx`` covers
    the (bucket-padded) prompt span; pad entries are out of bounds."""
    nb = lin_idx.shape[0]
    new_pools = {}
    for i in kv_layer_indices(cfg):
        kv = pcache["layers"][i]["kv"]
        new_pools[i] = {
            "k": _scatter_span(pools[i]["k"], lin_idx, kv["k"][0, :nb],
                               spec.fmt),
            "v": _scatter_span(pools[i]["v"], lin_idx, kv["v"][0, :nb],
                               spec.fmt)}
    return new_pools, _set_row(state, _split_state(cfg, pcache), row)


def _scatter_span(pool, lin_idx, span, fmt_name):
    """Write (nb, H, D) span rows at linear indices (nb,); out-of-bounds
    (padding) entries are dropped."""
    return _scatter_in_bounds(pool, lin_idx, encode_kv(span, fmt_name))


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    """Continuous-batching serving engine over paged posit KV pools, on
    the device of ``params``.

    ``max_inflight`` caps concurrently decoding requests (the sequential
    bit-identity reference is ``max_inflight=1``: the same step at the
    same width).  ``kv_fmt`` selects the KV storage format (None = f32
    baseline); weight quantization is orthogonal (pass quantized params).
    """

    def __init__(self, params, cfg: ArchConfig, *, max_batch: int = 4,
                 page_size: int = 16, max_seq: int = 128,
                 n_pages: int | None = None, kv_fmt: str | None = None,
                 max_inflight: int | None = None):
        if cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                f"Engine does not serve {cfg.family} yet (extras "
                "plumbing); use serving.generate")
        max_pages = -(-max_seq // page_size)
        if n_pages is None:
            n_pages = max_batch * max_pages + 1      # + the zero page
        self.params, self.cfg = params, cfg
        self.device = _params_device(params)
        self.spec = PagedKVSpec(page_size=page_size, n_pages=n_pages,
                                max_batch=max_batch, max_pages=max_pages,
                                fmt=kv_fmt)
        self.pool = PagePool(cfg, self.spec, self.device)
        self.max_inflight = min(max_inflight or max_batch, max_batch)
        _, self.dtype = _dtype(cfg)
        self.state = _split_state(
            cfg, _dense_cache(cfg, max_batch, self.spec.s_gather,
                              self.dtype, self.device))
        self.queue: list[Request] = []
        self.slots: list[Optional[dict]] = [None] * max_batch
        self.tokens = np.zeros((max_batch, 1), np.int32)
        self.pos = np.zeros((max_batch,), np.int32)
        self.finished: dict[int, np.ndarray] = {}
        self.step_count = 0
        self._oob = self.spec.n_pages * self.spec.page_size

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if len(req.prompt) + req.max_new + 1 > self.spec.s_gather:
            raise ValueError("request exceeds engine max_seq")
        self.queue.append(req)

    def n_inflight(self) -> int:
        return sum(s is not None for s in self.slots)

    def _admit(self, req: Request, row: int) -> None:
        plen = len(req.prompt)
        need = self.spec.pages_for(plen + req.max_new + 1)
        self.pool.alloc_row(row, need)
        nb = _bucket(plen)
        padded = np.zeros((1, nb), np.int32)
        padded[0, :plen] = req.prompt
        cache0 = _dense_cache(self.cfg, 1, self.spec.s_gather, self.dtype,
                              self.device)
        cache1, last = _prefill_scan(self.params, cache0, padded, plen,
                                     self.cfg)
        lin = torch.as_tensor(
            [self.pool.linear_index(row, t) if t < plen else self._oob
             for t in range(nb)], dtype=torch.int64)
        self.pool.pools, self.state = _admit_write(
            self.pool.pools, self.state, cache1, lin, row, self.cfg,
            self.spec)
        self.slots[row] = {"req": req, "out": []}
        self.tokens[row] = last[0].cpu().numpy()
        self.pos[row] = plen

    def _finish(self, row: int) -> None:
        slot = self.slots[row]
        self.finished[slot["req"].rid] = np.asarray(slot["out"], np.int32)
        self.pool.free_row(row)
        self.slots[row] = None

    # -- stepping ----------------------------------------------------------
    def _try_admit(self) -> None:
        while self.queue and self.n_inflight() < self.max_inflight:
            req = self.queue[0]
            need = self.spec.pages_for(len(req.prompt) + req.max_new + 1)
            if not self.pool.can_alloc(need):
                break
            row = self.slots.index(None)
            self.queue.pop(0)
            self._admit(req, row)

    def step(self) -> list[int]:
        """Admit what fits, decode one token for every in-flight
        request, retire finished ones.  Returns the rids finished this
        step.  A request finishes after ``max_new`` tokens or on the
        token ``eos_id``, which it keeps as its last output."""
        self._try_admit()
        self.step_count += 1
        active = [b for b, s in enumerate(self.slots) if s is not None]
        obs.inc("serve.steps")
        obs.gauge("serve.batch_occupancy",
                  len(active) / self.spec.max_batch)
        obs.gauge("serve.kv_pages_in_use", self.pool.pages_in_use())
        if not active:
            return []
        scatter_idx = np.full((self.spec.max_batch,), self._oob, np.int64)
        for b in active:
            scatter_idx[b] = self.pool.linear_index(b, int(self.pos[b]))
        dev = self.device
        nxt, _, self.pool.pools, self.state = _engine_step(
            self.params, self.pool.pools, self.state,
            torch.as_tensor(self.pool.block_table, device=dev),
            torch.as_tensor(self.tokens, device=dev),
            torch.as_tensor(self.pos, device=dev),
            torch.from_numpy(scatter_idx), self.cfg, self.spec)
        nxt = nxt.cpu().numpy()
        obs.inc("serve.tokens", len(active))
        done_rids = []
        for b in active:
            slot = self.slots[b]
            req = slot["req"]
            tid = int(nxt[b, 0])
            slot["out"].append(tid)
            self.tokens[b] = tid
            self.pos[b] += 1
            if (len(slot["out"]) >= req.max_new
                    or (req.eos_id is not None and tid == req.eos_id)):
                done_rids.append(req.rid)
                self._finish(b)
        return done_rids

    def run(self, requests: list[Request], max_steps: int = 10000
            ) -> dict[int, np.ndarray]:
        """Serve a request list to completion; returns rid -> tokens."""
        for r in requests:
            self.submit(r)
        steps = 0
        while (self.queue or self.n_inflight()) and steps < max_steps:
            self.step()
            steps += 1
        if self.queue or self.n_inflight():
            raise RuntimeError(f"did not drain in {max_steps} steps")
        return dict(self.finished)

    # -- accounting --------------------------------------------------------
    def kv_bytes(self) -> dict:
        return self.pool.bytes()
