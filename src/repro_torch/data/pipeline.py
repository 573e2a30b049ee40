"""Deterministic synthetic data pipeline (counterpart of
``repro.data.pipeline``).

A batch is a pure function of (seed, step): a restarted job regenerates
the same stream from any step, the data half of fault tolerance (the
checkpoint is the other half).  The draws come from one CPU
``torch.Generator`` seeded from (seed, step), so the same batch lands on
any device.  The distribution is the reference's: token ids ``u^4 *
vocab`` for ``u`` uniform in [1e-6, 1) (a Zipf-like heavy head),
``targets`` the tokens shifted by one with a fresh last column, and the
stub modality inputs (``frames``, ``vis``) 0.1 x standard normal.  The
reference's threefry bits are not reproduced; tests that compare the two
packages feed both the same batch.

``input_specs`` gives (shape, dtype) stand-ins for every model input of a
(config, shape cell) pair, with no allocation.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import _device
from repro_torch.configs.shapes import ShapeCell
from repro_torch.models.common import ArchConfig


def _generator(seed: int, step: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed((int(seed) * 0x9E3779B1 + int(step)) % (1 << 63))
    return g


def _zipf_tokens(gen, shape, vocab: int) -> torch.Tensor:
    u = 1e-6 + (1.0 - 1e-6) * torch.rand(shape, generator=gen,
                                         dtype=torch.float32)
    ids = (u ** 4 * vocab).to(torch.int32)
    return torch.clamp(ids, 0, vocab - 1)


def make_batch(cfg: ArchConfig, cell: ShapeCell, step: int, seed: int = 0,
               batch_override: int | None = None,
               device="cuda") -> dict[str, Any]:
    """One global batch on ``device`` (smoke and e2e runs pass a small
    ``batch_override``)."""
    dev = _device.resolve(device)
    b = batch_override or cell.global_batch
    s = cell.seq_len
    gen = _generator(seed, step)
    tokens = _zipf_tokens(gen, (b, s), cfg.vocab)
    targets = torch.cat([tokens[:, 1:],
                         _zipf_tokens(gen, (b, 1), cfg.vocab)], dim=1)
    batch = {"tokens": tokens, "targets": targets}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model),
                                      generator=gen) * 0.1
    if cfg.family == "vlm":
        batch["vis"] = torch.randn((b, cfg.vis_tokens, cfg.d_model),
                                   generator=gen) * 0.1
    return {k: v.to(dev) for k, v in batch.items()}


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict[str, Any]:
    """(shape, dtype) of every model input of the cell, allocating
    nothing."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        specs = {"tokens": ((b, s), torch.int32),
                 "targets": ((b, s), torch.int32)}
        if cfg.family == "encdec":
            specs["frames"] = ((b, cfg.enc_seq, cfg.d_model), torch.float32)
        if cfg.family == "vlm":
            specs["vis"] = ((b, cfg.vis_tokens, cfg.d_model), torch.float32)
        return specs
    # decode: one incoming token + absolute position
    return {"tokens": ((b, 1), torch.int32), "pos": ((), torch.int32)}
