"""The assigned input-shape set, the same four cells for every LM arch
(counterpart of ``repro.configs.shapes``).

``train_*`` is a training step, ``prefill_*`` the forward logits over
the full prompt, ``decode_*``/``long_*`` one serve step against a cache
of the given length.  long_500k requires a sub-quadratic stack (ssm /
hybrid / local-windowed); pure full-attention archs skip it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    needs_sub_quadratic: bool = False


SHAPE_CELLS = [
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1, needs_sub_quadratic=True),
]


def cell_by_name(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def applicable_cells(cfg: ArchConfig) -> list[ShapeCell]:
    return [c for c in SHAPE_CELLS
            if not (c.needs_sub_quadratic and not cfg.sub_quadratic)]


def tiny_config(name: str) -> ArchConfig:
    """Test-scale variant of an arch: the family's smoke config with a
    tiny vocab / FFN / modality stub, the same layer count, period
    structure and head layout."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(name)
    repl: dict = {"name": cfg.name.replace("smoke", "tiny"),
                  "vocab": min(cfg.vocab, 128)}
    if cfg.d_ff:
        repl["d_ff"] = min(cfg.d_ff, 96)
    if cfg.enc_seq:
        repl["enc_seq"] = min(cfg.enc_seq, 16)
    if cfg.vis_tokens:
        repl["vis_tokens"] = min(cfg.vis_tokens, 4)
    return dataclasses.replace(cfg, **repl)
