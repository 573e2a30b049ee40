"""The distribution context (counterpart of ``repro.launch.context``).

Step builders set it around a model function; the layers that need
collectives read it: the MoE dispatches to its expert-parallel path, the
embedding becomes vocab-parallel, the attention aligns its kv chunks with
the "model" shards of the sequence.  It is static configuration (the
mesh and the axis choices), not state.  The reference's context also
carries ``f32_partials`` (decode asks its products for an f32 output,
rounded afterwards); the port's products are always the f32 sum rounded
once, so it has no such flag.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

from repro_torch.launch.mesh import Mesh


@dataclasses.dataclass(frozen=True, eq=False)
class DistContext:
    mesh: Mesh
    dp: tuple[str, ...]            # data-parallel mesh axes for batch dims
    ep: str = "model"              # expert-parallel axis
    seq: Optional[str] = None      # sequence-sharding axis (activations)


_ctx: contextvars.ContextVar[Optional[DistContext]] = contextvars.ContextVar(
    "repro_torch_dist_context", default=None)


def current() -> Optional[DistContext]:
    return _ctx.get()


@contextlib.contextmanager
def use(dist: Optional[DistContext]):
    tok = _ctx.set(dist)
    try:
        yield
    finally:
        _ctx.reset(tok)
