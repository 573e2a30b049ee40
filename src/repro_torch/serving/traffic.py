"""Synthetic traffic generation and replay for the serving engine
(counterpart of ``repro.serving.traffic``).

The replay driver feeds the engine a seeded synthetic trace (geometric
inter-arrival steps, Poisson prompt/output lengths) step by step, so
continuous batching interleaves requests at different depths.  The trace
is numpy from the seed, so both packages replay the same requests.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.engine import Engine, Request


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 16
    mean_plen: int = 12          # mean prompt length (>= 1)
    mean_new: int = 8            # mean generation length (>= 1)
    arrival_rate: float = 0.5    # expected request arrivals per step
    vocab: int = 128
    seed: int = 0


def synth_trace(tc: TrafficConfig) -> list[Request]:
    """Seeded synthetic request trace, sorted by arrival step."""
    rng = np.random.default_rng(tc.seed)
    step = 0
    out = []
    for rid in range(tc.n_requests):
        step += int(rng.geometric(min(max(tc.arrival_rate, 1e-6), 1.0)))
        plen = 1 + int(rng.poisson(max(tc.mean_plen - 1, 0)))
        max_new = 1 + int(rng.poisson(max(tc.mean_new - 1, 0)))
        prompt = rng.integers(0, tc.vocab, size=(plen,)).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt, max_new=max_new,
                           arrival=step))
    return out


def replay(engine: Engine, trace: list[Request],
           max_steps: int = 100000) -> dict:
    """Feed the trace into the engine respecting arrival steps; returns
    the throughput report (host wall-clock tokens/s and requests/s; each
    engine step ends on the host reading its tokens, so the wall covers
    the device's work) and the per-request outputs keyed by rid."""
    pending = sorted(trace, key=lambda r: r.arrival)
    step = 0
    occ_sum = 0.0
    t0 = time.perf_counter()
    while pending or engine.queue or engine.n_inflight():
        while pending and pending[0].arrival <= step:
            engine.submit(pending.pop(0))
        engine.step()
        occ_sum += engine.n_inflight() / engine.spec.max_batch
        step += 1
        if step >= max_steps:
            raise RuntimeError("replay did not drain")
    wall = time.perf_counter() - t0
    outputs = dict(engine.finished)
    tokens = int(sum(len(v) for v in outputs.values()))
    return {
        "requests": len(outputs),
        "tokens": tokens,
        "steps": step,
        "wall_s": wall,
        "tok_s": tokens / wall if wall > 0 else float("inf"),
        "req_s": len(outputs) / wall if wall > 0 else float("inf"),
        "occupancy": occ_sum / max(step, 1),
        "outputs": outputs,
    }
