"""Deterministic seeded fault injection for the ABFT stack (counterpart of
``repro.ft.inject``).

A fault plan is built on the host from a seed (a numpy Generator, drawn
in the reference's order, so the same seed gives the same ``Fault``
tuple in both packages), then applied as a word or limb transform: the
matching faults become index writes on a clone of the tensor, on its
device.  The same plan gives the same corrupted words on the CPU and on a
GPU.

Fault model: transient corruption of STORED values — a posit word (or a
quire limb) changes between the instant a protected op produces it (and
its checksums) and the instant a consumer verifies it.  The protected
drivers' injection sites sit in that window, which is why detection is
total.

Schedule coordinates, as in the reference:

* ``site`` — a dataflow location name (``"rgemm.out"``, ``"rgetrf.step"``,
  ``"rgemm.limbs"``, ...); each protected driver documents its sites.
* ``step`` — block-step index the fault fires on (-1 = every step).
* ``lane`` — flat element index into the target (row-major, reduced mod
  size so any lane is valid for any shape).
* ``bit`` — bit to flip (0..31 for posit words, 0..63 for int64 limbs).
* ``kind`` — ``"flip"`` (XOR one bit), ``"nar"`` (the format's NaR
  pattern), ``"saturate"`` (maxpos).
* ``dev`` — for distributed sites: the device id whose replica is
  corrupted (-1 = all).  The single-device transforms here apply every
  matching fault whatever its ``dev``, as the reference's do when given
  no device id.

Narrow formats' words are sign-extended int32: a flip above the format's
bits changes the stored word and not its value, which the raw word sums
of the checksums catch.  Faults fire only on a driver's FIRST attempt at
a step (transient errors do not recur), which is what makes recovery
bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import P32E2, PositFormat

_KINDS = ("flip", "nar", "saturate")


def _i32_mask(bit: int) -> int:
    """XOR mask for posit-word bit ``bit`` as a Python int in int32
    range (bit 31 is the sign/NaR bit: mask -2^31)."""
    m = 1 << (bit & 31)
    return m - (1 << 32) if m >= (1 << 31) else m


def _i64_mask(bit: int) -> int:
    """XOR mask for limb bit ``bit`` in int64 range."""
    m = 1 << (bit & 63)
    return m - (1 << 64) if m >= (1 << 63) else m


@dataclasses.dataclass(frozen=True)
class Fault:
    site: str
    step: int = 0
    lane: int = 0
    bit: int = 0
    kind: str = "flip"
    dev: int = -1

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A static, hashable injection schedule.  ``words`` / ``limbs`` are
    the two apply transforms; each returns its input unchanged when no
    fault matches, else a corrupted copy."""
    faults: tuple = ()

    def at(self, site: str, step: int):
        return tuple(f for f in self.faults
                     if f.site == site and f.step in (-1, step))

    def words(self, site: str, step: int, words: torch.Tensor,
              fmt: PositFormat = P32E2):
        """Apply every matching fault to an int32 posit-word tensor."""
        hits = self.at(site, step)
        if not hits:
            return words
        out = words.to(torch.int32).clone(
            memory_format=torch.contiguous_format)
        flat = out.view(-1)
        for f in hits:
            i = f.lane % flat.numel()
            if f.kind == "flip":
                flat[i] = flat[i] ^ _i32_mask(f.bit)
            elif f.kind == "nar":
                flat[i] = fmt.nar_pattern
            else:                                        # saturate: +maxpos
                flat[i] = (1 << (fmt.nbits - 1)) - 1
        return out

    def limbs(self, site: str, step: int, limbs: torch.Tensor):
        """Apply matching bit flips to an int64 quire limb tensor
        (``nar``/``saturate`` are word-domain kinds; ignored here)."""
        hits = [f for f in self.at(site, step) if f.kind == "flip"]
        if not hits:
            return limbs
        out = limbs.to(torch.int64).clone(
            memory_format=torch.contiguous_format)
        flat = out.view(-1)
        for f in hits:
            i = f.lane % flat.numel()
            flat[i] = flat[i] ^ _i64_mask(f.bit)
        return out


def make_plan(seed: int, site: str, size: int, steps: int = 1, n: int = 1,
              kinds=("flip",), nbits: int = 32, devs: int = 0) -> FaultPlan:
    """Seeded random schedule: ``n`` faults at ``site``, each with a
    uniform step in [0, steps), lane in [0, size), bit in [0, nbits),
    kind from ``kinds``, and (if ``devs`` > 0) a target device in
    [0, devs).  The reference's draws in the reference's order."""
    rng = np.random.default_rng(seed)
    faults = []
    for _ in range(n):
        faults.append(Fault(
            site=site, step=int(rng.integers(steps)),
            lane=int(rng.integers(size)), bit=int(rng.integers(nbits)),
            kind=str(kinds[int(rng.integers(len(kinds)))]),
            dev=int(rng.integers(devs)) if devs else -1))
    return FaultPlan(tuple(faults))
