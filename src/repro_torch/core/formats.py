"""Posit format descriptors (a copy of ``repro.core.formats``).

The port keeps its own copy of this pure-numpy module so that
``repro_torch`` imports nothing of the JAX package.  The two must stay
equal; ``tests/test_torch_posit.py`` checks that they agree.

A ``PositFormat`` pins down Posit(nbits, es) per the posit standard (2022)
and Gustafson & Yonemoto 2017 [11]:

    x = (-1)^s * u^k * 2^e * 1.f,   u = 2^(2^es)

Patterns are stored **sign-extended in int32** (int arithmetic negation of a
pattern is the posit negation, which keeps all ops branch-free).

Only the formats used by the paper + the framework are registered:
  * p32e2 — the paper's Posit(32,2), the working format of the LAPACK stack
  * p16e1 — half-width: the mixed-precision factorization format
            (lapack/refine.py rgesv_mp) and gradient / optimizer-state
            compression
  * p8e2  — narrow + wide dynamic range (es=2 stretches maxpos to 2^24);
            the Fixed-Posit-style accuracy/throughput trade point
  * p8e0  — beyond-paper: extreme compression experiments

Every registered format shares ONE field-space implementation in
core/posit.py (decode/encode/chain_round are parametric in (nbits, es)
and pinned bit-exact against the rational oracle per format in
tests/test_formats.py and tests/test_torch_posit.py); the derived
constants below are the only place format-specific numbers live.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PositFormat:
    nbits: int
    es: int

    # ---- derived constants -------------------------------------------------
    @property
    def name(self) -> str:
        return f"p{self.nbits}e{self.es}"

    @property
    def useed(self) -> int:
        return 1 << (1 << self.es)

    @property
    def max_k(self) -> int:
        return self.nbits - 2

    @property
    def max_scale(self) -> int:
        """Scale (power of two) of maxpos: (nbits-2) * 2^es."""
        return self.max_k << self.es

    @property
    def maxpos_pattern(self) -> int:
        return (1 << (self.nbits - 1)) - 1

    @property
    def minpos_pattern(self) -> int:
        return 1

    @property
    def nar_pattern(self) -> int:
        """NaR sign-extended into int32 (e.g. p32: -2^31, p16: -2^15)."""
        return -(1 << (self.nbits - 1))

    @property
    def max_frac_bits(self) -> int:
        """fs for the shortest regime (|k| minimal): nbits - 3 - es."""
        return self.nbits - 3 - self.es

    @property
    def maxpos(self) -> float:
        return float(2.0 ** self.max_scale)

    @property
    def minpos(self) -> float:
        return float(2.0 ** (-self.max_scale))

    @property
    def eps_at_1(self) -> float:
        """Rounding ulp at x=1 (the paper's golden-zone machine epsilon)."""
        return float(2.0 ** (-self.max_frac_bits))

    @property
    def storage_dtype(self):
        return np.int32

    @property
    def wire_dtype(self):
        """Narrowest integer dtype that round-trips the pattern on the wire
        (used by posit-compressed collectives)."""
        if self.nbits <= 8:
            return np.int8
        if self.nbits <= 16:
            return np.int16
        return np.int32


P32E2 = PositFormat(32, 2)
P16E1 = PositFormat(16, 1)
P8E2 = PositFormat(8, 2)
P8E0 = PositFormat(8, 0)

FORMATS: dict[str, PositFormat] = {
    f.name: f for f in (P32E2, P16E1, P8E2, P8E0)}


def get_format(name: str) -> PositFormat:
    try:
        return FORMATS[name]
    except KeyError:
        raise KeyError(f"unknown posit format {name!r}; known: {sorted(FORMATS)}")
