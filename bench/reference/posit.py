"""A frozen Posit(nbits, es) codec in plain PyTorch, for the benchmark.

The benchmark makes its input words and rounds its reference's values
with this copy, so that nothing it judges the program by can move when
the program's own codec changes.  Copied from the port's
``core/posit.py`` (decode, encode, the f64 conversions and the
value-domain rounding), held to the rational oracle of
``tests/posit_oracle.py`` by ``bench/test_bench_reference.py``.

Words are sign-extended int32; NaR is the most negative pattern and
decodes to NaN.  Values are exact in float64 for every posit of at most
32 bits.
"""
from __future__ import annotations

import dataclasses

import torch

_F = 27                       # working fraction width (p32e2's widest)
_I64 = torch.int64
_MASK63 = (1 << 63) - 1
_F64_MAN = (1 << 52) - 1


@dataclasses.dataclass(frozen=True)
class Fmt:
    nbits: int
    es: int

    @property
    def max_scale(self) -> int:
        return (self.nbits - 2) << self.es

    @property
    def maxpos_pattern(self) -> int:
        return (1 << (self.nbits - 1)) - 1

    @property
    def nar_pattern(self) -> int:
        return -(1 << (self.nbits - 1))


def fmt_of(name: str) -> Fmt:
    """``Fmt`` of a name such as ``p32e2``."""
    nbits, es = name.removeprefix("p").split("e")
    return Fmt(int(nbits), int(es))


def _pow2_bits(e: torch.Tensor) -> torch.Tensor:
    return (e + 1023) << 52


def _split_f64(x: torch.Tensor):
    """(scale, 52-bit mantissa, inf/NaN, zero or subnormal) of f64 bits."""
    bits = x.view(_I64)
    expf = (bits >> 52) & 0x7FF
    return expf - 1023, bits & _F64_MAN, expf == 0x7FF, expf == 0


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    e = ((x.to(torch.float64).view(_I64) >> 52) - 1023).clamp(0, 62)
    return e - ((1 << e) > x).to(_I64)


def to_float64(p: torch.Tensor, fmt: Fmt) -> torch.Tensor:
    """Posit words -> exact float64 values (NaR -> NaN)."""
    p = p.to(torch.int32)
    nbits, es = fmt.nbits, fmt.es
    is_zero = p == 0
    is_nar = p == fmt.nar_pattern
    sign = p < 0
    p64 = p.to(_I64)
    a = torch.where(sign, -p64, p64)
    body = (a << (64 - nbits)) & _MASK63
    r0 = (body >> 62) & 1
    y = torch.where(r0 == 1, (~body) & _MASK63, body)
    m = torch.where(y == 0, 62,
                    62 - _floor_log2(torch.where(y == 0, 1, y)))
    k = torch.where(r0 == 1, m - 1, -m)
    u = (body << (m + 1)) & _MASK63
    e = u >> (63 - es) if es else torch.zeros_like(u)
    f_al = (u << es) & _MASK63
    scale = k * (1 << es) + e
    frac = f_al >> (63 - _F)
    mag = (_pow2_bits(scale) | (frac << (52 - _F))).view(torch.float64)
    out = torch.where(sign, -mag, mag)
    out = torch.where(is_zero, 0.0, out)
    return torch.where(is_nar, float("nan"), out)


def from_float64(x: torch.Tensor, fmt: Fmt) -> torch.Tensor:
    """Float64 -> posit words, round to nearest even on the pattern,
    saturating at +-maxpos and +-minpos; inf/NaN -> NaR; f64 subnormals
    -> zero."""
    x = x.to(torch.float64)
    nbits, es = fmt.nbits, fmt.es
    scale, man, special, zero = _split_f64(x)
    width = _F + 1
    sig = (1 << width) | (man >> (52 - width))
    sticky = (man & ((1 << (52 - width)) - 1)) != 0
    over = scale > fmt.max_scale
    under = scale < -fmt.max_scale
    scale = scale.clamp(-fmt.max_scale, fmt.max_scale)
    k = scale >> es
    e = scale - k * (1 << es)
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    regime = torch.where(k >= 0, ((1 << (k.clamp(min=0) + 1)) - 1) << 1, 1)
    frac = sig & ((1 << width) - 1)
    length = reg_len + es + width
    pre = (length - 59).clamp(min=0)
    sticky = sticky | ((frac & ((1 << pre) - 1)) != 0)
    frac = frac >> pre
    body = ((((regime << es) | e) << (width - pre)) | frac) << 1
    shift = (length - pre) - (nbits - 1) + 1
    kept = body >> shift
    rem = body & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    rnd = (rem > half) | ((rem == half) & (sticky | ((kept & 1) == 1)))
    pat = (kept + rnd.to(_I64)).clamp(max=fmt.maxpos_pattern)
    pat = torch.where(over, fmt.maxpos_pattern, pat)
    pat = torch.where(under, 1, pat)
    out = torch.where(x < 0, -pat, pat)
    out = torch.where(zero & ~special, 0, out)
    return torch.where(special, fmt.nar_pattern, out).to(torch.int32)


def round_value(x: torch.Tensor, fmt: Fmt) -> torch.Tensor:
    """The nearest posit value to each f64 ``x``, kept in f64: equal to
    ``to_float64(from_float64(x))`` (NaN stays NaN)."""
    x = x.to(torch.float64)
    nbits, es = fmt.nbits, fmt.es
    scale, man, is_nan, is_zero = _split_f64(x)
    frac = man >> 24
    sticky = (man & ((1 << 24) - 1)) != 0
    k = scale >> es
    e = scale - k * (1 << es)
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    ef = (1 << (es + 28)) | (e << 28) | frac
    d = (29 + es + reg_len - nbits).clamp(1, es + 28)
    dropped = ef & ((1 << d) - 1)
    half = 1 << (d - 1)
    kept = ef >> d
    lsb = torch.where(d == es + 28, (k < 0).to(_I64), kept & 1)
    rnd = (dropped > half) | ((dropped == half) & (sticky | (lsb == 1)))
    q2 = (kept + rnd.to(_I64)) << d
    carry = q2 >> (es + 29)
    e2 = torch.where(carry == 1, 0, (q2 >> 28) & ((1 << es) - 1))
    frac2 = torch.where(carry == 1, 0, q2 & ((1 << 28) - 1))
    scale2 = (k + carry) * (1 << es) + e2
    mag = (_pow2_bits(scale2) | (frac2 << 24)).view(torch.float64)
    mag = torch.where(scale >= fmt.max_scale, 2.0 ** fmt.max_scale, mag)
    mag = torch.where(scale < -fmt.max_scale, 2.0 ** -fmt.max_scale, mag)
    out = torch.where(x < 0, -mag, mag)
    out = torch.where(is_zero, 0.0, out)
    return torch.where(is_nan, float("nan"), out)


def ulp(x: torch.Tensor, fmt: Fmt) -> torch.Tensor:
    """The spacing of posit values around each f64 ``x``: 2^(scale - fs),
    fs the fraction bits the pattern keeps at that scale (0 for 0)."""
    scale, _, _, zero = _split_f64(x.to(torch.float64))
    scale = scale.clamp(-fmt.max_scale, fmt.max_scale)
    k = scale >> fmt.es
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    fs = (fmt.nbits - 1 - reg_len - fmt.es).clamp(min=0)
    return torch.where(zero, 0.0, _pow2_bits(scale - fs).view(torch.float64))
