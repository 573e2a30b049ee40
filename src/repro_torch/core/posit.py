"""Branch-free, vectorized Posit(n, es) codec and fast arithmetic in PyTorch.

The counterpart of ``repro.core.posit``: the same function names, the same
field-space dataflow, bit-identical words and values (pinned against the
JAX package and the rational oracle in ``tests/test_torch_posit.py``).
Every function runs on the device of its input tensors.

What differs from the reference, and why:

* Powers of two are built by exponent-field construction (int64 bits
  viewed as float64) instead of ``ldexp``, and float64 inputs are split
  into (exponent, mantissa) from their bits instead of ``frexp``.  Both
  are exact in the normal range every posit value lies in, so the codec
  gives the same bits on the CPU and on a GPU, whatever the library's
  ``ldexp``/``frexp`` do there.
* Every op is a separate eager PyTorch op, so each one rounds on its own:
  the fast backend and the chain ops depend on that (no FMA, no fused
  ``addcmul``).
* Only the reference's ``fast`` backend is here.  The int64 ``exact``
  backend, ``pconvert`` and ``rounding_eps`` are not ported yet (ROADMAP
  A1); asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import P32E2, PositFormat

# Working significand layout: 1.f normalized to [2^F, 2^{F+1}) (as in the
# reference); F holds the widest posit fraction (27 bits for p32e2).
_F = 27
_I64 = torch.int64
_MASK63 = (1 << 63) - 1
_F64_MAN = (1 << 52) - 1


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(_I64)


def _pow2_bits_f64(e: torch.Tensor) -> torch.Tensor:
    """Float64 bit pattern of 2.0**e (int64), exact for -1022 <= e <= 1023;
    callers override lanes outside that range."""
    return (e + 1023) << 52


def _exp_mantissa_f64(x: torch.Tensor):
    """(scale, man52, is_special, is_zero) of float64 ``x`` from its bits:
    ``x = 1.man52 * 2^scale`` for normal x, which is the reference's
    ``frexp`` split (scale = ex - 1).  The special (inf/NaN) and zero
    lanes are overridden by the callers.  Subnormal inputs count as zero:
    XLA, which runs the reference, treats f64 subnormals as zero
    (denormals-are-zero), so the reference maps them to the zero word and
    the port does the same."""
    bits = x.view(_I64)
    expf = (bits >> 52) & 0x7FF
    man = bits & _F64_MAN
    return expf - 1023, man, expf == 0x7FF, expf == 0


# --------------------------------------------------------------------------
# bit utilities (fixed-depth, vectorized)
# --------------------------------------------------------------------------

def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x > 0 (int64), 6 fixed binary-search steps."""
    x = _i64(x)
    r = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        t = x >> s
        big = t > 0
        x = torch.where(big, t, x)
        r = r + torch.where(big, s, 0)
    return r


# --------------------------------------------------------------------------
# decode / encode
# --------------------------------------------------------------------------

def decode(p: torch.Tensor, fmt: PositFormat = P32E2):
    """Sign-extended int32 patterns -> (is_zero, is_nar, sign, scale, sig)
    with sig in [2^F, 2^{F+1}), exact for every posit <= 32 bits."""
    p = torch.as_tensor(p).to(torch.int32)
    nbits, es = fmt.nbits, fmt.es
    is_zero = p == 0
    is_nar = p == fmt.nar_pattern
    sign = p < 0
    p64 = p.to(_I64)
    a = torch.where(sign, -p64, p64)

    # Pattern body (bits nbits-2 .. 0) with its MSB at bit 62.
    body = (a << (64 - nbits)) & _MASK63
    r0 = (body >> 62) & 1
    y = torch.where(r0 == 1, (~body) & _MASK63, body)
    safe_y = torch.where(y == 0, 1, y)
    m = torch.where(y == 0, 62, 62 - floor_log2(safe_y))
    k = torch.where(r0 == 1, m - 1, -m)

    u = (body << (m + 1)) & _MASK63
    if es > 0:
        e = u >> (63 - es)
        f_al = (u << es) & _MASK63
    else:
        e = torch.zeros_like(u)
        f_al = u
    scale = k * (1 << es) + e
    sig = (1 << _F) | (f_al >> (63 - _F))
    return is_zero, is_nar, sign, scale, sig


def encode(sign, scale, sig, sticky, is_zero, is_nar,
           fmt: PositFormat = P32E2, width: int = _F) -> torch.Tensor:
    """Round-to-nearest-even encode of (-1)^sign * sig * 2^(scale - width),
    sig in [2^width, 2^{width+1}), ``sticky`` = dropped bits nonzero.
    Saturates at +-maxpos and never rounds a nonzero value to zero."""
    nbits, es = fmt.nbits, fmt.es
    scale = _i64(scale)
    sig = _i64(sig)
    sticky = torch.as_tensor(sticky, dtype=torch.bool, device=sig.device)

    over = scale > fmt.max_scale
    under = scale < -fmt.max_scale
    scale_c = scale.clamp(-fmt.max_scale, fmt.max_scale)

    k = scale_c >> es
    e = scale_c - k * (1 << es)
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    # k < 0 lanes take the other branch; clamp keeps their shift defined.
    regime_val = torch.where(
        k >= 0, ((1 << (k.clamp(min=0) + 1)) - 1) << 1, 1)

    frac = sig & ((1 << width) - 1)
    L = reg_len + es + width
    pre = (L - 59).clamp(min=0)
    sticky = sticky | ((frac & ((1 << pre) - 1)) != 0)
    frac = frac >> pre
    w2 = width - pre
    body = ((((regime_val << es) | e) << w2) | frac) << 1
    shift = (L - pre) - (nbits - 1) + 1
    kept = body >> shift
    rem = body & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    rnd = (rem > half) | ((rem == half) & (sticky | ((kept & 1) == 1)))
    pat = kept + rnd.to(_I64)

    pat = pat.clamp(max=fmt.maxpos_pattern)
    pat = torch.where(over, fmt.maxpos_pattern, pat)
    pat = torch.where(under, fmt.minpos_pattern, pat)
    out = torch.where(torch.as_tensor(sign, device=pat.device), -pat, pat)
    out = torch.where(torch.as_tensor(is_zero, device=pat.device), 0, out)
    out = torch.where(torch.as_tensor(is_nar, device=pat.device),
                      fmt.nar_pattern, out)
    return out.to(torch.int32)


def is_nar(p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Elementwise NaR predicate on sign-extended posit words (one word
    compare, no decode)."""
    return torch.as_tensor(p).to(torch.int32) == fmt.nar_pattern


# --------------------------------------------------------------------------
# conversions (exact / correctly rounded)
# --------------------------------------------------------------------------

def to_float64(p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Posit words -> exact float64 values (NaR -> NaN, zero -> +0.0)."""
    is_zero, is_nar_, sign, scale, sig = decode(p, fmt)
    # sig * 2^(scale - F) == 1.frac * 2^scale: built from its bits.
    bits = _pow2_bits_f64(scale) | ((sig - (1 << _F)) << (52 - _F))
    mag = bits.view(torch.float64)
    out = torch.where(sign, -mag, mag)
    out = torch.where(is_zero, 0.0, out)
    return torch.where(is_nar_, float("nan"), out)


def from_float64(x, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Float64 -> posit words, correctly rounded (inf/NaN -> NaR)."""
    x = torch.as_tensor(x).to(torch.float64)
    scale, man, is_special, is_zero = _exp_mantissa_f64(x)
    sign = x < 0
    # 28-bit significand (one bit wider than the widest fraction, as in
    # the reference) plus a sticky bit for the dropped mantissa bits.
    sig = (1 << (_F + 1)) | (man >> (52 - _F - 1))
    sticky = (man & ((1 << (52 - _F - 1)) - 1)) != 0
    return encode(sign, scale, sig, sticky, is_zero & ~is_special,
                  is_special, fmt, width=_F + 1)


def from_float32_bits(x, fmt: PositFormat = P32E2) -> torch.Tensor:
    """f32 -> posit via int32 bit extraction, correctly rounded."""
    x = torch.as_tensor(x).to(torch.float32)
    bits = x.view(torch.int32)
    sign = bits < 0
    exp_f = (bits >> 23) & 0xFF
    man = bits & 0x7FFFFF
    is_zero = (exp_f == 0) & (man == 0)
    is_nar_ = exp_f == 255
    scale = torch.where(exp_f == 0, -150, exp_f - 127)
    sig = (((1 << 23) | man).to(_I64)) << (_F + 1 - 23)
    return encode(sign, scale, sig, False, is_zero, is_nar_, fmt,
                  width=_F + 1)


def to_float32_bits(p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """posit -> f32, exact for <= 24-bit significands, else RNE.  Every
    registered format's values lie in f32's normal range, so rounding
    the exact f64 value once equals the reference's f32 ``ldexp``."""
    return to_float64(p, fmt).to(torch.float32)


# --------------------------------------------------------------------------
# fast backend (f64 emulation) + public dispatch
# --------------------------------------------------------------------------

def _fast_binop(op):
    def f(a, b, fmt: PositFormat = P32E2):
        return from_float64(op(to_float64(a, fmt), to_float64(b, fmt)), fmt)
    return f


_FAST = {
    "add": _fast_binop(torch.add),
    "sub": _fast_binop(torch.sub),
    "mul": _fast_binop(torch.mul),
    "div": _fast_binop(torch.div),
    "sqrt": lambda a, fmt=P32E2: from_float64(torch.sqrt(to_float64(a, fmt)),
                                              fmt),
}


def _dispatch(name, backend):
    if backend == "exact":
        raise NotImplementedError(
            "the int64 'exact' posit backend is not ported yet (ROADMAP A1); "
            "use backend='fast'")
    if backend != "fast":
        raise ValueError(f"unknown backend {backend!r}")
    return _FAST[name]


def add(a, b, fmt: PositFormat = P32E2, backend: str = "exact"):
    return _dispatch("add", backend)(a, b, fmt)


def sub(a, b, fmt: PositFormat = P32E2, backend: str = "exact"):
    return _dispatch("sub", backend)(a, b, fmt)


def mul(a, b, fmt: PositFormat = P32E2, backend: str = "exact"):
    return _dispatch("mul", backend)(a, b, fmt)


def div(a, b, fmt: PositFormat = P32E2, backend: str = "exact"):
    return _dispatch("div", backend)(a, b, fmt)


def sqrt(a, fmt: PositFormat = P32E2, backend: str = "exact"):
    return _dispatch("sqrt", backend)(a, fmt)


# --------------------------------------------------------------------------
# fused_chain helpers — decode once, round every op in f64, encode once
# --------------------------------------------------------------------------

def chain_decode(p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Posit words -> exact f64 values (decode once, at chain entry)."""
    return to_float64(p, fmt)


def chain_encode(x, fmt: PositFormat = P32E2) -> torch.Tensor:
    """f64 chain values -> posit words (encode once, at chain exit)."""
    return from_float64(x, fmt)


def chain_round(x, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Round f64 values to the nearest posit *value* (RNE on the pattern
    boundary, saturating, NaN -> NaN), staying in f64; bit-identical to
    ``to_float64(from_float64(x))`` and to the reference's
    ``chain_round`` (see its docstring for the fringe tie rule)."""
    x = torch.as_tensor(x).to(torch.float64)
    nbits, es = fmt.nbits, fmt.es
    scale, man, is_nan, is_zero = _exp_mantissa_f64(x)
    sign = x < 0
    frac = man >> 24                                    # top 28 fraction bits
    sticky = (man & ((1 << 24) - 1)) != 0

    k = scale >> es
    e = scale - k * (1 << es)
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    ef = (1 << (es + 28)) | (e << 28) | frac            # [1|e|frac28]
    d = (29 + es + reg_len - nbits).clamp(1, es + 28)
    dropped = ef & ((1 << d) - 1)
    half = 1 << (d - 1)
    kept = ef >> d
    pat_lsb = torch.where(d == es + 28, (k < 0).to(_I64), kept & 1)
    rnd = (dropped > half) | ((dropped == half) & (sticky | (pat_lsb == 1)))

    q2 = (kept + rnd.to(_I64)) << d                     # back at [1|e|frac]
    carry = q2 >> (es + 29)                             # regime carry
    k2 = k + carry
    e2 = torch.where(carry == 1, 0, (q2 >> 28) & ((1 << es) - 1))
    frac2 = torch.where(carry == 1, 0, q2 & ((1 << 28) - 1))
    scale2 = k2 * (1 << es) + e2
    mag = (_pow2_bits_f64(scale2) | (frac2 << 24)).view(torch.float64)

    over = scale >= fmt.max_scale
    under = scale < -fmt.max_scale
    mag = torch.where(over, 2.0 ** fmt.max_scale, mag)
    mag = torch.where(under, 2.0 ** (-fmt.max_scale), mag)
    out = torch.where(sign, -mag, mag)
    out = torch.where(is_zero, 0.0, out)
    return torch.where(is_nan, float("nan"), out)


def chain_add(a, b, fmt: PositFormat = P32E2):
    return chain_round(a + b, fmt)


def chain_sub(a, b, fmt: PositFormat = P32E2):
    return chain_round(a - b, fmt)


def chain_mul(a, b, fmt: PositFormat = P32E2):
    return chain_round(a * b, fmt)


def chain_div(a, b, fmt: PositFormat = P32E2):
    return chain_round(a / b, fmt)


def chain_sqrt(a, fmt: PositFormat = P32E2):
    return chain_round(torch.sqrt(a), fmt)
