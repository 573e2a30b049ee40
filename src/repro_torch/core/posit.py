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
* Both backends are here: ``exact`` (int64 significand arithmetic, the
  default, as in the reference) and ``fast`` (f64 emulation).  The
  exact backend's integer divide is ``torch.div(..., rounding_mode=
  "floor")`` on positive int64, never a true division, and every shift
  count stays below 64.
* ``from_float32`` and ``rounding_eps`` read f32/f64 subnormals as zero,
  as XLA on the CPU does for the reference (denormals-are-zero), and
  ``rounding_eps`` takes inf/NaN as the reference's ``frexp`` does
  (exponent 0).
* The reference's ``jitted`` (a cache of jit-compiled op handles) has no
  counterpart: PyTorch runs eagerly, so the ops are called directly.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import P32E2, PositFormat

# Working significand layout: 1.f normalized to [2^F, 2^{F+1}) (as in the
# reference); F holds the widest posit fraction (27 bits for p32e2).
_F = 27
# Guard bits appended for alignment/rounding inside add/div/sqrt.
_G = 3
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
    """floor(log2(x)) for 0 < x < 2^63 (int64): the exponent of x's
    nearest f64, less one where rounding carried x up to the next power
    of two.  Exact, and a few elementwise ops where the reference's
    binary search takes 30: every decode and every quire rounding calls
    it, and on a GPU each op is a launch."""
    x = _i64(x)
    e = ((x.to(torch.float64).view(_I64) >> 52) - 1023).clamp(0, 62)
    return e - ((1 << e) > x).to(_I64)


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


def to_float32(p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """posit -> f32 by the reference's f64 route, which for the registered
    formats (all f32-normal) is ``to_float32_bits``."""
    return to_float32_bits(p, fmt)


def from_float32(x, fmt: PositFormat = P32E2) -> torch.Tensor:
    """f32 -> posit words through the exact f64 value.  f32 subnormals
    read as zero, as the reference's f32 -> f64 conversion on XLA's CPU
    (denormals-are-zero) gives."""
    x = torch.as_tensor(x).to(torch.float32)
    sub = ((x.view(torch.int32) >> 23) & 0xFF) == 0
    return from_float64(torch.where(sub, 0.0, x.to(torch.float64)), fmt)


def pconvert(p, src: PositFormat, dst: PositFormat) -> torch.Tensor:
    """Posit -> posit format conversion, correctly rounded: exact decode
    to f64, one round-to-nearest-even encode in ``dst`` (widening is
    exact).  NaR maps to NaR, zero to zero."""
    if src == dst:
        return torch.as_tensor(p).to(torch.int32)
    return from_float64(to_float64(p, src), dst)


# --------------------------------------------------------------------------
# arithmetic — exact backend (int64 significands)
# --------------------------------------------------------------------------

def _normalize(mag, sticky):
    """Normalize mag > 0 to [2^(F+G), 2^(F+G+1)) tracking sticky; returns
    (sig, sticky, msb) at width F+G.  mag == 0 is handled by the caller."""
    w = _F + _G
    msb = floor_log2(torch.where(mag == 0, 1, mag))
    dl = w - msb                                        # left shift if > 0
    left = dl.clamp(min=0)
    right = (-dl).clamp(min=0)                          # a few bits at most
    lost = mag & ((1 << right) - 1)
    sig = torch.where(dl >= 0, mag << left, mag >> right)
    return sig, sticky | (lost != 0), msb


def _words(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def add_(a, b, fmt: PositFormat = P32E2):
    a, b = _words(a), _words(b)
    za, na, sa, ca, fa = decode(a, fmt)
    zb, nb, sb, cb, fb = decode(b, fmt)

    # order |a| >= |b|
    swap = (cb > ca) | ((cb == ca) & (fb > fa))
    sa_, sb_ = torch.where(swap, sb, sa), torch.where(swap, sa, sb)
    ca_, cb_ = torch.where(swap, cb, ca), torch.where(swap, ca, cb)
    fa_, fb_ = torch.where(swap, fb, fa), torch.where(swap, fa, fb)

    d = (ca_ - cb_).clamp(0, _F + _G + 2)
    big = fa_ << _G
    small = fb_ << _G
    lost = small & ((1 << d) - 1)
    jammed = (small >> d) | (lost != 0).to(_I64)        # sticky in bit 0
    mag = torch.where(sa_ != sb_, big - jammed, big + jammed)

    res_zero = mag == 0
    sig, sticky, msb = _normalize(mag, torch.zeros_like(res_zero))
    scale = ca_ + msb - (_F + _G)

    is_nar_ = na | nb
    is_zero = (za & zb) | (res_zero & ~is_nar_)        # exact cancel: +0
    sign = torch.where(za, sb_ & ~zb, sa_)
    out = encode(sign, scale, sig, sticky, is_zero, is_nar_, fmt,
                 width=_F + _G)
    out = torch.where(za & ~zb & ~is_nar_, b, out)
    return torch.where(zb & ~za & ~is_nar_, a, out)


def mul_(a, b, fmt: PositFormat = P32E2):
    za, na, sa, ca, fa = decode(a, fmt)
    zb, nb, sb, cb, fb = decode(b, fmt)
    prod = fa * fb                                      # < 2^56, exact
    ge2 = ((prod >> (2 * _F + 1)) > 0).to(_I64)
    shift = (_F - _G) + ge2                             # to F+G bits
    sig = prod >> shift
    sticky = (prod & ((1 << shift) - 1)) != 0
    is_nar_ = na | nb
    return encode(sa ^ sb, ca + cb + ge2, sig, sticky, (za | zb) & ~is_nar_,
                  is_nar_, fmt, width=_F + _G)


def div_(a, b, fmt: PositFormat = P32E2):
    za, na, sa, ca, fa = decode(a, fmt)
    zb, nb, sb, cb, fb = decode(b, fmt)
    num = fa << (_F + _G + 1)                         # <= 2^59
    q = torch.div(num, fb, rounding_mode="floor")       # positive int64
    r = num - q * fb
    # q in (2^(F+G), 2^(F+G+2)): normalize to [2^(F+G), 2^(F+G+1)).
    ge2 = (q >> (_F + _G + 1)) > 0
    scale = ca - cb - 1 + ge2.to(_I64)
    lost = torch.where(ge2, q & 1, 0)
    sig = torch.where(ge2, q >> 1, q)
    is_nar_ = na | nb | zb                              # x/0 = NaR
    return encode(sa ^ sb, scale, sig, (r != 0) | (lost != 0), za & ~is_nar_,
                  is_nar_, fmt, width=_F + _G)


def sqrt_(a, fmt: PositFormat = P32E2):
    za, na, sa, ca, fa = decode(a, fmt)
    is_nar_ = na | (sa & ~za)                           # sqrt(neg) = NaR
    half = ca >> 1                                      # floor(scale / 2)
    r = ca - (half << 1)                                # 0 or 1
    # a = X * 2^(2*half - F - 33) with X = fa << (r + 33) in [2^60, 2^62),
    # so sqrt(a) = isqrt(X) * 2^(half - 30).
    x = fa << (r + 33)
    s0 = torch.floor(torch.sqrt(x.to(torch.float64))).to(_I64)
    # the f64 estimate is within +-1 of isqrt(X); two rounds make it exact
    for _ in range(2):
        s0 = torch.where((s0 + 1) * (s0 + 1) <= x, s0 + 1, s0)
        s0 = torch.where(s0 * s0 > x, s0 - 1, s0)
    # s0 in [2^30, 2^31) == [2^(F+G), 2^(F+G+1)): already normalized
    return encode(torch.zeros_like(sa), half, s0, s0 * s0 != x, za, is_nar_,
                  fmt, width=_F + _G)


def neg_(a, fmt: PositFormat = P32E2) -> torch.Tensor:
    a = _words(a)
    return torch.where(a == fmt.nar_pattern, a, -a)


def abs_(a, fmt: PositFormat = P32E2) -> torch.Tensor:
    a = _words(a)
    return torch.where(a == fmt.nar_pattern, a, a.abs())


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


_EXACT = {
    "add": add_,
    "sub": lambda a, b, fmt=P32E2: add_(a, neg_(b, fmt), fmt),
    "mul": mul_,
    "div": div_,
    "sqrt": sqrt_,
}


def _dispatch(name, backend):
    table = {"exact": _EXACT, "fast": _FAST}.get(backend)
    if table is None:
        raise ValueError(f"unknown backend {backend!r}")
    return table[name]


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


# --------------------------------------------------------------------------
# epsilon model (paper §2: golden zone)
# --------------------------------------------------------------------------

def rounding_eps(x, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Relative rounding ulp of |x| in this format (the paper's
    epsilon_posit).  The exponent comes from the bits; zero and f64
    subnormals give 0, inf/NaN the reference's ``frexp`` exponent 0."""
    x = torch.as_tensor(x).to(torch.float64)
    scale, _, special, zero = _exp_mantissa_f64(x)
    scale = torch.where(special, -1, scale)
    k = scale >> fmt.es
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    fs = (fmt.nbits - 1 - reg_len - fmt.es).clamp(min=0)
    eps = _pow2_bits_f64(-fs).view(torch.float64)
    return torch.where(zero, 0.0, eps)
