"""Quire — the posit standard's exact fixed-point fused accumulator
(counterpart of ``repro.quire.quire``).

The quire for Posit(n, es) spans [minpos^2, maxpos^2] with n - 2
carry-guard bits: ``4 * max_scale + nbits`` bits (512 for p32e2, 128 for
p16e1).  The value is

    value = sum_j limbs[..., j] * 2^(32*j + QLSB),   QLSB = -2*max_scale

with ``L`` radix-2^32 limbs (16 for p32e2, 4 for p16e1 and p8e2, 1 for
p8e0) held in int64 in redundant (lazy-carry) form: every deposit adds
< 2^32 to a limb, and carries are propagated only when the quire is
rounded (``q_to_posit``) or renormalized (``q_renorm``).  NaR is a
per-element flag; exact cancellation gives the zero word.  Every op is
integer arithmetic, so the words are the reference's bit for bit, on the
CPU and on a GPU alike.

What differs from the reference, and why:

* A deposit is a ``scatter_add`` of a product's three 32-bit chunks into
  its limbs, where the reference adds one-hot masks over all L limbs.
  Chunks whose limb index falls outside [0, L) (below quire bit 0, where
  every legal product has zero bits, or one past the top) are zeroed and
  their index clamped, which is the reference's drop; zero and NaR lanes
  deposit zero.  Integer adds commute, so the limbs are the same.
* ``quire_dot`` chunks K to bound memory (``_DOT_ELEMS`` products a
  step by default) rather than at the reference's 128 columns; every
  chunking gives the same words.
* Entry points that build a quire from nothing (``quire_zero``) take
  ``device="cuda"`` by default; the others run where their inputs are.
* ``to_limbs32`` reinterprets the low words as int32 with integer
  arithmetic (``lo - 2^32`` where ``lo >= 2^31``): torch has no uint32 ->
  int32 bitcast on int64 values.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import _device
from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat

_I64 = torch.int64
_M32 = (1 << 32) - 1
# Decoded significands live in [2^F, 2^(F+1)) (posit core working width).
_F = 27
# quire_dot's default step: at most this many products materialized at
# once (a few hundred MB of int64 temporaries); schedule only.
_DOT_ELEMS = 1 << 24


def quire_limbs(fmt: PositFormat) -> int:
    """Number of 32-bit limbs: (4*max_scale + nbits) / 32, padded up."""
    bits = 4 * fmt.max_scale + fmt.nbits
    return -(-bits // 32)


def quire_lsb_exp(fmt: PositFormat) -> int:
    """Power-of-two weight of quire bit 0 (= minpos^2's exponent)."""
    return -2 * fmt.max_scale


@dataclasses.dataclass
class Quire:
    """Batched quire state: ``limbs`` (..., L) int64 redundant radix-2^32
    limbs, ``nar`` (...) bool poison flag."""
    limbs: torch.Tensor
    nar: torch.Tensor

    @property
    def shape(self):
        return self.limbs.shape[:-1]


def quire_zero(shape=(), fmt: PositFormat = P32E2, device="cuda") -> Quire:
    dev = _device.resolve(device)
    return Quire(limbs=torch.zeros(tuple(shape) + (quire_limbs(fmt),),
                                   dtype=_I64, device=dev),
                 nar=torch.zeros(tuple(shape), dtype=torch.bool, device=dev))


# --------------------------------------------------------------------------
# depositing a signed significand at a scale (the one shared primitive)
# --------------------------------------------------------------------------

def _decode_half(p, fmt: PositFormat):
    """One operand's deposit ingredients: (sig, scale, sgn, nar) with sgn
    in {-1, 0, +1} (0 for zero/NaR dead lanes)."""
    z, n, s, c, f = posit.decode(p, fmt)
    sgn = torch.where(z | n, 0, torch.where(s, -1, 1)).to(_I64)
    return f, c, sgn, n


def _prod_idx0(ca, cb, fmt: PositFormat):
    """Quire bit index of a significand product's LSB: the product value
    is (fa*fb) * 2^(ca+cb-2F), and quire bit 0 weighs 2^QLSB."""
    return ca + cb - 2 * _F - quire_lsb_exp(fmt)


def _chunks3(mag, idx0):
    """Split ``mag`` (int64, < 2^57) shifted left by ``idx0`` quire-bit
    positions into three 32-bit chunks and their base limb index; chunk j
    lands at limb base + j.  idx0 may be negative (the dropped chunks of
    a legal product are zero)."""
    t = idx0 + 64
    off = t & 31
    base = (t >> 5) - 2
    p0 = mag & _M32
    p1 = mag >> 32                      # < 2^25
    c0 = (p0 << off) & _M32
    c1 = ((p0 >> (32 - off)) | (p1 << off)) & _M32
    c2 = (p1 >> (32 - off)) & _M32
    return c0, c1, c2, base


def _deposit_terms(mag, idx0, sgn, n_limbs: int):
    """(index, source) of ``sgn * (mag << idx0)`` as three limb adds each,
    shape (..., 3): out-of-range chunks zeroed, their index clamped."""
    c0, c1, c2, base = _chunks3(mag, idx0)
    idx = torch.stack([base, base + 1, base + 2], dim=-1)
    src = torch.stack([c0, c1, c2], dim=-1) * sgn[..., None]
    src = torch.where((idx >= 0) & (idx < n_limbs), src, 0)
    return idx.clamp(0, n_limbs - 1), src


def _deposit(limbs, mag, idx0, sgn):
    """limbs (..., L) + sgn * (mag << idx0), every operand broadcast to
    the quire's shape."""
    shape = torch.broadcast_shapes(limbs.shape[:-1], mag.shape, idx0.shape,
                                   sgn.shape)
    n_limbs = limbs.shape[-1]
    idx, src = _deposit_terms(mag.expand(shape), idx0.expand(shape),
                              sgn.expand(shape), n_limbs)
    return limbs.expand(shape + (n_limbs,)).scatter_add(-1, idx, src)


def _signs(sgn, negate):
    """sgn, negated where ``negate`` (a bool or a bool tensor) holds."""
    if isinstance(negate, bool):
        return -sgn if negate else sgn
    return torch.where(torch.as_tensor(negate, device=sgn.device), -sgn, sgn)


# --------------------------------------------------------------------------
# accumulate ops
# --------------------------------------------------------------------------

def qma(q: Quire, a, b, fmt: PositFormat = P32E2, negate=False) -> Quire:
    """Fused multiply-accumulate: q += (-1)^negate * a * b, exactly.  a, b
    posit words broadcastable to q.shape; ``negate`` a bool or a bool
    tensor (per-element negation)."""
    fa, ca, sga, na = _decode_half(a, fmt)
    fb, cb, sgb, nb = _decode_half(b, fmt)
    sgn = _signs(sga * sgb, negate)
    limbs = _deposit(q.limbs, fa * fb, _prod_idx0(ca, cb, fmt), sgn)
    return Quire(limbs=limbs, nar=q.nar | na | nb)


def qadd_posit(q: Quire, p, fmt: PositFormat = P32E2, negate=False) -> Quire:
    """q += (-1)^negate * p, exactly (every posit is quire-representable)."""
    f, c, sgn, n = _decode_half(p, fmt)
    idx0 = c - _F - quire_lsb_exp(fmt)
    limbs = _deposit(q.limbs, f, idx0, _signs(sgn, negate))
    return Quire(limbs=limbs, nar=q.nar | n)


def quire_from_posit(p, fmt: PositFormat = P32E2) -> Quire:
    p = torch.as_tensor(p).to(torch.int32)
    return qadd_posit(quire_zero(p.shape, fmt, p.device), p, fmt)


def qneg(q: Quire) -> Quire:
    """Exact negation (redundant limbs are signed, so this is elementwise)."""
    return Quire(limbs=-q.limbs, nar=q.nar)


# --------------------------------------------------------------------------
# carry propagation and rounding
# --------------------------------------------------------------------------

def _propagate(limbs):
    """Redundant signed limbs -> canonical (low, final_carry): low[j] in
    [0, 2^32), value = sum low[j]*2^(32j) + carry*2^(32L).  Fixed L steps;
    ``>>`` on int64 is arithmetic (signed) on the CPU and on CUDA."""
    carry = torch.zeros(limbs.shape[:-1], dtype=_I64, device=limbs.device)
    lows = []
    for limb in limbs.unbind(dim=-1):
        v = limb + carry
        lows.append(v & _M32)
        carry = v >> 32
    return torch.stack(lows, dim=-1), carry


def q_renorm(q: Quire) -> Quire:
    """Propagate carries back into canonical two's-complement limbs,
    restoring full 2^31-accumulation headroom (for streaming use)."""
    low, carry = _propagate(q.limbs)
    # fold the sign carry into the top limb (in-range quires keep carry
    # in {0, -1})
    low[..., -1] += carry << 32
    return Quire(limbs=low, nar=q.nar)


def q_to_posit(q: Quire, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Round the exact quire value to the nearest posit (RNE), the single
    rounding of a fused op chain.  Fixed loops over L, no host sync."""
    low, carry = _propagate(q.limbs)
    neg = carry < 0

    # magnitude limbs: two's-complement negate when negative.  The +1
    # carries into limb j exactly when every limb below it is zero.
    nz = low != 0
    carry_in = (torch.cumsum(nz, dim=-1) - nz.to(_I64)) == 0
    negated = (((~low) & _M32) + carry_in.to(_I64)) & _M32
    mag = torch.where(neg[..., None], negated, low)

    nz = mag != 0
    is_zero = ~nz.any(dim=-1)
    jj = torch.arange(low.shape[-1], dtype=_I64, device=low.device)
    safe = torch.where(nz, mag, 1)
    msb = torch.where(nz, 32 * jj + posit.floor_log2(safe),
                      -1).amax(dim=-1)

    # top 31 bits (width F+G = 30 significand + 1) from msb down, plus
    # sticky from everything below
    hi = msb >> 5
    sh = msb & 31

    def pick(idx):
        return torch.where(jj == idx[..., None], mag, 0).sum(dim=-1)

    g0 = pick(hi)
    g1 = pick(hi - 1)
    r = 30 - sh                                          # bits from g1
    rpos = r.clamp(min=0)
    # sh <= 31 so r >= -1; r == -1 means the top limb alone holds 32 bits
    sig = torch.where(r >= 0, (g0 << rpos) | (g1 >> (32 - rpos)), g0 >> 1)
    st_top = torch.where(r >= 0, g1 & ((1 << (32 - rpos)) - 1),
                         (g0 & 1) | (g1 != 0).to(_I64))
    below = (torch.where(jj < (hi - 1)[..., None], mag, 0) != 0).any(dim=-1)
    sticky = (st_top != 0) | below

    scale = msb + quire_lsb_exp(fmt)
    safe_sig = torch.where(is_zero, 1 << 30, sig)
    return posit.encode(neg, scale, safe_sig, sticky, is_zero, q.nar, fmt,
                        width=30)


# --------------------------------------------------------------------------
# fused reductions
# --------------------------------------------------------------------------

def _dot_limbs(half_a, half_b, fmt: PositFormat, negate, kc: int):
    """Exact limb-space sum of (-1)^negate * a[..., k] * b[..., k] over
    the last axis, from the operands' ``_decode_half`` fields, depositing
    ``kc`` products of each row a step.  Returns (limbs, nar)."""
    fa, ca, sga, na = half_a
    fb, cb, sgb, nb = half_b
    prod = fa * fb
    idx0 = _prod_idx0(ca, cb, fmt)
    sgn = _signs(sga * sgb, negate)
    n_limbs = quire_limbs(fmt)
    lead = prod.shape[:-1]
    limbs = torch.zeros(lead + (n_limbs,), dtype=_I64, device=prod.device)
    for k0 in range(0, prod.shape[-1], kc):
        sl = slice(k0, k0 + kc)
        idx, src = _deposit_terms(prod[..., sl], idx0[..., sl], sgn[..., sl],
                                  n_limbs)
        limbs.scatter_add_(-1, idx.reshape(lead + (-1,)),
                           src.reshape(lead + (-1,)))
    return limbs, (na | nb).any(dim=-1)


def quire_dot(a_p, b_p, fmt: PositFormat = P32E2, init_p=None, negate=False,
              kc: int | None = None) -> torch.Tensor:
    """Exact fused dot product over the LAST axis, one posit rounding:

        out = round( init + (-1)^negate * sum_k a[..., k] * b[..., k] )

    a_p/b_p broadcastable posit words; ``init_p`` optional posit words of
    the reduced shape (added exactly).  ``kc`` bounds the products
    deposited per step (schedule only: every chunking is bit-identical);
    None takes all of K when the batch holds at most ``_DOT_ELEMS``
    products, else chunks of that many.
    """
    a_p, b_p = torch.broadcast_tensors(torch.as_tensor(a_p).to(torch.int32),
                                       torch.as_tensor(b_p).to(torch.int32))
    k = a_p.shape[-1]
    if kc is None:
        rows = a_p.numel() // max(k, 1)
        kc = max(1, _DOT_ELEMS // max(rows, 1))
    kc = max(1, min(int(kc), k))
    limbs, nar = _dot_limbs(_decode_half(a_p, fmt), _decode_half(b_p, fmt),
                            fmt, negate, kc)
    q = Quire(limbs=limbs, nar=nar)
    if init_p is not None:
        init = torch.as_tensor(init_p).to(torch.int32)
        q = qadd_posit(q, init.expand(q.shape), fmt)
    return q_to_posit(q, fmt)


def fdp(a_p, b_p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """The posit standard's fused dot product of two 1-D posit vectors."""
    return quire_dot(a_p, b_p, fmt)


# --------------------------------------------------------------------------
# 32-bit limb planes (the reference's Pallas-facing layout)
# --------------------------------------------------------------------------

def to_limbs32(q: Quire):
    """(..., L) int64 redundant limbs -> ((..., L, 2) int32 (lo, hi)
    planes, nar): lo holds each limb's low 32 bits as a raw pattern, hi
    its signed high word."""
    lo = q.limbs & _M32
    lo = lo - (lo >= (1 << 31)).to(_I64) * (1 << 32)     # uint32 -> int32
    hi = q.limbs >> 32
    return torch.stack([lo, hi], dim=-1).to(torch.int32), q.nar


def from_limbs32(planes, nar) -> Quire:
    """Inverse of ``to_limbs32``."""
    planes = torch.as_tensor(planes)
    lo = planes[..., 0].to(_I64) & _M32
    hi = planes[..., 1].to(_I64)
    return Quire(limbs=(hi << 32) | lo,
                 nar=torch.as_tensor(nar, device=planes.device).to(
                     torch.bool))
