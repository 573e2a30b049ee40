"""Posit GEMM via an exact hi/lo f32 split: Hopper kernels + plain versions.

The counterpart of ``repro.kernels.posit_gemm`` (the Pallas TPU kernel).
Each posit word decodes exactly to an f32 pair ``x = hi + lo`` (hi: the top
24 significand bits, lo: the bottom 4), and ``A @ B`` is summed as
``Ah@Bh + (Ah@Bl + Al@Bh)`` with f32 accumulation over K chunks of ``bk``
columns; ``mode="split3_comp"`` adds a Knuth TwoSum error term per chunk.
``posit_gemm`` rounds ±accumulator to posit words in the kernel's epilogue.
The semantics, bounds and exactness domain are the reference's (see its
module docstring).

Two implementations of every function live here:

* the **CUDA kernels** (``csrc/``), launched by the public wrappers for
  CUDA tensors.  ``posit_gemm_f32`` and ``posit_gemm`` are two launches:
  ``decode_planes``, which decodes each word of A and B once into f32
  planes, then the tiled GEMM kernel on those planes (``csrc/posit_gemm.cu``).
  ``posit_gemm_f32_simple`` / ``posit_gemm_simple`` launch the first
  kernel (``csrc/posit_gemm_simple.cu``), kept as the yardstick whose bits
  the tiled kernel must give; no study calls them.  ``quant_gemm_f32``
  is a posit-quantized linear at few rows in one launch (the skinny
  kernel, ``csrc/posit_gemm_skinny.cu``): it encodes the f32 activations
  and reads the stored int16/int8 weight words itself, and gives the
  bits of the encode kernel, the pre-pass and the tiled kernel times the
  channel scales.  The decode and encode
  device functions also get elementwise kernels of their own
  (``csrc/posit_codec.cu``) so they can be checked exhaustively on the
  card;
* the **plain PyTorch versions** (``*_plain``), which the wrappers use for
  CPU tensors and only for them.  They mirror the device functions op for
  op (bit-identical to the reference's ``decode_split_f32`` /
  ``encode_posit_f32``), lay the planes out as the pre-pass does, and
  emulate the kernels' tile dataflow for the GEMM (bk-chunked hi/lo
  products with f32 accumulation, TwoSum for ``_comp``).  Their f32 sums
  are ordered by the library's matmul, so the GEMM is held to the
  reference's error bound, not to its bits.

The GEMM wrappers also take a batch: operands (B, M, K) and (B, K, N)
give (B, M, N), in one pre-pass and one GEMM launch on the card (the
reference ``vmap``s its Pallas call, which gives the TPU kernel a batch
grid axis); each matrix's output is the 2-D call's.  The simple kernel
takes 2-D operands only.

For a CUDA tensor a wrapper launches its kernel or raises; it never falls
back.  Each wrapper counts its kernel launches in ``<wrapper>.launches``.
Unlike the TPU kernel, no shape needs padding: the kernels mask ragged
edges (the pre-pass pads its planes with zeros), and the plain GEMM takes
a short last K chunk, which gives the same sums as the reference's
zero-padded one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.formats import P16E1, P32E2, PositFormat
from repro_torch.kernels import _build

FMT_IDS = {"p32e2": 0, "p16e1": 1, "p8e2": 2, "p8e0": 3}
KERNEL_BK = 16          # the kernel's K tile; bk must be a multiple of it
PLANE_ALIGN = 4         # floats: the planes' leading dimensions are 16 bytes
_NAN_BITS = 0x7FC00000

MODES = ("split3", "split3_comp")

# The rows up to which serving/quantize.py's quant_matmul takes the skinny
# kernel (quant_gemm_f32) instead of the encode kernel, the pre-pass and
# the tiled kernel.  Timed in turns at M = 1, 4, 16 and 64 on the serve
# shapes (PERF.md §6), the skinny kernel was the faster at every one, by
# 1.09x at (64, 896, 4864) where its four row groups each decode the
# words again; past 64 it is not measured.
SKINNY_M_MAX = 64


# --------------------------------------------------------------------------
# plain versions of the device functions (int32/f32 ops only)
# --------------------------------------------------------------------------

def _floor_log2_i32(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x > 0, int32, 5 fixed binary-search steps."""
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        big = t > 0
        x = torch.where(big, t, x)
        r = r + torch.where(big, s, 0).to(torch.int32)
    return r


def _pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """2.0**e as f32 via exponent-field construction; caller masks
    e < -126."""
    return ((e + 127).clamp(1, 254) << 23).to(torch.int32).view(torch.float32)


def decode_split_f32_plain(p: torch.Tensor, fmt: PositFormat = P32E2):
    """int32 posit words -> (hi, lo) f32 with hi + lo == value exactly for
    |value| >= 2^-99; zero -> (0, 0); NaR -> NaN in hi."""
    p = p.to(torch.int32)
    nbits, es = fmt.nbits, fmt.es
    is_zero = p == 0
    is_nar = p == fmt.nar_pattern
    signbit = p < 0
    a = torch.where(signbit, 0 - p, p)                   # 2's-complement abs
    body = a << (33 - nbits)                             # regime MSB at bit31
    r0 = body < 0
    y = torch.where(r0, ~body, body)
    y_safe = torch.where(y == 0, 1, y)
    m = 31 - _floor_log2_i32(y_safe)                     # regime run length
    k = torch.where(r0, m - 1, -m)
    u = (body << m) << 1                                 # strip regime+term
    e = ((u >> (32 - es)) & ((1 << es) - 1)) if es else torch.zeros_like(u)
    frac = u << es
    sig = (1 << 27) | ((frac >> 5) & ((1 << 27) - 1))    # 28-bit significand
    scale = k * (1 << es) + e

    sgn = torch.where(signbit, -1.0, 1.0).to(torch.float32)
    dead = is_zero | is_nar
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    ph = torch.where((scale - 23 >= -126) & ~dead, _pow2_f32(scale - 23), zero)
    plo = torch.where((scale - 27 >= -126) & ~dead, _pow2_f32(scale - 27),
                      zero)
    hi = (sig >> 4).to(torch.float32) * ph * sgn
    lo = (sig & 15).to(torch.float32) * plo * sgn
    nan = torch.tensor(_NAN_BITS, dtype=torch.int32,
                       device=p.device).view(torch.float32)
    return torch.where(is_nar, nan, hi), lo


def encode_posit_f32_plain(x: torch.Tensor,
                           fmt: PositFormat = P32E2) -> torch.Tensor:
    """f32 values -> int32 posit words (RNE, ties to the even *pattern*,
    clamped to maxpos/minpos, inf/NaN -> NaR), int32 ops only."""
    nbits, es = fmt.nbits, fmt.es
    ms = fmt.max_scale
    bits = x.to(torch.float32).view(torch.int32)
    sign = bits < 0
    expf = (bits >> 23) & 0xFF
    man = bits & 0x7FFFFF
    is_zero = (expf == 0) & (man == 0)
    is_nar = expf == 255
    scale = torch.where(expf == 0, -150, expf - 127).to(torch.int32)
    over = scale >= ms
    under = (scale < -ms) & ~is_zero
    sc = scale.clamp(-ms, ms - 1)

    k = sc >> es
    e = sc & ((1 << es) - 1)
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    avail = (nbits - 1) - reg_len
    # k < 0 lanes take the other branch; clamp keeps their shift defined.
    regime = torch.where(k >= 0, ((1 << (k.clamp(min=0) + 1)) - 1) << 1,
                         1).to(torch.int32)
    ef = (1 << (es + 23)) | (e << 23) | man              # [1|e|frac23]
    d = ((es + 23) - avail).clamp(min=0)
    shl = (avail - (es + 23)).clamp(min=0)
    kf = (ef >> d) - (1 << ((es + 23) - d))              # strip hidden bit
    pat0 = (regime << avail) | (kf << shl)
    dropped = ef & ((1 << d) - 1)
    half = (1 << d) >> 1
    rnd = (dropped > half) | ((dropped == half) & (dropped != 0)
                             & ((pat0 & 1) == 1))
    pat = pat0 + rnd.to(torch.int32)

    pat = torch.where(over, fmt.maxpos_pattern, pat)
    pat = torch.where(under, 1, pat)
    out = torch.where(sign, 0 - pat, pat)
    out = torch.where(is_zero, 0, out)
    return torch.where(is_nar, fmt.nar_pattern, out).to(torch.int32)


def _check_operands(a_p, b_p):
    if (a_p.dim() not in (2, 3) or b_p.dim() != a_p.dim()
            or a_p.shape[:-2] != b_p.shape[:-2]
            or a_p.shape[-1] != b_p.shape[-2]):
        raise ValueError(f"bad GEMM shapes {tuple(a_p.shape)} @ "
                         f"{tuple(b_p.shape)}")
    if a_p.dtype != torch.int32 or b_p.dtype != torch.int32:
        raise TypeError(f"posit words must be int32, got {a_p.dtype}, "
                        f"{b_p.dtype}")
    if a_p.device != b_p.device:
        raise ValueError(f"operands on {a_p.device} and {b_p.device}")


def _check_gemm_args(a_p, b_p, bk, mode):
    _check_operands(a_p, b_p)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    if bk <= 0 or bk % KERNEL_BK:
        raise ValueError(f"bk={bk} must be a positive multiple of "
                         f"{KERNEL_BK}")


def posit_gemm_f32_plain(a_p: torch.Tensor, b_p: torch.Tensor, *,
                         bk: int = 128, mode: str = "split3",
                         fmt: PositFormat = P32E2) -> torch.Tensor:
    """Plain version of the kernel's f32-accumulator GEMM: the tile
    dataflow (per bk chunk: hi/lo products, f32 sums, TwoSum for
    ``split3_comp``) with the chunk products done by ``torch.matmul``.  A
    batch runs its matrices in turn, so that each gets the 2-D call's
    sums (a batched matmul may order them otherwise)."""
    _check_gemm_args(a_p, b_p, bk, mode)
    if a_p.dim() == 3:
        return torch.stack([posit_gemm_f32_plain(a, b, bk=bk, mode=mode,
                                                 fmt=fmt)
                            for a, b in zip(a_p, b_p)])
    ah, al = decode_split_f32_plain(a_p, fmt)
    bh, bl = decode_split_f32_plain(b_p, fmt)
    m, k = a_p.shape
    n = b_p.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_p.device)
    err = torch.zeros_like(acc)
    for c0 in range(0, k, bk):
        ahc, alc = ah[:, c0:c0 + bk], al[:, c0:c0 + bk]
        bhc, blc = bh[c0:c0 + bk], bl[c0:c0 + bk]
        partial = ahc @ bhc + (ahc @ blc + alc @ bhc)
        if mode == "split3_comp":
            s = acc + partial
            bp = s - acc                                 # Knuth TwoSum
            err = err + ((acc - (s - bp)) + (partial - bp))
            acc = s
        else:
            acc = acc + partial
    return acc + err if mode == "split3_comp" else acc


def posit_gemm_plain(a_p: torch.Tensor, b_p: torch.Tensor, *, bk: int = 128,
                     mode: str = "split3", negate: bool = False,
                     fmt: PositFormat = P32E2) -> torch.Tensor:
    """Plain version of the fused-encode GEMM: encode(±f32 accumulator)."""
    acc = posit_gemm_f32_plain(a_p, b_p, bk=bk, mode=mode, fmt=fmt)
    return encode_posit_f32_plain(-acc if negate else acc, fmt)


class Planes(NamedTuple):
    """The decoded operands as the tiled GEMM kernel reads them: K-major
    f32 planes, K padded to ``KERNEL_BK`` rows and the leading dimension
    to ``PLANE_ALIGN`` floats, zeros beyond the operands, with the
    operands' batch axis in front.  The lo planes are None for formats of
    <= 16 bits (they would be all zero)."""
    a_hi: torch.Tensor                  # ([B,] k_pad, lda): A transposed
    a_lo: torch.Tensor | None
    b_hi: torch.Tensor                  # ([B,] k_pad, ldb)
    b_lo: torch.Tensor | None


def plane_layout(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(k_pad, lda, ldb) of the planes of an (m, k) @ (k, n) product."""
    def up(x, q):
        return -(-x // q) * q
    return up(k, KERNEL_BK), up(m, PLANE_ALIGN), up(n, PLANE_ALIGN)


def decode_planes_plain(a_p: torch.Tensor, b_p: torch.Tensor,
                        fmt: PositFormat = P32E2) -> Planes:
    """Plain version of the decode pre-pass: ``decode_split_f32_plain`` of
    A (transposed) and B, laid out as ``Planes``."""
    _check_operands(a_p, b_p)
    m, k = a_p.shape[-2:]
    k_pad, lda, ldb = plane_layout(m, k, b_p.shape[-1])

    def plane(x, ld):
        out = x.new_zeros((*x.shape[:-2], k_pad, ld))
        out[..., :x.shape[-2], :x.shape[-1]] = x
        return out
    ah, al = decode_split_f32_plain(a_p, fmt)
    bh, bl = decode_split_f32_plain(b_p, fmt)
    lo = fmt.nbits > 16
    return Planes(plane(ah.mT, lda), plane(al.mT, lda) if lo else None,
                  plane(bh, ldb), plane(bl, ldb) if lo else None)


def channel_scales(sexp: torch.Tensor) -> torch.Tensor:
    """2^sexp as f32 from its exponent bits: exact for every integer
    exponent in [-126, 127] (the quantizer's scales and their inverses)."""
    return ((sexp.to(torch.int32) + 127) << 23).view(torch.float32)


def _check_quant_args(x, words, sexp, fmt, bk):
    if fmt.nbits > 16:
        raise ValueError(f"quant_gemm_f32 takes formats of <= 16 bits, got "
                         f"{fmt.name}: its words have a lo part, and "
                         "posit_gemm_f32 (the tiled kernel) takes them")
    want = torch.int16 if fmt.nbits > 8 else torch.int8
    if x.dtype != torch.float32 or words.dtype != want \
            or sexp.dtype != torch.int8:
        raise TypeError(f"quant_gemm_f32 takes f32 activations, {want} "
                        f"{fmt.name} words and int8 exponents, got "
                        f"{x.dtype}, {words.dtype}, {sexp.dtype}")
    if (x.dim() != 2 or words.dim() != 2 or sexp.shape != words.shape[1:]
            or x.shape[1] != words.shape[0]):
        raise ValueError(f"bad quantized GEMM shapes {tuple(x.shape)} @ "
                         f"{tuple(words.shape)}, scales {tuple(sexp.shape)}")
    if not x.device == words.device == sexp.device:
        raise ValueError(f"operands on {x.device}, {words.device} and "
                         f"{sexp.device}")
    if bk <= 0 or bk % KERNEL_BK:
        raise ValueError(f"bk={bk} must be a positive multiple of "
                         f"{KERNEL_BK}")


def quant_gemm_f32_plain(x: torch.Tensor, words: torch.Tensor,
                         sexp: torch.Tensor, fmt: PositFormat, *,
                         bk: int = 32) -> torch.Tensor:
    """Plain version of the skinny kernel: ``encode_posit_f32_plain`` of
    the activations, the words widened to int32, ``posit_gemm_f32_plain``
    (split3) and the channel scales, one f32 multiply."""
    _check_quant_args(x, words, sexp, fmt, bk)
    y = posit_gemm_f32_plain(encode_posit_f32_plain(x, fmt),
                             words.to(torch.int32), bk=bk, mode="split3",
                             fmt=fmt)
    return y * channel_scales(sexp)


# --------------------------------------------------------------------------
# wrappers: kernel for CUDA tensors, plain version for CPU tensors
# --------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc}")


def _rows_unit_stride(t: torch.Tensor) -> torch.Tensor:
    """Row-major with unit column stride (any leading dimension), as the
    simple kernel reads it; copies only when the layout is otherwise."""
    if t.stride(1) == 1 and t.stride(0) >= max(t.shape[1], 1):
        return t
    return t.contiguous()


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _batch_strides(t: torch.Tensor):
    """(batch, batch stride, row stride, column stride) of a 2-D or 3-D
    operand."""
    if t.dim() == 2:
        return (1, 0, *t.stride())
    return (t.shape[0], *t.stride())


def decode_planes(a_p: torch.Tensor, b_p: torch.Tensor,
                  fmt: PositFormat = P32E2) -> Planes:
    """The GEMM's decode pre-pass: A and B ([B,] any strides) ->
    ``Planes``.

    CUDA tensors: one launch decodes both operands of every matrix; CPU
    tensors: the plain version."""
    _check_operands(a_p, b_p)
    if not a_p.is_cuda:
        return decode_planes_plain(a_p, b_p, fmt)
    m, k = a_p.shape[-2:]
    n = b_p.shape[-1]
    k_pad, lda, ldb = plane_layout(m, k, n)
    lo = fmt.nbits > 16

    def plane(ld):
        return torch.empty((*a_p.shape[:-2], k_pad, ld), dtype=torch.float32,
                           device=a_p.device)
    planes = Planes(plane(lda), plane(lda) if lo else None, plane(ldb),
                    plane(ldb) if lo else None)
    batch, saz, sa0, sa1 = _batch_strides(a_p)
    _, sbz, sb0, sb1 = _batch_strides(b_p)
    if k == 0 or lda + ldb == 0 or batch == 0:
        return planes
    with torch.cuda.device(a_p.device):
        rc = _build.lib().posit_decode_planes_launch(
            a_p.data_ptr(), b_p.data_ptr(), batch, m, n, k, saz, sa0, sa1,
            sbz, sb0, sb1, *map(_ptr, planes), k_pad, lda, ldb,
            FMT_IDS[fmt.name], _stream(a_p))
    _raise_on(rc, "decode_planes")
    decode_planes.launches += 1
    return planes


def _gemm_out(a_p, b_p, emit_posit):
    """The output of a ([B,] m, k) @ ([B,] k, n) launch; zeros (posit zero
    words) when K is empty, where no kernel runs."""
    shape = (*a_p.shape[:-1], b_p.shape[-1])
    dtype = torch.int32 if emit_posit else torch.float32
    if a_p.shape[-1] == 0:
        return torch.zeros(shape, device=a_p.device, dtype=dtype)
    return torch.empty(shape, device=a_p.device, dtype=dtype)


def _launch_gemm(a_p, b_p, *, bk, mode, emit_posit, negate, fmt):
    out = _gemm_out(a_p, b_p, emit_posit)
    if out.numel() == 0 or a_p.shape[-1] == 0:
        return out
    planes = decode_planes(a_p, b_p, fmt)
    (m, k), n = a_p.shape[-2:], b_p.shape[-1]
    batch = a_p.shape[0] if a_p.dim() == 3 else 1
    with torch.cuda.device(a_p.device):
        rc = _build.lib().posit_gemm_launch(
            *map(_ptr, planes), out.data_ptr(), batch, m, n, k,
            *plane_layout(m, k, n), m * n, n, FMT_IDS[fmt.name],
            int(mode == "split3_comp"), int(emit_posit), int(negate), bk,
            _stream(a_p))
    _raise_on(rc, "posit_gemm")
    (posit_gemm if emit_posit else posit_gemm_f32).launches += 1
    return out


def _launch_simple(a_p, b_p, *, bk, mode, emit_posit, negate, fmt):
    if a_p.dim() != 2:
        raise ValueError("the simple kernel takes 2-D operands, got "
                         f"{tuple(a_p.shape)}")
    out = _gemm_out(a_p, b_p, emit_posit)
    if out.numel() == 0 or a_p.shape[1] == 0:
        return out
    a = _rows_unit_stride(a_p)
    b = _rows_unit_stride(b_p)
    (m, k), n = a.shape, b.shape[1]
    with torch.cuda.device(a.device):
        rc = _build.lib().posit_gemm_simple_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            a.stride(0), b.stride(0), n, FMT_IDS[fmt.name],
            int(mode == "split3_comp"), int(emit_posit), int(negate), bk,
            _stream(a))
    _raise_on(rc, "posit_gemm_simple")
    (posit_gemm_simple if emit_posit else posit_gemm_f32_simple).launches += 1
    return out


def posit_gemm_f32(a_p: torch.Tensor, b_p: torch.Tensor, *, bk: int = 128,
                   mode: str = "split3",
                   fmt: PositFormat = P32E2) -> torch.Tensor:
    """([B,] M,K) @ ([B,] K,N) over int32 posit words -> f32 accumulator.

    CUDA tensors: the decode pre-pass and the tiled Hopper kernel (one
    launch each, for the whole batch); CPU tensors: the plain version.
    ``bk`` is the accumulation chunk (a multiple of 16)."""
    _check_gemm_args(a_p, b_p, bk, mode)
    if not a_p.is_cuda:
        return posit_gemm_f32_plain(a_p, b_p, bk=bk, mode=mode, fmt=fmt)
    return _launch_gemm(a_p, b_p, bk=bk, mode=mode, emit_posit=False,
                        negate=False, fmt=fmt)


def posit_gemm(a_p: torch.Tensor, b_p: torch.Tensor, *, bk: int = 128,
               mode: str = "split3", negate: bool = False,
               fmt: PositFormat = P32E2) -> torch.Tensor:
    """([B,] M,K) @ ([B,] K,N) posit words -> posit words, encode fused
    in-kernel (``negate`` flips the sign exactly first: the BLAS alpha=-1
    form).
    Bit-identical to ``encode_posit_f32(±posit_gemm_f32(...))``."""
    _check_gemm_args(a_p, b_p, bk, mode)
    if not a_p.is_cuda:
        return posit_gemm_plain(a_p, b_p, bk=bk, mode=mode, negate=negate,
                                fmt=fmt)
    return _launch_gemm(a_p, b_p, bk=bk, mode=mode, emit_posit=True,
                        negate=negate, fmt=fmt)


def posit_gemm_f32_simple(a_p: torch.Tensor, b_p: torch.Tensor, *,
                          bk: int = 128, mode: str = "split3",
                          fmt: PositFormat = P32E2) -> torch.Tensor:
    """``posit_gemm_f32`` on the first kernel (one launch, decoding in
    every block): the yardstick of the tiled kernel's bits and time."""
    _check_gemm_args(a_p, b_p, bk, mode)
    if not a_p.is_cuda:
        return posit_gemm_f32_plain(a_p, b_p, bk=bk, mode=mode, fmt=fmt)
    return _launch_simple(a_p, b_p, bk=bk, mode=mode, emit_posit=False,
                          negate=False, fmt=fmt)


def posit_gemm_simple(a_p: torch.Tensor, b_p: torch.Tensor, *, bk: int = 128,
                      mode: str = "split3", negate: bool = False,
                      fmt: PositFormat = P32E2) -> torch.Tensor:
    """``posit_gemm`` on the first kernel (the yardstick)."""
    _check_gemm_args(a_p, b_p, bk, mode)
    if not a_p.is_cuda:
        return posit_gemm_plain(a_p, b_p, bk=bk, mode=mode, negate=negate,
                                fmt=fmt)
    return _launch_simple(a_p, b_p, bk=bk, mode=mode, emit_posit=True,
                          negate=negate, fmt=fmt)


def quant_gemm_f32(x: torch.Tensor, words: torch.Tensor, sexp: torch.Tensor,
                   fmt: PositFormat, *, bk: int = 32) -> torch.Tensor:
    """A posit-quantized linear, y = (encode(x) @ words) * 2^sexp: x (M, K)
    f32, words (K, N) the stored words (int16 for p16e1, int8 for p8e2 and
    p8e0), sexp (N,) int8, K summed in chunks of ``bk`` (a multiple of 16).

    CUDA tensors: one launch of the skinny kernel, bit-identical for every
    M to ``posit_gemm_f32(encode_posit_f32(x), words.to(int32), bk=bk,
    mode="split3") * channel_scales(sexp)`` on the card; CPU tensors: the
    plain version.  Formats of more than 16 bits (p32e2, whose words have
    a lo part) are not taken: they keep the tiled kernel."""
    _check_quant_args(x, words, sexp, fmt, bk)
    if not x.is_cuda:
        return quant_gemm_f32_plain(x, words, sexp, fmt, bk=bk)
    (m, k), n = x.shape, words.shape[1]
    if k == 0:
        return torch.zeros((m, n), device=x.device) * channel_scales(sexp)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    xc, wc, sc = x.contiguous(), words.contiguous(), sexp.contiguous()
    with torch.cuda.device(x.device):
        rc = _build.lib().posit_gemm_skinny_launch(
            xc.data_ptr(), wc.data_ptr(), sc.data_ptr(), out.data_ptr(), m,
            n, k, FMT_IDS[fmt.name], bk, _stream(xc))
    _raise_on(rc, "quant_gemm_f32")
    quant_gemm_f32.launches += 1
    return out


def decode_split_f32(p: torch.Tensor, fmt: PositFormat = P32E2):
    """Posit words -> (hi, lo) f32; the elementwise kernel of the GEMM's
    decode device function for CUDA tensors, the plain version on CPU."""
    if p.dtype != torch.int32:
        raise TypeError(f"posit words must be int32, got {p.dtype}")
    if not p.is_cuda:
        return decode_split_f32_plain(p, fmt)
    src = p.contiguous()
    hi = torch.empty(src.shape, dtype=torch.float32, device=p.device)
    lo = torch.empty_like(hi)
    if src.numel() == 0:
        return hi, lo
    with torch.cuda.device(p.device):
        rc = _build.lib().posit_decode_split_launch(
            src.data_ptr(), hi.data_ptr(), lo.data_ptr(), src.numel(),
            FMT_IDS[fmt.name], _stream(src))
    _raise_on(rc, "decode_split")
    decode_split_f32.launches += 1
    return hi, lo


def encode_posit_f32(x: torch.Tensor, fmt: PositFormat = P32E2):
    """f32 -> posit words; the elementwise kernel of the GEMM's encode
    device function for CUDA tensors, the plain version on CPU."""
    if x.dtype != torch.float32:
        raise TypeError(f"encode_posit_f32 takes float32, got {x.dtype}")
    if not x.is_cuda:
        return encode_posit_f32_plain(x, fmt)
    src = x.contiguous()
    out = torch.empty(src.shape, dtype=torch.int32, device=x.device)
    if src.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _build.lib().posit_encode_launch(
            src.data_ptr(), out.data_ptr(), src.numel(), FMT_IDS[fmt.name],
            _stream(src))
    _raise_on(rc, "encode_posit")
    encode_posit_f32.launches += 1
    return out


def encode_p32_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> Posit(32,2) words."""
    return encode_posit_f32(x, P32E2)


def encode_p16_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> Posit(16,1) words."""
    return encode_posit_f32(x, P16E1)


KERNEL_WRAPPERS = (posit_gemm_f32, posit_gemm, decode_planes,
                   decode_split_f32, encode_posit_f32, posit_gemm_f32_simple,
                   posit_gemm_simple, quant_gemm_f32)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
