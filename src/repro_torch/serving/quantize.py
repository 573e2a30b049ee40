"""Posit weight quantization for LLM inference, weights-only PTQ
(counterpart of ``repro.serving.quantize``).

Model weights are stored as posit words in the format's wire dtype
(int16 for p16e1, int8 for p8e2: 2x / 4x less memory than f32) with a
per-output-channel power-of-two equilibration: each channel is divided
by 2^floor(log2(max|w|)), which puts its magnitudes in [1, 2), the top
of every format's golden zone, and the scale is folded back into the
matmul output exactly (power-of-two scaling is exact in f32).

A quantized leaf ``{"qw", "sexp", "qmeta", "axes"}`` replaces the f32
``{"w", "axes"}`` leaf inside the ordinary param tree, and
``models.common.leaf``/``linear``/``embed`` detect it, so the quantized
``forward_prefill``/``serve_step`` run through every family with no
per-family code.  ``qmeta`` = (format name, backend).  Two backends,
under the reference's names:

* ``backend="xla"`` — decode the words to f32 and run the baseline
  ``torch.matmul`` (weights-only semantics: activations untouched).
* ``backend="pallas"`` — in the port this is the **Hopper posit GEMM
  kernel**: the activations are encoded to the same format and both word
  operands go to ``kernels.posit_gemm.posit_gemm_f32`` (split3, f32
  accumulation over K chunks of 32, as the reference's block); on a CUDA
  tensor that is the decode pre-pass and the tiled kernel, on a CPU
  tensor its plain version.  Full-posit semantics: activations round to
  the lattice too.  The activation encode is ``encode_posit_f32``, the
  GEMM epilogue's encode as an elementwise kernel: the reference's
  ``from_float32_bits`` rounding, bit for bit (both are correctly
  rounded; tests/test_torch_serving.py holds them equal), in one launch
  where ``from_float32_bits`` is ~90 eager ops.  A kernel that fails to
  build or launch raises; nothing falls back.

Decoding a word array of a <= 16-bit format is a lookup in the format's
table of values (``to_float32_bits`` of every pattern), which gives the
decode's values exactly; it is what makes the per-step decode of the
tied embedding table affordable at a full vocabulary.

The scales 2^e are built from their exponent bits, exact for every e in
[-126, 126].  The reference takes ``jnp.exp2``, which XLA on the CPU
evaluates exactly only for small |e| (measured: every e in [-12, 28]
under jit; exp2(-126) gives 0 eagerly).  The words and values are the
reference's wherever its scale is exact, which covers every channel of
the models here; a channel holding an infinite weight (e = 126) is
where they part.

NaR / saturation: ``from_float32_bits`` maps NaN/Inf weights to NaR and
saturates at +-maxpos; ``quantize_params`` refuses NaR unless
``allow_nar=True``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import posit
from repro_torch.core.formats import get_format
from repro_torch.core.policy import wire_dtype
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import posit_gemm as _pg
from repro_torch.models.common import Axes, is_param, is_qleaf


class QMeta(tuple):
    """(format name, backend) of a quantized leaf (the reference's
    ``QMeta``, a pytree node without leaves there)."""


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How to quantize: storage format, equilibration, matmul backend."""
    fmt: str = "p16e1"
    per_channel: bool = True      # pow2 equilibration per output channel
    backend: str = "xla"          # "xla" decoded matmul | "pallas" kernel
    min_ndim: int = 2             # only quantize leaves with ndim >= this


_ENCODE_CHUNK = 1 << 22     # elements encoded at a time by quantize_leaf
_BK = 32                    # the reference's K accumulation chunk


def _pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """2.0**e as f32 from its exponent field, exact for -126 <= e <= 127."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def channel_scale_exp(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel power-of-two exponent e (int8) with max|w| / 2^e
    in [1, 2), reduced over axis -2 (the contraction axis) only, so a
    stacked leaf gets a scale per layer and channel.  All-zero channels
    get e = 0; the exponent is clipped to [-126, 126]."""
    w = w.to(torch.float32)
    mx = torch.where(torch.isnan(w), 0.0, w).abs().amax(dim=-2)
    safe = torch.where(mx > 0, mx, torch.ones_like(mx))
    _, ex = torch.frexp(safe)                    # safe = m 2^ex, m in [.5, 1)
    e = torch.where(torch.isinf(safe), 126, ex - 1)
    return e.clamp(-126, 126).to(torch.int8)


def quantize_leaf(pl: dict, qc: QuantConfig) -> dict:
    """f32 param leaf {"w", "axes"} -> quantized leaf
    {"qw" (wire words), "sexp" (int8 pow2 exponents), "qmeta", "axes"}."""
    fmt = get_format(qc.fmt)
    w = pl["w"].to(torch.float32)
    if qc.per_channel:
        sexp = channel_scale_exp(w)
    else:
        sexp = torch.zeros(w.shape[:-2] + (w.shape[-1],), dtype=torch.int8,
                           device=w.device)
    scaled = (w * _pow2_f32(-sexp.to(torch.int32))[..., None, :]).reshape(-1)
    # the encode is elementwise: in chunks, so that its int64 temporaries
    # stay small beside a full vocabulary's table
    words = torch.empty(scaled.shape, dtype=wire_dtype(fmt), device=w.device)
    for i in range(0, scaled.numel(), _ENCODE_CHUNK):
        words[i:i + _ENCODE_CHUNK] = posit.from_float32_bits(
            scaled[i:i + _ENCODE_CHUNK], fmt)
    return {"qw": words.reshape(w.shape), "sexp": sexp,
            "qmeta": QMeta((qc.fmt, qc.backend)),
            "axes": pl.get("axes", Axes((None,) * w.dim()))}


@functools.lru_cache(maxsize=16)
def _value_table(fmt_name: str, device: str) -> torch.Tensor:
    """The f32 value of every pattern of a <= 16-bit format, indexed by
    the pattern plus 2^(nbits-1)."""
    fmt = get_format(fmt_name)
    half = 1 << (fmt.nbits - 1)
    pats = torch.arange(-half, half, dtype=torch.int32,
                        device=torch.device(device))
    return posit.to_float32_bits(pats, fmt)


def decode_words(words: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Posit words (any integer dtype, sign-extended) -> f32 values,
    equal to ``posit.to_float32_bits``: a table lookup for formats of
    <= 16 bits."""
    fmt = get_format(fmt_name)
    if fmt.nbits > 16:
        return posit.to_float32_bits(words.to(torch.int32), fmt)
    table = _value_table(fmt_name, str(words.device))
    return table[words.to(torch.int32) + (1 << (fmt.nbits - 1))]


def _scales(ql: dict) -> torch.Tensor:
    return _pow2_f32(ql["sexp"].to(torch.int32))


def dequant_leaf(ql: dict, dtype=torch.float32) -> torch.Tensor:
    """decode(words) * 2^sexp: the exact inverse of the encode's rounding
    (pow2 scaling is exact in f32)."""
    fmt_name, _ = ql["qmeta"]
    w = decode_words(ql["qw"], fmt_name)
    return (w * _scales(ql)[..., None, :]).to(dtype)


def dequant_rows(ql: dict, ids: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """``dequant_leaf(ql)[ids]`` for a 2-D leaf, decoding only the rows
    gathered."""
    fmt_name, _ = ql["qmeta"]
    w = decode_words(ql["qw"][ids], fmt_name)
    return (w * _scales(ql)).to(dtype)


# Param-leaf parent keys that are matmul/conv WEIGHTS (consumed along
# their -2 contraction axis).  Stacked 1-D leaves look 2-D in the
# reference's layout, so the name, not ndim alone, is the contract.
QUANT_LEAF_KEYS = frozenset(
    {"w", "table", "conv_w", "w_gate", "w_up", "w_down"})


def _default_predicate(pl, qc: QuantConfig, name: str) -> bool:
    return name in QUANT_LEAF_KEYS and pl["w"].dim() >= qc.min_ndim


def quantize_params(params, qc: QuantConfig | None = None, *,
                    predicate=None, allow_nar: bool = False):
    """Quantize every matching param leaf of a model tree (matmul
    weights, embedding tables and conv kernels by default, see
    ``QUANT_LEAF_KEYS``; biases and norms stay f32).
    ``predicate(leaf, qc, name)`` overrides.  Raises on NaR words
    (NaN/Inf weights) unless ``allow_nar``."""
    qc = qc or QuantConfig()
    pred = predicate or _default_predicate
    fmt = get_format(qc.fmt)
    nar_leaves: list[str] = []

    def visit(tree, path, name):
        if is_param(tree):
            if not pred(tree, qc, name):
                return tree
            ql = quantize_leaf(tree, qc)
            if bool(posit.is_nar(ql["qw"].to(torch.int32), fmt).any()):
                nar_leaves.append(path)
            return ql
        if isinstance(tree, dict):
            return {k: visit(v, f"{path}/{k}", k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(visit(v, f"{path}/{i}", name)
                              for i, v in enumerate(tree))
        return tree

    out = visit(params, "", "")
    if nar_leaves and not allow_nar:
        raise ValueError(
            f"NaR posit words (NaN/Inf weights) in {nar_leaves}; clean the "
            "checkpoint or pass allow_nar=True")
    return out


def dequantize_params(params, dtype=torch.float32):
    """Inverse of ``quantize_params`` (up to the one encode rounding)."""
    def visit(tree):
        if is_qleaf(tree):
            return {"w": dequant_leaf(tree, dtype), "axes": tree["axes"]}
        if isinstance(tree, dict):
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(visit(v) for v in tree)
        return tree
    return visit(params)


# --------------------------------------------------------------------------
# matmul over quantized leaves
# --------------------------------------------------------------------------

def quant_matmul(x: torch.Tensor, ql: dict,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(ql), the per-channel pow2 scale folded into the
    output (exact: 2^e distributes over the f32 sum).

    ``backend="xla"``: decode the words to f32 and run the baseline
    matmul.  ``backend="pallas"``: encode x to the same format and run
    the posit GEMM kernel on the two word operands (the stored narrow
    words widened to int32, sign-extended), ``bk=32`` as the
    reference's accumulation chunk; the GEMM is called through
    ``kernels.ops``, where ``rgemm`` reaches it too."""
    fmt_name, backend = ql["qmeta"]
    fmt = get_format(fmt_name)
    words = ql["qw"]
    scale = _scales(ql)
    lead = x.shape[:-1]
    d_in, d_out = words.shape[-2], words.shape[-1]

    if backend == "pallas":
        x2 = x.reshape(-1, d_in).to(torch.float32)
        xw = _pg.encode_posit_f32(x2, fmt)
        y = _ops.posit_gemm_f32(xw, words.to(torch.int32), bk=_BK,
                                mode="split3", fmt=fmt)
        y = y * scale
        return y.reshape(lead + (d_out,)).to(compute_dtype)
    if backend != "xla":
        raise ValueError(f"unknown quant_matmul backend {backend!r}")

    w = decode_words(words, fmt_name)
    y = torch.matmul(x.to(compute_dtype).float(), w.to(compute_dtype).float())
    return (y * scale).to(compute_dtype)


# --------------------------------------------------------------------------
# storage accounting
# --------------------------------------------------------------------------

def param_bytes(params) -> dict:
    """{"bytes": stored bytes, "f32_bytes": the f32-equivalent bytes,
    "word_bytes": posit word bytes only, "scale_bytes": sexp overhead,
    "q_f32_bytes": f32-equivalent of the quantized leaves alone (so
    q_f32_bytes / word_bytes is exactly the wire-width ratio)}."""
    tot = {"bytes": 0, "f32_bytes": 0, "word_bytes": 0, "scale_bytes": 0,
           "q_f32_bytes": 0}

    def visit(tree):
        if is_qleaf(tree):
            n = tree["qw"].numel()
            wb = n * tree["qw"].element_size()
            sb = tree["sexp"].numel()
            tot["word_bytes"] += wb
            tot["scale_bytes"] += sb
            tot["bytes"] += wb + sb
            tot["f32_bytes"] += n * 4
            tot["q_f32_bytes"] += n * 4
            return
        if is_param(tree):
            nb = tree["w"].numel() * 4
            tot["bytes"] += nb
            tot["f32_bytes"] += nb
            return
        if isinstance(tree, dict):
            for v in tree.values():
                visit(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                visit(v)

    visit(params)
    return tot


def golden_zone_fraction_fn(fmt_name: str):
    """Golden-zone occupancy of a word array in format ``fmt_name``, as a
    function of the words (the reference's jitted form)."""
    return functools.partial(_golden_zone_fraction, fmt_name=fmt_name)


def _golden_zone_fraction(words: torch.Tensor, fmt_name: str) -> float:
    """The share of finite nonzero words whose regime k is 0 or -1."""
    fmt = get_format(fmt_name)
    is_zero, is_nar, _, scale, _ = posit.decode(
        words.to(torch.int32).reshape(-1), fmt)
    finite = ~(is_zero | is_nar)
    k = scale >> fmt.es
    golden = finite & (k >= -1) & (k <= 0)
    nfin = max(int(finite.sum()), 1)
    return int(golden.sum()) / nfin


def weight_golden_zone(params) -> float:
    """Mean golden-zone occupancy over all quantized leaves, weighted by
    element count."""
    occ, n = 0.0, 0

    def visit(tree):
        nonlocal occ, n
        if is_qleaf(tree):
            fmt_name, _ = tree["qmeta"]
            sz = tree["qw"].numel()
            occ += golden_zone_fraction_fn(fmt_name)(tree["qw"]) * sz
            n += sz
            return
        if isinstance(tree, dict):
            for v in tree.values():
                visit(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                visit(v)

    visit(params)
    return occ / max(n, 1)
