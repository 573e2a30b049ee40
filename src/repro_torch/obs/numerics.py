"""positscope numerics: posit-value telemetry computed from posit words
with integer tensor ops (counterpart of ``repro.obs.numerics``).

Posit(nbits, es) keeps its maximal fraction width only while the regime
field is shortest, i.e. for regime exponent k in {0, -1}: |x| in
[2^-(2^es), 2^(2^es)), the **golden zone** ([1/16, 16) for p32e2 and p8e2,
[1/4, 4) for p16e1).  These collectors measure that occupancy, the
regime-width and scale histograms, rounding/sticky events on the encode
path and quire limb-carry counts: the evidence behind
``error_eval.golden_zone_study``.

Two call shapes, as in the reference:

* ``step_stats`` / ``collect_numerics`` / ``encode_round_stats`` /
  ``quire_carry_stats`` return tensors on the device of their input;
* the ``record_*`` helpers push them into the open ``obs.scoped()``
  collectors, and are no-ops with none open.

``active(*tensors)`` is the reference's gate: a collector is open and the
inputs hold values.  The reference's inputs are tracers whenever the call
is being traced into an outer jitted program, and its hooks then record
nothing; the port runs eagerly, so its instrumented bodies call
un-hooked internals at exactly those places instead (kernels/ops.py,
lapack/decomp.py).  The library's hooks test ``metrics.enabled()`` before
they call anything here, so with no collector open no function of this
module runs.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.obs import metrics as _metrics

_I64 = torch.int64


def is_concrete(*tensors) -> bool:
    """True iff none of ``tensors`` is a tensor without values (the meta
    device).  Eager PyTorch tensors always hold their values."""
    return not any(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   for t in tensors)


def active(*tensors) -> bool:
    """The instrumentation gate: a collector is open AND the inputs are
    concrete."""
    return bool(_metrics._STACK) and is_concrete(*tensors)


def golden_zone_bounds(fmt: PositFormat = P32E2) -> tuple[float, float]:
    """[lo, hi) magnitude band where ``fmt`` keeps its maximal fraction
    width (regime exponent k in {0, -1}): [2^-(2^es), 2^(2^es))."""
    return float(2.0 ** -(1 << fmt.es)), float(2.0 ** (1 << fmt.es))


def _fields(words, fmt: PositFormat):
    """(flat words, zero, nar, finite, scale, regime length) of posit
    words; the regime length is the stored run + terminator, clipped to
    [2, nbits - 1]."""
    p = torch.as_tensor(words).to(torch.int32).reshape(-1)
    is_zero, is_nar, _, scale, _ = posit.decode(p, fmt)
    finite = ~(is_zero | is_nar)
    k = scale >> fmt.es
    reg_len = torch.where(k >= 0, k + 2, 1 - k).clamp(2, fmt.nbits - 1)
    return p, is_zero, is_nar, finite, scale, reg_len


def _stats(p, is_zero, is_nar, finite, scale, reg_len, fmt):
    k = scale >> fmt.es
    golden = finite & (k >= -1) & (k <= 0)
    nfin = finite.to(_I64).sum().clamp(min=1)
    return {
        "n": torch.tensor(p.numel(), dtype=_I64, device=p.device),
        "zero": is_zero.to(_I64).sum(),
        "nar": is_nar.to(_I64).sum(),
        "golden_frac": golden.to(torch.float64).sum() / nfin,
        "regime_mean": (torch.where(finite, reg_len, 0)
                        .to(torch.float64).sum() / nfin),
    }


def step_stats(words, fmt: PositFormat = P32E2) -> dict:
    """Small per-stage summary (0-d tensors): golden-zone occupancy,
    mean regime width, zero/NaR counts — the payload of the observed
    factorizations' block steps.  ``golden_frac`` and ``regime_mean`` are
    f64 sums of integers over an integer count, exact as the reference's."""
    return _stats(*_fields(words, fmt), fmt)


def factor_step_stats(panel, update, fmt: PositFormat = P32E2) -> dict:
    """One block step's payload for ``emit_factor_steps``: ``step_stats``
    of the factored panel and, where the step has one, of the trailing
    update."""
    step = {"panel": step_stats(panel, fmt)}
    if update is not None:
        step["update"] = step_stats(update, fmt)
    return step


def collect_numerics(words, fmt: PositFormat = P32E2) -> dict:
    """Full posit-word telemetry of ``fmt`` words: ``step_stats`` plus

    * ``regime_hist[w]`` — finite words whose regime field is ``w`` bits
      wide (int32, length nbits);
    * ``scale_hist[scale + max_scale]`` — finite words per power-of-two
      scale (int32, length 2 * max_scale + 1).
    """
    fields = _fields(words, fmt)
    p, _, _, finite, scale, reg_len = fields
    one = finite.to(torch.int32)
    regime_hist = torch.zeros(fmt.nbits, dtype=torch.int32,
                              device=p.device).scatter_add_(
        0, torch.where(finite, reg_len, 0), one)
    off = (scale + fmt.max_scale).clamp(0, 2 * fmt.max_scale)
    scale_hist = torch.zeros(2 * fmt.max_scale + 1, dtype=torch.int32,
                             device=p.device).scatter_add_(
        0, torch.where(finite, off, 0), one)
    out = _stats(*fields, fmt)
    out["regime_hist"] = regime_hist
    out["scale_hist"] = scale_hist
    return out


def encode_round_stats(x, fmt: PositFormat = P32E2) -> dict:
    """Rounding-event / sticky-bit counters for encoding f64 values into
    ``fmt``, in ``posit.chain_round``'s field dataflow:

    * ``total``     — finite nonzero inputs
    * ``rounded``   — in-range inputs whose encode drops nonzero bits
    * ``sticky``    — in-range inputs with sticky bits below the kept +
                      guard field
    * ``saturated`` — inputs clamped to ±maxpos / ±minpos (f64
                      subnormals among them, as in the reference)
    """
    x = torch.as_tensor(x).to(torch.float64).reshape(-1)
    nbits, es = fmt.nbits, fmt.es
    is_nan = torch.isnan(x) | torch.isinf(x)
    is_zero = (x == 0.0) & ~is_nan
    tiny = ~is_nan & ~is_zero & (x.abs() < 2.0 ** -1022)
    mant, ex = torch.frexp(torch.where(is_nan | is_zero | tiny, 1.0,
                                       x).abs())
    scale = ex.to(_I64) - 1
    r = mant * float(1 << 29)
    q = torch.floor(r)
    sticky = r != q
    frac = q.to(_I64) & ((1 << 28) - 1)

    k = scale >> es
    e = scale - k * (1 << es)
    reg_len = torch.where(k >= 0, k + 2, 1 - k)
    ef = (1 << (es + 28)) | (e << 28) | frac
    d = (29 + es + reg_len - nbits).clamp(1, es + 28)
    dropped = ef & ((torch.ones_like(d) << d) - 1)

    over = scale >= fmt.max_scale
    under = (scale < -fmt.max_scale) | tiny
    finite = ~(is_nan | is_zero)
    in_range = finite & ~over & ~under
    rounded = in_range & ((dropped != 0) | sticky)
    return {
        "total": finite.to(_I64).sum(),
        "rounded": rounded.to(_I64).sum(),
        "sticky": (in_range & sticky).to(_I64).sum(),
        "saturated": (finite & (over | under)).to(_I64).sum(),
    }


def quire_carry_stats(limbs) -> dict:
    """Lazy-carry telemetry of a redundant radix-2^32 quire limb state
    ((..., L) int64): run the canonical propagation sweep and count the
    limb positions that release a nonzero carry.  Returns per-position
    counts (``per_limb``, (L,)) and their ``total``."""
    limbs = torch.as_tensor(limbs).to(_I64)
    carry = torch.zeros(limbs.shape[:-1], dtype=_I64, device=limbs.device)
    counts = []
    for limb in limbs.unbind(dim=-1):
        carry = (limb + carry) >> 32
        counts.append((carry != 0).to(_I64).sum())
    per_limb = torch.stack(counts)
    return {"per_limb": per_limb, "total": per_limb.sum()}


# --------------------------------------------------------------------------
# host-side recorders (no-ops unless a collector is open)
# --------------------------------------------------------------------------

def _hist_to_dict(hist, offset: int = 0) -> dict[int, int]:
    return {i + offset: v for i, v in enumerate(hist.tolist()) if v}


def record_numerics(name: str, words, fmt: PositFormat = P32E2):
    """Collect + record full word telemetry under ``name.*``; returns the
    stats dict (or None with no collector open)."""
    if not active(words):
        return None
    st = collect_numerics(words, fmt)
    _metrics.gauge(f"{name}.golden_zone", st["golden_frac"])
    _metrics.gauge(f"{name}.regime_mean", st["regime_mean"])
    _metrics.inc(f"{name}.words", st["n"])
    _metrics.inc(f"{name}.nar", st["nar"])
    _metrics.observe_hist(f"{name}.regime_width",
                          _hist_to_dict(st["regime_hist"]))
    _metrics.observe_hist(f"{name}.scale",
                          _hist_to_dict(st["scale_hist"], -fmt.max_scale))
    return st


def record_encode_stats(name: str, x, fmt: PositFormat = P32E2):
    """Record encode-path rounding counters for f64 values."""
    if not active(x):
        return None
    st = encode_round_stats(x, fmt)
    _metrics.inc(f"{name}.encodes", st["total"])
    _metrics.inc(f"{name}.rounded", st["rounded"])
    _metrics.inc(f"{name}.sticky", st["sticky"])
    _metrics.inc(f"{name}.saturated", st["saturated"])
    return st


def record_quire_carries(name: str, limbs):
    """Record quire limb-carry counts for a redundant limb state."""
    if not active(limbs):
        return None
    st = quire_carry_stats(limbs)
    _metrics.inc(f"{name}.limb_carries", st["total"])
    return st


def emit_factor_steps(name: str, tel) -> None:
    """Flush an observed factorization's telemetry list (one dict of
    ``step_stats`` payloads per block step, keyed by stage: "panel" /
    "update") into the open collectors as a ``name.step`` series plus the
    ``name.last_panel.golden_zone`` gauge and the ``name.calls`` counter."""
    if not _metrics._STACK:
        return
    for i, step in enumerate(tel):
        row = {"step": i}
        for stage, st in step.items():
            row[f"{stage}_golden"] = st["golden_frac"]
            row[f"{stage}_regime_mean"] = st["regime_mean"]
            row[f"{stage}_nar"] = st["nar"]
        _metrics.record(f"{name}.step", **row)
    if tel:
        _metrics.gauge(f"{name}.last_panel.golden_zone",
                       tel[-1]["panel"]["golden_frac"])
    _metrics.inc(f"{name}.calls")


def golden_zone_fraction(words, fmt: PositFormat = P32E2) -> float:
    """Golden-zone occupancy of an array of words (fraction of finite
    nonzero words with regime exponent k in {0, -1}), whatever the
    collector state."""
    return float(step_stats(words, fmt)["golden_frac"])
