"""Exact ABFT: ones-weighted checksums carried as canonical quire limbs,
verified by exact integer equality (counterpart of ``repro.ft.abft``).

A checksum is the EXACT ones-weighted sum of the posit words' values,
accumulated through the quire's deposit (``_decode_half`` +
``_deposit_terms``, integer limb adds) and carried in canonical
(carry-propagated, ``q_renorm``) form.  Integer adds are associative, so
"the sum of the words" is one integer state whatever the order, and posit
words are value-injective (NaR is a flag), so ANY change to a word changes
the sum: detection of a corrupted word is total, and verifying
uncorrupted words never fails.  No tolerance.  The words and limbs are
the reference's, on the CPU and on a GPU.

Narrow formats store words sign-extended in int32; a flip in the
redundant upper bits does not change the VALUE, so each checksum also
carries the raw int64 word sums.

The reference deposits every word into an (M, N, L) limb tensor and sums
it along an axis.  The port adds each word's three deposit terms straight
into the (M, L) and (N, L) sums (one ``index_add_`` each): the same limb
integers before ``q_renorm``, so the same canonical limbs, without the
(M, N, L) tensor (tests/test_torch_ft.py holds both forms to the
reference's).

Protected ops follow one shape: produce -> checksum -> [injection window]
-> verify before consuming -> on mismatch, localize via the row x column
mismatch and recompute from the last verified state (bounded retries).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.ft.inject import FaultPlan
from repro_torch.ft.report import FtReport
from repro_torch.kernels.ops import _rgemm
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.quire.gemm import quire_gemm_limbs
from repro_torch.quire.quire import (Quire, _decode_half, _deposit_terms, _F,
                                     _I64, q_renorm, q_to_posit, quire_limbs,
                                     quire_lsb_exp)


class AbftError(RuntimeError):
    """Checksum mismatch persisted past the bounded retry budget."""


def _word_terms(w: torch.Tensor, fmt: PositFormat):
    """Each word's quire deposit as three limb adds: ((..., 3) limb
    index, (..., 3) int64 addend, (...) nar)."""
    f, c, sgn, nar = _decode_half(w, fmt)
    idx, src = _deposit_terms(f, c - _F - quire_lsb_exp(fmt), sgn,
                              quire_limbs(fmt))
    return idx, src, nar


def _word_limbs(words, fmt: PositFormat):
    """Per-word quire deposit: (...,) posit words -> ((..., L) int64
    redundant limbs, (...) nar flags).  Summing these limbs along an axis
    is the ones-weighted checksum (the reference's form)."""
    w = torch.as_tensor(words).to(torch.int32)
    idx, src, nar = _word_terms(w, fmt)
    limbs = torch.zeros(w.shape + (quire_limbs(fmt),), dtype=_I64,
                        device=w.device)
    return limbs.scatter_add_(-1, idx, src), nar


def _axis_sums(idx, src, nar, axis: int, n_limbs: int):
    """Canonical limbs of the deposit terms summed along ``axis`` of the
    word shape: ((..., L) limbs, (...) nar), the axis removed."""
    shape = nar.shape
    axis = axis % len(shape)
    out_shape = shape[:axis] + shape[axis + 1:]
    size = math.prod(out_shape)
    pos = torch.arange(size, device=idx.device).reshape(out_shape)
    flat = pos.unsqueeze(axis).expand(shape)[..., None] * n_limbs + idx
    limbs = torch.zeros(size * n_limbs, dtype=_I64, device=idx.device)
    limbs.index_add_(0, flat.reshape(-1), src.reshape(-1))
    q = q_renorm(Quire(limbs=limbs.reshape(out_shape + (n_limbs,)),
                       nar=nar.any(dim=axis)))
    return q.limbs, q.nar


def word_sums(words, fmt: PositFormat, axis: int):
    """Exact ones-weighted sum of posit-word VALUES along ``axis``, as
    canonical quire limbs: ((..., L) limbs, (...) nar).  Headroom: each
    word adds < 2^32 to a limb, so up to 2^31 words per sum."""
    w = torch.as_tensor(words).to(torch.int32)
    return _axis_sums(*_word_terms(w, fmt), axis, quire_limbs(fmt))


def limb_sums(limbs, nar, axis: int):
    """Canonical checksum of a pre-rounding limb STATE (M, N, L) along
    ``axis``: the limb analogue of ``word_sums``, for protecting a quire
    accumulator before its single rounding."""
    axis = axis % (limbs.dim() - 1)
    q = q_renorm(Quire(limbs=limbs.sum(dim=axis), nar=nar.any(dim=axis)))
    return q.limbs, q.nar


@dataclasses.dataclass
class Checksums:
    """Row/column checksums of an (M, N) posit-word matrix: canonical
    value-sum limbs, nar flags, and raw int64 word sums."""
    row: torch.Tensor                              # (M, L) int64
    col: torch.Tensor                              # (N, L) int64
    row_nar: torch.Tensor                          # (M,) bool
    col_nar: torch.Tensor                          # (N,) bool
    row_w: torch.Tensor                            # (M,) int64 raw word sum
    col_w: torch.Tensor                            # (N,) int64


def checksum(words, fmt: PositFormat = P32E2) -> Checksums:
    """Production-time checksums of an (M, N) posit-word matrix (the
    deposit terms are made once, for both axes)."""
    w = torch.as_tensor(words).to(torch.int32)
    terms = _word_terms(w, fmt)
    row, row_nar = _axis_sums(*terms, 1, quire_limbs(fmt))
    col, col_nar = _axis_sums(*terms, 0, quire_limbs(fmt))
    w64 = w.to(_I64)
    return Checksums(row=row, col=col, row_nar=row_nar, col_nar=col_nar,
                     row_w=w64.sum(dim=1), col_w=w64.sum(dim=0))


def verify(words, cks: Checksums, fmt: PositFormat = P32E2):
    """Recompute ``checksum(words)`` and compare by exact integer
    equality.  Returns (ok 0-d bool, bad_row (M,) bool, bad_col (N,)
    bool): a single corrupted word flags exactly its row and its column."""
    got = checksum(words, fmt)
    bad_row = ((got.row != cks.row).any(dim=-1)
               | (got.row_nar != cks.row_nar) | (got.row_w != cks.row_w))
    bad_col = ((got.col != cks.col).any(dim=-1)
               | (got.col_nar != cks.col_nar) | (got.col_w != cks.col_w))
    return ~(bad_row.any() | bad_col.any()), bad_row, bad_col


def locate(bad_row, bad_col, nb: int = 1):
    """First corrupted (row, col) — in units of ``nb``-sized blocks —
    from ``verify``'s mismatch masks; -1 where no mismatch."""
    r = np.flatnonzero(np.asarray(torch.as_tensor(bad_row).cpu()))
    c = np.flatnonzero(np.asarray(torch.as_tensor(bad_col).cpu()))
    return (int(r[0]) // nb if r.size else -1,
            int(c[0]) // nb if c.size else -1)


def note_detection(report: FtReport, site: str, step: int, where) -> None:
    """Count one detected mismatch in ``report`` and in the open
    collectors (``ft.detections``, ``ft.retries``)."""
    report.detections += 1
    report.sites.append((site, step, where))
    _obs_metrics.inc("ft.detections")
    _obs_metrics.inc("ft.retries")


def run_steps(site: str, starts, nb: int, state, attempt,
              max_retries: int = 2):
    """The protected factorizations' host-stepped loop.  For each block
    start ``j``, ``attempt(state, j, inject)`` recomputes the step from the
    verified ``state`` (leaving it untouched), injects a plan's faults when
    ``inject`` (the first attempt only: transient faults do not recur),
    and returns (new state, ok, bad_row, bad_col).  A mismatch is counted
    and the step retried from the same state; past ``max_retries``
    retries the loop raises ``AbftError``.  Returns (state, FtReport)."""
    report = FtReport()
    for j in starts:
        for k in range(max_retries + 1):
            new, ok, bad_row, bad_col = attempt(state, j, k == 0)
            if ok:
                report.retries += k
                break
            note_detection(report, site, j // nb,
                           locate(bad_row, bad_col, nb))
        else:
            report.failed = True
            raise AbftError(
                f"{site.split('.')[0]}_ft: step {j // nb} mismatch "
                f"persisted across {max_retries + 1} attempts at "
                f"{report.sites}")
        state = new
    return state, report


# --------------------------------------------------------------------------
# protected GEMMs
# --------------------------------------------------------------------------

def rgemm_ft(a_p, b_p, c_p=None, alpha=1.0, beta=0.0, trans_a: bool = False,
             trans_b: bool = False, backend: str = "quire_exact",
             fmt: PositFormat = P32E2, plan: FaultPlan | None = None,
             step: int = 0, max_retries: int = 2):
    """Checksum-protected ``rgemm``: returns (C, Checksums, FtReport).

    The compute is the unprotected GEMM (the un-hooked ``_rgemm``: the
    reference runs it inside a jitted program), so fault-free the words
    are ``rgemm``'s.  Injection site ``"rgemm.out"`` sits between
    checksum production and verification; a detected mismatch recomputes
    (at most ``max_retries`` times), and exhaustion raises ``AbftError``."""
    report = FtReport()
    for attempt in range(max_retries + 1):
        out = _rgemm(a_p, b_p, c_p, alpha, beta, trans_a=trans_a,
                     trans_b=trans_b, backend=backend, fmt=fmt)
        cks = checksum(out, fmt)
        if attempt == 0 and plan is not None:
            out = plan.words("rgemm.out", step, out, fmt)
        ok, bad_row, bad_col = verify(out, cks, fmt)
        if bool(ok):
            report.retries = attempt
            return out, cks, report
        note_detection(report, "rgemm.out", step, locate(bad_row, bad_col))
    report.failed = True
    raise AbftError(f"rgemm_ft: mismatch persisted across "
                    f"{max_retries + 1} attempts at {report.sites}")


def _limb_checksums(limbs, nar):
    lrow, lrow_nar = limb_sums(limbs, nar, axis=1)
    lcol, lcol_nar = limb_sums(limbs, nar, axis=0)
    return lrow, lrow_nar, lcol, lcol_nar


def quire_gemm_ft(a_p, b_p, fmt: PositFormat = P32E2,
                  plan: FaultPlan | None = None, step: int = 0,
                  max_retries: int = 2):
    """Limb-protected quire-exact GEMM: like ``rgemm_ft`` with
    ``quire_exact``, but also checksums the int64 limb STATE across the
    pre-rounding window, so flips injected into the accumulator (site
    ``"rgemm.limbs"``) are caught before the single rounding could turn
    them into a plausible word.  Returns (C, Checksums, FtReport)."""
    report = FtReport()
    for attempt in range(max_retries + 1):
        limbs, nar = quire_gemm_limbs(a_p, b_p, fmt)
        sums = _limb_checksums(limbs, nar)
        if attempt == 0 and plan is not None:
            limbs = plan.limbs("rgemm.limbs", step, limbs)
        got = _limb_checksums(limbs, nar)
        ok_limbs = all(bool(torch.equal(g, s)) for g, s in zip(got, sums))
        out = q_to_posit(Quire(limbs=limbs, nar=nar), fmt)
        cks = checksum(out, fmt)
        if attempt == 0 and plan is not None:
            out = plan.words("rgemm.out", step, out, fmt)
        ok_words, bad_row, bad_col = verify(out, cks, fmt)
        if ok_limbs and bool(ok_words):
            report.retries = attempt
            return out, cks, report
        site = "rgemm.out" if ok_limbs else "rgemm.limbs"
        note_detection(report, site, step, locate(bad_row, bad_col))
    report.failed = True
    raise AbftError(f"quire_gemm_ft: mismatch persisted across "
                    f"{max_retries + 1} attempts at {report.sites}")
