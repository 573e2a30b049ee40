"""Unit ``updates``: the trailing updates of one blocked factorization of
the whole input stack, in order, each one ``repro_torch.kernels.ops.rgemm(
A, B, C, alpha=-1, beta=1)`` on views of the input words, sliced as the
program's block step slices them (``SLICES``, by the configuration's
``algo``).  The outputs are not written back.

A sample of the window's outputs, drawn from the seed, and the last
unit's first (largest) update are kept; after the window each is
compared with the exact ``C - A @ B`` by ``upd_err``
(``reference/check.py``).
"""
from __future__ import annotations

import importlib
import random

import roofline
import workload as wl
from reference import check
from reference import lu as ref_lu
from reference import posit as ref_posit


def _cholesky(a, j, nb):
    """``_potrf_step``: C - A21 A21^T, A21 = a[j+nb:, j:j+nb]."""
    a21 = a[..., j + nb:, j:j + nb]
    return a21, a21, a[..., j + nb:, j + nb:], True


def _lu(a, j, nb):
    """``_getrf_step``: C - L21 U12, L21 = a[j+nb:, j:j+nb] and
    U12 = a[j:j+nb, j+nb:], no transpose."""
    return (a[..., j + nb:, j:j + nb], a[..., j:j + nb, j + nb:],
            a[..., j + nb:, j + nb:], False)


SLICES = {"cholesky": _cholesky, "lu": _lu}


class Updates(wl.Unit):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if cfg["algo"] not in SLICES:
            raise ValueError(f"updates: no slicing for {cfg['algo']!r}")
        self.cfg = cfg
        self.words = wl.make_words(cfg, traffic, seed, device)
        self.slice = SLICES[cfg["algo"]]
        self.ops = importlib.import_module("repro_torch.kernels.ops")
        self.pfmt = wl.program_format(cfg)
        n, nb = cfg["n"], cfg["nb"]
        self.steps = list(range(0, n - nb, nb))
        batch = self.words.shape[0]
        self.flops = sum(roofline.gemm_flops(batch, n - j - nb, nb, n - j - nb)
                         for j in self.steps)
        self.answers = len(self.steps)
        self.size = traffic["sample_calls"]
        self.rng = random.Random(seed)
        self.sample: list = []          # reservoir of (j, output)
        self.seen = 0
        self.last = None

    def operands(self, j: int):
        """(A, B, C, trans_b) of the update at block column ``j``."""
        return self.slice(self.words, j, self.cfg["nb"])

    def run(self):
        outs = []
        for j in self.steps:
            a, b, c, trans_b = self.operands(j)
            outs.append(self.ops.rgemm(
                a, b, c, alpha=-1.0, beta=1.0, trans_b=trans_b,
                backend=self.cfg["gemm_backend"], fmt=self.pfmt))
        return outs

    def keep(self, outs) -> None:
        for j, out in zip(self.steps, outs):
            self.seen += 1
            if len(self.sample) < self.size:
                self.sample.append((j, out))
            else:
                r = self.rng.randrange(self.seen)
                if r < self.size:
                    self.sample[r] = (j, out)
        self.last = (self.steps[0], outs[0])

    def _picked(self):
        return self.sample + ([self.last] if self.last else [])

    def _worst(self, picked, produce) -> tuple[float, list[float]]:
        """Largest ``update_err`` of each picked update, the output's
        values made by ``produce(out, block slice, a, b, c, fmt)``."""
        fmt = ref_posit.fmt_of(self.cfg["fmt"])
        errs = []
        for j, out in picked:
            a, b, c, trans_b = self.operands(j)
            if trans_b:
                b = b.mT
            err = 0.0
            for s in range(0, a.shape[0], wl.BLOCK):
                sl = slice(s, s + wl.BLOCK)
                av, bv, cv = (wl.values(t[sl], fmt) for t in (a, b, c))
                got = produce(out, sl, av, bv, cv, fmt)
                err = max(err, check.update_err(av, bv, cv, got, fmt))
            errs.append(err)
        return (max(errs) if errs else float("inf")), errs

    def check(self, limits: dict):
        picked = self._picked()
        worst, errs = self._worst(
            picked, lambda out, sl, av, bv, cv, fmt: wl.values(out[sl], fmt))
        failed = sum(e > limits["upd_err"] for e in errs)
        return {"upd_err": worst}, failed, {"outputs_checked": len(picked)}

    def controls(self) -> dict:
        """``tf32``: the reference put in the program's place with its
        product on TF32, the precision below the float32 sums that the
        configuration states, on the same picked updates."""
        def produce(out, sl, av, bv, cv, fmt):
            return ref_lu.update(av, bv, cv,
                                 lambda v: ref_posit.round_value(v, fmt),
                                 ref_lu.tf32_product)
        return {"tf32": {"upd_err": self._worst(self._picked(), produce)[0]}}


def make(cfg: dict, traffic: dict, seed: int, device) -> Updates:
    return Updates(cfg, traffic, seed, device)
