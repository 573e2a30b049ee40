"""Unit ``factor``: one batched blocked factorization of the whole input
stack, ``repro_torch.lapack.decomp.rgetrf_batched`` (``algo: lu``).

The input is made once in set-up and every unit factors it anew.  Of each
unit's output the ``check_matrices`` matrices drawn from the seed are
kept; after the window they are compared with the reference's LU of the
same input (``reference/lu.py``) by the relative gap of three backward
errors (``reference/check.py``): ``bwd_dev`` over the whole matrix, and
``panel0_dev`` and ``trsm0_dev`` over the first block step's panel and
block row of U.  No update precedes those two, so the precision of the
panel and of the triangular solve shows there alone.
"""
from __future__ import annotations

import importlib
import random

import torch

import roofline
import workload as wl
from reference import check
from reference import lu as ref_lu
from reference import posit as ref_posit

NUMBERS = {"whole": "bwd_dev", "panel0": "panel0_dev", "trsm0": "trsm0_dev"}


class Factor(wl.Unit):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if cfg["algo"] != "lu":
            raise ValueError(f"factor: no reference for {cfg['algo']!r}")
        self.cfg = cfg
        self.words = wl.make_words(cfg, traffic, seed, device)
        self.decomp = importlib.import_module("repro_torch.lapack.decomp")
        self.pfmt = wl.program_format(cfg)
        batch = self.words.shape[0]
        self.flops = roofline.lu_flops(cfg["n"], batch)
        self.answers = batch
        k = min(traffic.get("check_matrices", batch), batch)
        self.checked = sorted(random.Random(seed).sample(range(batch), k))
        self.idx = torch.tensor(self.checked, device=device)
        self.kept: list = []
        self.e_ref = None

    def run(self):
        return self.decomp.rgetrf_batched(
            self.words, nb=self.cfg["nb"],
            gemm_backend=self.cfg["gemm_backend"], fmt=self.pfmt)

    def keep(self, out) -> None:
        lu_words, ipiv = out
        self.kept.append((lu_words[self.idx].clone(),
                          ipiv[self.idx].clone()))

    def _inputs(self):
        fmt = ref_posit.fmt_of(self.cfg["fmt"])
        return fmt, wl.values(self.words[self.idx], fmt)

    def _errors(self, a, lu, piv):
        return check.lu_backward_errors(a, lu, piv, self.cfg["nb"])

    def _reference(self):
        if self.e_ref is None:
            fmt, a = self._inputs()
            ref, piv = ref_lu.getrf(a, self.cfg["nb"],
                                    lambda v: ref_posit.round_value(v, fmt))
            self.e_ref = self._errors(a, ref, piv)
        return self.e_ref

    def _devs(self, e: dict) -> dict:
        e_ref = self._reference()
        return {NUMBERS[k]: check.bwd_dev(e[k], e_ref[k]) for k in NUMBERS}

    def check(self, limits: dict):
        fmt, a = self._inputs()
        e_ref = self._reference()
        worst = {name: float("inf") if not self.kept else 0.0
                 for name in NUMBERS.values()}
        failed, e_prog = 0, None
        for lu_words, ipiv in self.kept:
            e_prog = self._errors(a, wl.values(lu_words, fmt), ipiv)
            devs = self._devs(e_prog)
            bad = torch.zeros_like(devs["bwd_dev"], dtype=torch.bool)
            for name, dev in devs.items():
                bad |= dev > limits[name]
                worst[name] = max(worst[name], float(dev.max()))
            failed += int(bad.sum())
        info = {"units_checked": len(self.kept),
                "matrices_checked": len(self.checked)}
        if e_prog is not None:
            info["digits"] = float((-torch.log10(e_prog["whole"])).mean())
            info["digits_reference"] = float(
                (-torch.log10(e_ref["whole"])).mean())
        return worst, failed, info

    def controls(self) -> dict:
        """Two controls, the reference put in the program's place:
        ``float32``, every operation, the inputs and the product's sums
        in float32, the precision below posit32; ``float32_panel_trsm``,
        the panel and the triangular solve in float32, the update as the
        kernel computes it, rounded to the format."""
        fmt, a = self._inputs()
        posit_round = lambda v: ref_posit.round_value(v, fmt)  # noqa: E731
        runs = {
            "float32": lambda: ref_lu.getrf(
                ref_lu.f32_round(a), self.cfg["nb"], ref_lu.f32_round,
                ref_lu.f32_product),
            "float32_panel_trsm": lambda: ref_lu.getrf(
                a, self.cfg["nb"], ref_lu.f32_round,
                update_rnd=posit_round),
        }
        out = {}
        for name, factor in runs.items():
            lu, piv = factor()
            out[name] = {k: float(v.max())
                         for k, v in self._devs(self._errors(a, lu, piv)).items()}
            del lu, piv
        return out


def make(cfg: dict, traffic: dict, seed: int, device) -> Factor:
    return Factor(cfg, traffic, seed, device)
