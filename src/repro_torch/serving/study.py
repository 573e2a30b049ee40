"""Quantized-inference accuracy study (counterpart of
``repro.serving.study``).

What posit weight quantization costs in logits, per format, against the
f32 model and against the bf16 cast of the same leaves, beside the
golden-zone occupancy of the quantized words.  Per (arch, format,
equilibration) cell, on tiny-scale models:

* ``rel_err`` — ||logits_q - logits_f32|| / ||logits_f32||
* ``kl``      — mean KL(softmax_f32 || softmax_q), a perplexity proxy
* ``top1``    — argmax agreement fraction
* ``gz``      — element-weighted golden-zone occupancy of the words

The port's weights come from its own seeded init, the reference's from
``jax.random``: the same study, not the same numbers; ``arch_rows`` runs
it on given params and tokens (the tests hand it the reference's).
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_tiny_config
from repro_torch.models import forward_prefill, init_params
from repro_torch.models.common import is_param
from repro_torch.serving.quantize import (QUANT_LEAF_KEYS, QuantConfig,
                                          quantize_params,
                                          weight_golden_zone)

STUDY_ARCHS = ("qwen2-0.5b", "mamba2-780m")
STUDY_FMTS = ("p32e2", "p16e1", "p8e2")


def _logit_metrics(ref, q):
    ref = ref.to(torch.float32)
    q = q.to(torch.float32)
    rel = torch.linalg.norm(q - ref) / torch.clamp(torch.linalg.norm(ref),
                                                   min=1e-30)
    lp_ref = torch.log_softmax(ref, dim=-1)
    lp_q = torch.log_softmax(q, dim=-1)
    kl = torch.mean(torch.sum(torch.exp(lp_ref) * (lp_ref - lp_q), dim=-1))
    top1 = torch.mean((ref.argmax(-1) == q.argmax(-1)).to(torch.float32))
    return float(rel), float(kl), float(top1)


def _bf16_params(params):
    """The bf16-storage reference: the leaves the posit quantizer
    touches, rounded to bf16 instead."""
    def visit(tree, name):
        if is_param(tree):
            if name not in QUANT_LEAF_KEYS or tree["w"].dim() < 2:
                return tree
            return {"w": tree["w"].to(torch.bfloat16).to(torch.float32),
                    "axes": tree["axes"]}
        if isinstance(tree, dict):
            return {k: visit(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(visit(v, name) for v in tree)
        return tree
    return visit(params, "")


def arch_rows(cfg, params, tokens, fmts=STUDY_FMTS) -> list[dict]:
    """The study's rows for one model: the bf16 row, then each format
    with and without per-channel equilibration."""
    batch = {"tokens": tokens}
    ref = forward_prefill(params, batch, cfg)
    rel, kl, top1 = _logit_metrics(ref, forward_prefill(
        _bf16_params(params), batch, cfg))
    rows = [{"arch": cfg.name, "fmt": "bf16", "equilibrated": "-",
             "rel_err": rel, "kl": kl, "top1": top1, "gz": None}]
    for fmt in fmts:
        for per_channel in (True, False):
            qp = quantize_params(
                params, QuantConfig(fmt=fmt, per_channel=per_channel))
            rel, kl, top1 = _logit_metrics(ref, forward_prefill(qp, batch,
                                                                cfg))
            rows.append({
                "arch": cfg.name, "fmt": fmt,
                "equilibrated": "yes" if per_channel else "no",
                "rel_err": rel, "kl": kl, "top1": top1,
                "gz": weight_golden_zone(qp)})
    return rows


def quant_study(arch_ids=STUDY_ARCHS, fmts=STUDY_FMTS, *, seed: int = 0,
                batch: int = 2, seq: int = 16, device="cuda") -> list[dict]:
    """Rows of {"arch", "fmt", "equilibrated", rel_err, kl, top1, gz}
    over the port's seeded tiny models; ``fmt`` "bf16" is the cast."""
    rows = []
    for arch in arch_ids:
        cfg = get_tiny_config(arch, policy="f32")
        params = init_params(seed, cfg, device)
        gen = torch.Generator(device=params["embed"]["table"]["w"].device)
        gen.manual_seed(seed + 1)
        toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                             device=gen.device, dtype=torch.int32)
        rows += arch_rows(cfg, params, toks, fmts)
    return rows


def study_table(rows: list[dict]) -> str:
    """Markdown table of the study rows."""
    out = ["| arch | fmt | equil | rel_err | KL | top1 | gz |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        gz = "-" if r["gz"] is None else f"{r['gz']:.3f}"
        out.append(
            f"| {r['arch']} | {r['fmt']} | {r['equilibrated']} "
            f"| {r['rel_err']:.3e} | {r['kl']:.3e} "
            f"| {r['top1']:.3f} | {gz} |")
    return "\n".join(out)
