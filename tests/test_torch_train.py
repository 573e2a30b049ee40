"""The port's training path (``core.policy``'s straight-through codec,
``forward_train``, the attention and grouped-GEMM VJPs, ``optim``,
``data``, ``launch``) against the JAX package's on the CPU.

The reference's params (``jax.random`` init) enter the port through
``interop.params_from_reference``, its gradients and optimizer states
through the same unstacking, and the batches are numpy from a seed fed to
both.  Tolerances: at ``policy="f32"`` the port sums in its own order
(library matmuls, einsums, the gradients' accumulation), so losses and
gradients are held to 1e-5 relative (a leaf's norm); AdamW is elementwise
f32 code op for op the reference's, held to 1e-6 relative with its p16e1
moment words equal; the codec is integer code, bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.core import policy as RPOL
from repro.launch.collectives import compressed_psum as r_cpsum
from repro.models import attention as r_attn
from repro.models import ffn as r_ffn
from repro.models.common import Axes as RAxes
from repro.models.lm import forward_train as r_forward_train
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update

import repro_torch.configs as TC
import torch_dist_cases as tc_cases
import torch_inputs as ti
from repro_torch import interop, tree
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import policy as TPOL
from repro_torch.core import posit
from repro_torch.core.formats import FORMATS
from repro_torch.data import make_batch
from repro_torch.dist import launch
from repro_torch.kernels import posit_gemm as pg
from repro_torch.launch.steps import (_cast_params, _loss_and_grads,
                                      make_train_step)
from repro_torch.launch.train import run
from repro_torch.models import attention as t_attn
from repro_torch.models import ffn as t_ffn
from repro_torch.models import forward_train, init_params
from repro_torch.optim import adamw_init, adamw_update

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")

FAMILY_ARCHS = ["qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-780m",
                "zamba2-2.7b", "gemma3-12b", "whisper-tiny",
                "internvl2-26b"]
GRAD_ARCHS = ["qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-780m"]
F32_RTOL = 1e-5
ADAM_RTOL = 1e-6
DP_RUN = dict(arch="qwen2-0.5b", policy="posit_dp", steps=3, batch=4,
              seq=16, lr=1e-3, seed=0)
# the p16e1 wire's noise on the losses of DP_RUN against one process on
# the whole batch (measured 8e-5 at the third step on the CPU)
DP_LOSS_RTOL = 1e-3

# The reference's programs compile without XLA's backend optimizations:
# a third less compile time on the CPU, and the comparisons are at 1e-5.
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _r_run(fn, args, **static):
    """``fn(*args, **static)`` of the reference, jitted with ``static``
    as static arguments and compiled with ``_FAST_COMPILE``."""
    lowered = jax.jit(fn, static_argnames=tuple(static)).lower(*args,
                                                               **static)
    return lowered.compile(compiler_options=_FAST_COMPILE)(*args)


def _r_loss(p, b, cfg):
    return r_forward_train(p, b, cfg)[0]


_r_grad = jax.value_and_grad(_r_loss)


def _rel_leaves(got, want):
    """``_rel`` of the leaves taken as one vector."""
    assert len(got) == len(want) > 0
    return _rel(np.concatenate([np.ravel(g) for g in got]),
                np.concatenate([np.ravel(w) for w in want]))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (nb if nb else 1.0))


def _to_reference(tree):
    """A port tree in the reference's layout (``interop``) as the
    reference takes it: jax arrays, the reference's ``Axes``."""
    if isinstance(tree, dict):
        return {k: RAxes(v) if k == "axes" else _to_reference(v)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_reference(v) for v in tree]
    return jnp.asarray(tree)


@pytest.fixture(scope="module")
def models():
    """(reference cfg, reference params, port cfg, port params) per (arch,
    policy): the port's seeded params, stacked into the reference's
    layout for it (no reference init to compile)."""
    made = {}

    def get(arch, policy="f32"):
        if (arch, policy) not in made:
            rc = RC.get_tiny_config(arch, policy=policy)
            tcfg = TC.get_tiny_config(arch, policy=policy)
            tp = init_params(0, tcfg, device="cpu")
            rp = _to_reference(interop.params_to_reference(tp, tcfg))
            made[arch, policy] = (rc, rp, tcfg, tp)
        return made[arch, policy]
    return get


def _batches(cfg, b=2, s=8, seed=0):
    """The same training batch for both packages, numpy from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    for key, n, on in (("frames", cfg.enc_seq, cfg.family == "encdec"),
                       ("vis", cfg.vis_tokens, cfg.family == "vlm")):
        if on:
            arrays[key] = rng.standard_normal(
                (b, n, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in arrays.items()})


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quantize_values_and_straight_through_grad(fmt):
    rng = np.random.default_rng(1)
    x = np.concatenate([ti.f32_corners(4000),
                        (rng.standard_normal(4000) * np.exp2(
                            rng.integers(-40, 40, 4000))).astype(np.float32)])
    x = x[np.isfinite(x)]
    c = rng.standard_normal(x.size).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    q = TPOL.quantize(xt, fmt)
    (q * torch.from_numpy(c)).sum().backward()
    rq = np.asarray(RPOL.quantize(jnp.asarray(x), fmt))
    rg = np.asarray(jax.grad(lambda v: jnp.sum(
        RPOL.quantize(v, fmt) * c))(jnp.asarray(x)))
    assert np.array_equal(q.detach().numpy().view(np.int32),
                          rq.view(np.int32))
    assert np.array_equal(xt.grad.numpy(), rg)
    assert np.array_equal(rg, c)                     # the identity


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_encode_decode_tensor_bit_identical(fmt):
    f = FORMATS[fmt]
    rng = np.random.default_rng(2)
    x = np.concatenate([ti.f32_corners(20000),
                        ti.values(rng, 20000).astype(np.float32)])
    words = TPOL.encode_tensor(torch.from_numpy(x), fmt)
    ref_words = np.asarray(RPOL.encode_tensor(jnp.asarray(x), fmt))
    assert words.dtype == TPOL.wire_dtype(f)
    assert np.array_equal(words.numpy(), ref_words)
    w = ti.words(f, rng, 1 << 14).astype(
        {8: np.int8, 16: np.int16, 32: np.int32}[f.nbits])
    got = TPOL.decode_tensor(torch.from_numpy(w), fmt).numpy()
    want = np.asarray(RPOL.decode_tensor(jnp.asarray(w), fmt))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.int32), want[ok].view(np.int32))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_decode_pair_sum_is_the_codec(fmt):
    """The card's decode (``hi + lo`` of the decode kernel's pair, the
    tiny p32e2 words from their table), run here on the kernel's plain
    version: ``to_float32_bits`` on every word (p32e2: every word near
    zero, maxpos and NaR, and a sweep)."""
    f = FORMATS[fmt]
    if f.nbits <= 16:
        w = torch.arange(-(1 << (f.nbits - 1)), 1 << (f.nbits - 1),
                         dtype=torch.int32)
    else:
        w = torch.cat([torch.arange(-70000, 70000, dtype=torch.int32),
                       torch.arange(-2 ** 31, -2 ** 31 + 70000,
                                    dtype=torch.int32),
                       torch.arange(2 ** 31 - 70000, 2 ** 31 - 1,
                                    dtype=torch.int32),
                       torch.arange(-2 ** 31 + 1, 2 ** 31 - 1, 16411,
                                    dtype=torch.int32)])
    got = TPOL._from_pair(w, f, *pg.decode_split_f32_plain(w, f))
    want = posit.to_float32_bits(w, f)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


# --------------------------------------------------------------------------
# losses and gradients
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_results(models):
    """The reference's loss (and, for GRAD_ARCHS, its gradients in the
    port's layout) per arch, each compiled once for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            rc, rp, tcfg, _ = models(arch)
            rb, _ = _batches(rc)
            if arch in GRAD_ARCHS:
                loss, g = _r_run(_r_grad, (rp, rb), cfg=rc)
                g = interop.params_from_reference(
                    jax.tree.map(np.asarray, g), tcfg, device="cpu")
            else:
                loss, g = _r_run(_r_loss, (rp, rb), cfg=rc), None
            made[arch] = (float(loss), g)
        return made[arch]
    return get


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_train_loss_matches_reference(models, ref_results, arch):
    rc, _, tcfg, tp = models(arch)
    _, tb = _batches(rc)
    ref, _ = ref_results(arch)
    loss, metrics = forward_train(tp, tb, tcfg)
    loss_r, _ = forward_train(tp, tb, tcfg, remat=True)
    assert abs(float(loss) - ref) <= F32_RTOL * abs(ref), (arch, loss, ref)
    assert float(loss_r) == float(loss)
    assert float(metrics["ntokens"]) == tb["targets"].numel()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(models, ref_results, arch, remat):
    rc, _, tcfg, tp = models(arch)
    _, tb = _batches(rc)
    ref_loss, ref_g = ref_results(arch)
    loss, _, grads = _loss_and_grads(_cast_params(tp, torch.float32), tb,
                                     tcfg, remat)
    assert abs(float(loss) - ref_loss) <= F32_RTOL * abs(ref_loss)
    got, want = tree.leaves(grads), tree.leaves(ref_g)
    assert len(got) == len(want) > 0
    errs = [_rel(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    assert max(errs) < F32_RTOL, (arch, max(errs))


def _flash_case(rng, causal, window, hq, hkv, sq=24, dh=8, chunk=8):
    q = rng.standard_normal((2, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((2, sq, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, sq, hkv, dh)).astype(np.float32)
    ct = rng.standard_normal((2, sq, hq, dh)).astype(np.float32)
    pos = np.arange(sq, dtype=np.int32)
    kw = dict(causal=causal, window=window, chunk=chunk)

    def ref(q_, k_, v_, ct_, pos_, **kw_):
        out_, vjp = jax.vjp(lambda a, b, c: r_attn.blockwise_attention(
            a, b, c, q_positions=pos_, **kw_), q_, k_, v_)
        return out_, vjp(ct_)
    out, r_grads = _r_run(ref, tuple(jnp.asarray(a)
                                     for a in (q, k, v, ct, pos)), **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    tout = t_attn.blockwise_attention(tq, tk, tv,
                                      q_positions=torch.from_numpy(pos),
                                      **kw)
    tout.backward(torch.from_numpy(ct))
    return out, r_grads, tout, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("causal,window,hq,hkv", [
    (True, 0, 4, 2), (True, 6, 4, 1), (False, 0, 2, 2)])
def test_flash_attention_vjp_matches_reference(causal, window, hq, hkv):
    """The hand-written VJP over three kv chunks: causal GQA, a sliding
    window with one kv head, bidirectional."""
    rng = np.random.default_rng(3)
    out, r_grads, tout, t_grads = _flash_case(rng, causal, window, hq, hkv)
    assert _rel(tout.detach().numpy(), out) < F32_RTOL
    for got, want in zip(t_grads, r_grads):
        assert _rel(got.numpy(), want) < F32_RTOL


def test_flash_attention_saves_no_probabilities():
    """The forward keeps (q, k, v, positions, out, lse) for the backward
    and nothing of the chunk scan."""
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    k = torch.randn(1, 16, 2, 8, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        t_attn.blockwise_attention(q, k, k, q_positions=torch.arange(16),
                                   causal=True, chunk=4)
    assert sorted(saved) == sorted([(1, 16, 2, 1, 8), (1, 16, 2, 8),
                                    (1, 16, 2, 8), (16,), (16,),
                                    (1, 16, 2, 1, 8), (1, 16, 2, 1)])


def test_flash_attention_without_gradient_keeps_no_lse(monkeypatch):
    """Serving's prefill (no gradient wanted) saves nothing and takes no
    log for lse, and gives the same output bit for bit."""
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    k = torch.randn(1, 16, 2, 8)
    kw = dict(q_positions=torch.arange(16), causal=True, chunk=4)
    want = t_attn.blockwise_attention(q, k, k, **kw).detach()
    saved, logs = [], []
    log = torch.log
    monkeypatch.setattr(t_attn.torch, "log",
                        lambda t: logs.append(t.shape) or log(t))
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        got = t_attn.blockwise_attention(q, k, k, **kw)
    assert saved == [] and logs == []
    assert torch.equal(got, want)


def test_grouped_mm_vjp_matches_reference():
    """(T, d) @ (E, d, f) with empty groups (experts 1 and 4)."""
    rng = np.random.default_rng(4)
    sizes = np.array([5, 0, 7, 4, 0, 4], np.int32)
    t, d, f = int(sizes.sum()), 6, 5
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((len(sizes), d, f)).astype(np.float32)
    dy = rng.standard_normal((t, f)).astype(np.float32)
    def ref(a, b, dy_, gs):
        out_, vjp = jax.vjp(lambda a_, b_: r_ffn._grouped_mm(a_, b_, gs),
                            a, b)
        return out_, vjp(dy_)
    out, (rdx, rdw) = _r_run(ref, tuple(jnp.asarray(a)
                                        for a in (x, w, dy, sizes)))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tout = t_ffn._grouped_mm(tx, tw, sizes.tolist())
    tout.backward(torch.from_numpy(dy))
    assert _rel(tout.detach().numpy(), out) < F32_RTOL
    assert _rel(tx.grad.numpy(), rdx) < F32_RTOL
    assert _rel(tw.grad.numpy(), rdw) < F32_RTOL
    assert not tw.grad[1].any() and not tw.grad[4].any()
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype


# --------------------------------------------------------------------------
# AdamW, data, steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_adamw_matches_reference(compress):
    """Three steps on a small tree; the gradients' global norm stays below
    the clip, so every update is elementwise."""
    rng = np.random.default_rng(5)
    shapes = {"a": (48, 40), "b": (300,), "c": (7, 3, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.01).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    rp = jax.tree.map(jnp.asarray, p0)
    ro = r_adamw_init(rp, compress_moments=compress)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    to = adamw_init(tp, compress_moments=compress)
    for g in grads:
        rp, ro, rn = r_adamw_update(rp, ro, jax.tree.map(jnp.asarray, g),
                                    lr=1e-2, compress_moments=compress)
        tp, to, tn = adamw_update(tp, to, {k: torch.from_numpy(v)
                                           for k, v in g.items()},
                                  lr=1e-2, compress_moments=compress)
        assert abs(float(tn) - float(rn)) <= ADAM_RTOL * float(rn)
    assert int(to["step"]) == int(ro["step"]) == 3
    assert to["step"].dtype == torch.int32 and to["step"].dim() == 0
    for k in shapes:
        assert _rel(tp[k].numpy(), np.asarray(rp[k])) < ADAM_RTOL
        for mom in ("m", "v"):
            got = to["moments"][k][mom].numpy()
            want = np.asarray(ro["moments"][k][mom])
            assert got.dtype == want.dtype == (np.int16 if compress
                                               else np.float32)
            if compress:
                assert np.array_equal(got, want), (k, mom)
            else:
                assert _rel(got, want) < ADAM_RTOL


def test_make_batch_deterministic_and_step_dependent():
    cfg = TC.get_smoke_config("whisper-tiny")
    cell = TC.ShapeCell("e2e", "train", 16, 2)
    a = make_batch(cfg, cell, 3, seed=1, device="cpu")
    b = make_batch(cfg, cell, 3, seed=1, device="cpu")
    c = make_batch(cfg, cell, 4, seed=1, device="cpu")
    d = make_batch(cfg, cell, 3, seed=2, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])
    assert a["tokens"].dtype == torch.int32
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    assert a["frames"].shape == (2, cfg.enc_seq, cfg.d_model)
    # the u^4 head: most ids in the lowest tenth of the vocab
    big = make_batch(cfg, TC.ShapeCell("e2e", "train", 512, 8), 0,
                     device="cpu")["tokens"]
    assert float((big < cfg.vocab // 10).float().mean()) > 0.5


@pytest.mark.parametrize("policy", sorted(TPOL.POLICIES))
def test_train_step_every_policy(policy):
    """One ``make_train_step`` of tiny qwen2 under each named policy:
    finite loss and grad norm, every param moved, the moments in the
    policy's storage (int16 words for p16e1, half the f32 bytes)."""
    cfg = TC.get_tiny_config("qwen2-0.5b", policy=policy)
    compress = cfg.get_policy().opt_compression is not None
    p = init_params(0, cfg, device="cpu")
    o = adamw_init(p, compress_moments=compress)
    batch = make_batch(cfg, TC.ShapeCell("e2e", "train", 8, 2), 0,
                       device="cpu")
    p2, o2, m = make_train_step(cfg, remat=True, lr=1e-3)(p, o, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert all(not torch.equal(a, b) for a, b in zip(tree.leaves(p),
                                                      tree.leaves(p2)))
    moments = tree.leaves(o2["moments"])
    want = torch.int16 if compress else torch.float32
    assert all(t.dtype == want for t in moments)
    f32_bytes = 2 * 4 * sum(w.numel() for w in tree.leaves(p))
    held = sum(t.numel() * t.element_size() for t in moments)
    assert held == (f32_bytes // 2 if compress else f32_bytes)


def test_train_step_matches_reference(models):
    """One ``make_train_step`` of tiny qwen2 at f32 in each package: loss,
    grad norm, params and moments, all leaves as one vector.  The
    posit32 policy's rounding and gradient are held by
    ``test_quantize_values_and_straight_through_grad``, the p16e1
    moments' words by ``test_adamw_matches_reference``."""
    from repro.launch.steps import make_train_step as r_make
    rc, rp, tcfg, tp = models("qwen2-0.5b")
    ro = r_adamw_init(rp)
    to = adamw_init(tp)
    rb, tb = _batches(rc)
    rp2, ro2, rm = _r_run(r_make(rc, remat=False, lr=1e-3), (rp, ro, rb))
    tp2, to2, tm = make_train_step(tcfg, remat=False, lr=1e-3)(tp, to, tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(rm[key])) <= F32_RTOL * float(
            rm[key])
    want_p = interop.params_from_reference(jax.tree.map(np.asarray, rp2),
                                           tcfg, device="cpu")
    assert _rel_leaves(tree.leaves(tp2), tree.leaves(want_p)) < F32_RTOL
    want_o = interop.opt_state_from_reference(
        jax.tree.map(np.asarray, ro2), tcfg, device="cpu")
    assert int(to2["step"]) == int(want_o["step"]) == 1
    assert _rel_leaves(tree.leaves(to2["moments"]),
                       tree.leaves(want_o["moments"])) < F32_RTOL


def test_restart_reproduces_training(tmp_path):
    """6 straight steps == 3 steps + a checkpoint + a restart + 3 (the
    reference's ``test_restart_reproduces_training``)."""
    kw = dict(steps=6, batch=2, seq=16, ckpt_every=3, device="cpu",
              policy="bf16_opt16")
    _, _, straight = run("qwen2-0.5b", ckpt_dir=str(tmp_path / "a"), **kw)
    run("qwen2-0.5b", ckpt_dir=str(tmp_path / "b"), **dict(kw, steps=3))
    _, opt, resumed = run("qwen2-0.5b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(resumed) == 3
    np.testing.assert_allclose(straight[3:], resumed, rtol=1e-5)
    assert int(opt["step"]) == 6


def test_checkpoint_crosses_packages(models, tmp_path):
    """A training state with p16e1 moments (int16 leaves, 0-d int32 step)
    saved by either package restores in the other, leaf for leaf."""
    _, rp, tcfg, tp = models("gemma3-12b")
    ro = r_adamw_init(rp)
    rng = np.random.default_rng(8)
    ro["moments"] = jax.tree.map(lambda m: jnp.asarray(rng.integers(
        -3000, 3000, m.shape).astype(np.int16)), ro["moments"])
    ro["step"] = jnp.int32(7)
    r_save(str(tmp_path / "ref"), 7, (rp, ro))
    to = adamw_init(tp, compress_moments=True)
    like = interop.train_state_to_reference(tp, to, tcfg)
    state, step, _ = restore_checkpoint(str(tmp_path / "ref"), like)
    gp, go = interop.train_state_from_reference(state, tcfg, device="cpu")
    want_o = interop.opt_state_from_reference(jax.tree.map(np.asarray, ro),
                                              tcfg, device="cpu")
    assert step == 7 and int(go["step"]) == 7
    for got, want in ((gp, tp), (go["moments"], want_o["moments"])):
        gl, wl = tree.leaves(got), tree.leaves(want)
        assert len(gl) == len(wl)
        assert all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(gl, wl))
    # and back: the port's checkpoint restores in the reference
    save_checkpoint(str(tmp_path / "port"), 7,
                    interop.train_state_to_reference(gp, go, tcfg))
    (rp2, ro2), step, _ = r_restore(str(tmp_path / "port"), (rp, ro))
    assert step == 7
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree.leaves((rp2, ro2)),
                               jax.tree.leaves((rp, ro))))


# --------------------------------------------------------------------------
# the compressed data-parallel step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def dp_ranks(tmp_path_factory):
    """One spawn of a 2x2 grid of gloo ranks, started with the module so
    that it runs while the other tests do: each grid column trains DP_RUN
    data-parallel over its two ranks ("row"), then every rank sums the
    compressed cases over "row" (P = 2) and over the world (P = 4)."""
    ranks = launch.spawn(tc_cases.train_dp, 2, 2,
                         tmp_path_factory.mktemp("dp") / "grid",
                         args=(DP_RUN, "row", ("row", "all")),
                         backend="gloo", device="cpu")
    yield ranks
    for proc in ranks.procs:
        if proc.is_alive():
            proc.kill()
            proc.join()


@pytest.fixture(scope="module")
def dp_runs(dp_ranks):
    return dp_ranks.join(timeout=600)


@pytest.mark.parametrize("axis,p", [("row", 2), ("all", 4)])
def test_compressed_psum_matches_reference(dp_runs, axis, p):
    """The sums equal the reference's ``compressed_psum`` (under
    ``jax.vmap`` over a named axis) word for word on every rank, count
    int16 words on both phases, and are within 5e-3 of the RMS of the
    exact sum (the reference's bound)."""
    cases = tc_cases.dp_cases(p)
    f = jax.vmap(lambda xs: r_cpsum(xs, "dp"), axis_name="dp")
    wants = _r_run(lambda xs: {k: f(v) for k, v in xs.items()},
                   ({k: jnp.asarray(v) for k, v in cases.items()},))
    for name, x in cases.items():
        want = np.asarray(wants[name])
        exact = x.astype(np.float64).sum(0)
        rms = np.sqrt(np.mean(exact ** 2))
        m = -(-x[0].size // p)
        for res in dp_runs:
            me = res["rank"] // 2 if axis == "row" else res["rank"]
            got = res["cases"]["sums"][f"{axis}.{name}"]
            assert got.shape == x.shape[1:] and got.dtype == np.float32
            assert np.array_equal(got, want[me]), (axis, name, res["rank"])
            assert np.abs(got - exact).max() < 5e-3 * rms
            c = res["cases"]["counters"]
            for kind in ("all-to-all", "all-gather"):
                assert c[f"dist.cpsum.{axis}.{name}.{kind}.bytes"] == \
                    p * m * 2


def test_dp_train_step_matches_one_process(dp_runs):
    """Two ranks of ``make_train_step_compressed`` (posit_dp) against one
    process of ``make_train_step`` on the whole batch: the same losses
    within the p16e1 wire's noise, the same params on both ranks, and the
    gradient sums' all-to-all and all-gather bytes each half of an f32
    all-reduce of the compressed leaves."""
    _, _, single = run(DP_RUN["arch"], steps=DP_RUN["steps"],
                       batch=DP_RUN["batch"], seq=DP_RUN["seq"],
                       lr=DP_RUN["lr"], policy=DP_RUN["policy"],
                       device="cpu")
    for res in dp_runs:
        assert len(res["losses"]) == DP_RUN["steps"]
        np.testing.assert_allclose(res["losses"], single, rtol=DP_LOSS_RTOL)
        c = res["counters"]
        half_f32 = 2 * res["compressed_elems"]
        assert c["dist.grads.all-to-all.bytes"] == DP_RUN["steps"] * half_f32
        assert c["dist.grads.all-gather.bytes"] == DP_RUN["steps"] * half_f32
    for res in dp_runs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(
            res["params"], dp_runs[0]["params"]))
