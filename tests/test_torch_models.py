"""The port's LM stack (``repro_torch.configs``, ``core.policy``,
``models``) against the JAX package's on the CPU.

The reference's params (``jax.random`` init) are carried into the port
through ``repro_torch.interop.params_from_reference``; inputs are numpy
from a seed.  Tolerances: at ``policy="f32"`` the port sums in its own
order (library matmuls, einsums, softmax), so logits are held to 1e-5
relative (measured ~1e-6); the bf16 policy rounds every op's output to
bf16, where the two libraries may keep an f32 intermediate or not, so it
is held to 2e-2 relative; the policy's posit rounding is integer code,
so its words are bit-identical.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.core import policy as RPOL
from repro.models import forward_prefill as r_prefill
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init
from repro.models import serve_step as r_serve_step
from repro.models import attention as r_attn
from repro.models.lm import _encoder as r_encoder

import repro_torch.configs as TC
from repro_torch.core import policy as TPOL
from repro_torch.interop import params_from_reference
from repro_torch.models import forward_prefill, init_cache, init_params
from repro_torch.models import serve_step
from repro_torch.models import attention as t_attn
from repro_torch.models.lm import _encoder as t_encoder

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")

FAMILY_ARCHS = ["qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-780m",
                "zamba2-2.7b", "gemma3-12b", "whisper-tiny",
                "internvl2-26b"]
F32_RTOL = 1e-5
BF16_RTOL = 2e-2

_r_prefill = jax.jit(r_prefill, static_argnames="cfg")
_r_step = jax.jit(r_serve_step, static_argnames="cfg")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def models():
    """(reference cfg, reference params, port cfg, port params) per
    (arch, policy), made once for the module."""
    made = {}

    def get(arch, policy="f32"):
        if (arch, policy) not in made:
            rc = RC.get_tiny_config(arch, policy=policy)
            rp = r_init(jax.random.PRNGKey(0), rc)
            tc = TC.get_tiny_config(arch, policy=policy)
            tp = params_from_reference(jax.tree.map(np.asarray, rp), tc,
                                       device="cpu")
            made[arch, policy] = (rc, rp, tc, tp)
        return made[arch, policy]
    return get


def _batches(cfg, b=2, s=8, seed=0):
    """The same batch for both packages, numpy from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks)}
    for key, n, on in (("frames", cfg.enc_seq, cfg.family == "encdec"),
                       ("vis", cfg.vis_tokens, cfg.family == "vlm")):
        if on:
            x = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
            ref[key], port[key] = jnp.asarray(x), torch.from_numpy(x)
    return ref, port


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_prefill_matches_reference(models, arch):
    rc, rp, tc, tp = models(arch)
    rb, tb = _batches(rc)
    ref = np.asarray(_r_prefill(rp, rb, cfg=rc))
    out = forward_prefill(tp, tb, tc).numpy()
    assert out.shape == ref.shape == (2, rc.vocab)
    assert _rel(out, ref) < F32_RTOL, arch


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b", "gemma3-12b",
                                  "whisper-tiny"])
def test_serve_step_matches_reference(models, arch):
    """Three decode steps from the same cache state in both packages:
    the ring cache (gemma3's local layers), the hybrid's per-period
    shared-block cache and whisper's cross K/V."""
    rc, rp, tc, tp = models(arch)
    b, s_cache = 2, 12
    rcache = r_init_cache(rc, b, s_cache, dtype=jnp.float32)
    tcache = init_cache(tc, b, s_cache, dtype=torch.float32, device="cpu")
    if rc.family == "encdec":
        rb, tb = _batches(rc)
        pol, dt = rc.get_policy(), jnp.float32
        enc = r_encoder(rp, rb["frames"], rc, pol, dt)
        rcache["cross_kv"] = jax.vmap(lambda lp: r_attn.cross_kv_init(
            lp["xattn"], enc, rc, pol, dt))(rp["layers"][0])
        tenc = t_encoder(tp, tb["frames"], tc, tc.get_policy(),
                         torch.float32)
        tcache["cross_kv"] = [t_attn.cross_kv_init(
            lp["xattn"], tenc, tc, tc.get_policy(), torch.float32)
            for lp in tp["layers"]]
    toks = np.random.default_rng(1).integers(0, rc.vocab, (b, 10))
    for pos in range(10):
        tok = toks[:, pos:pos + 1].astype(np.int32)
        rl, rcache = _r_step(rp, rcache, jnp.asarray(tok), jnp.int32(pos),
                             cfg=rc)
        tl, tcache = serve_step(tp, tcache, torch.from_numpy(tok), pos, tc)
        assert _rel(tl.numpy(), rl) < F32_RTOL, (arch, pos)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m",
                                  "mamba2-780m", "zamba2-2.7b",
                                  "gemma3-12b"])
def test_serve_step_decode_matches_prefill(arch):
    """Within the port: the decode path token by token gives the prefill
    forward's last-position logits (independent cache paths; gemma3's
    ring wraps, the prompt is longer than its local window)."""
    cfg = TC.get_tiny_config(arch, policy="f32")
    params = init_params(1, cfg, device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    pre = forward_prefill(params, {"tokens": toks}, cfg)
    cache = init_cache(cfg, b, 32, dtype=torch.float32, device="cpu")
    for i in range(s):
        logits, cache = serve_step(params, cache, toks[:, i:i + 1], i, cfg)
    assert _rel(logits.numpy(), pre.numpy()) < 1e-4, arch
    assert torch.equal(logits.argmax(-1), pre.argmax(-1))


def test_per_row_decode_equals_scalar_decode():
    """serve_step with (B,) positions (the engine's form) gives the
    scalar-position step's logits and cache when every row is at the
    same position."""
    cfg = TC.get_tiny_config("gemma3-12b", policy="f32")
    params = init_params(3, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 6)).astype(np.int32))
    c1 = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    c2 = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for i in range(6):
        l1, c1 = serve_step(params, c1, toks[:, i:i + 1], i, cfg)
        l2, c2 = serve_step(params, c2, toks[:, i:i + 1],
                            torch.full((2,), i, dtype=torch.int32), cfg)
        assert torch.equal(l1, l2), i


@pytest.mark.parametrize("decode", [False, True])
def test_local_window_masks_long_range(decode):
    """A local layer does not attend beyond its window: perturbing K/V at
    positions outside the last query's window leaves its output as is,
    perturbing one inside changes it (prefill's chunked path and the
    decode path over a full cache)."""
    rng = np.random.default_rng(4)
    b, s, h, d, window = 1, 16, 2, 8, 4
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))

    def last(kk, vv):
        if decode:
            return t_attn.blockwise_attention(
                q[:, -1:], kk, vv, q_positions=torch.tensor([s - 1]),
                causal=True, window=window, kv_valid_len=s)
        return t_attn.blockwise_attention(
            q, kk, vv, q_positions=torch.arange(s), causal=True,
            window=window, chunk=4)[:, -1:]

    base = last(k, v)
    far_k, far_v = k.clone(), v.clone()
    far_k[:, :s - window] += 5.0
    far_v[:, :s - window] -= 3.0
    assert torch.equal(last(far_k, far_v), base)
    near_v = v.clone()
    near_v[:, s - 2] += 1.0
    assert not torch.equal(last(k, near_v), base)


def test_fully_masked_row_matches_reference():
    """A decode row with no visible slot takes the reference's value
    (the -1e30 mask constant: a uniform average), not NaN."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    kvp = np.array([[-1] * 6, [0, 1, 2, -1, -1, -1]], np.int32)
    qpos = np.array([[3], [2]], np.int32)
    ref = r_attn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), causal=True,
        kv_positions=jnp.asarray(kvp), kv_valid_len=jnp.asarray([4, 3]))
    out = t_attn.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(qpos), causal=True,
        kv_positions=torch.from_numpy(kvp),
        kv_valid_len=torch.tensor([4, 3]))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_bf16_policy_prefill_matches_reference(models):
    rc, rp, tc, tp = models("qwen2-0.5b", "bf16")
    rb, tb = _batches(rc)
    ref = np.asarray(_r_prefill(rp, rb, cfg=rc))
    out = forward_prefill(tp, tb, tc)
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref) < BF16_RTOL


def test_posit32_policy_prefill_matches_reference(models):
    """``policy="posit32"``: weights and activations rounded to p32e2 in
    every linear, compute in f32."""
    rc, rp, tc, tp = models("qwen2-0.5b", "posit32")
    rb, tb = _batches(rc)
    ref = np.asarray(_r_prefill(rp, rb, cfg=rc))
    assert _rel(forward_prefill(tp, tb, tc).numpy(), ref) < F32_RTOL


@pytest.mark.parametrize("fmt", ["p32e2", "p16e1", "p8e2"])
def test_policy_rounding_bit_identical(fmt):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))
         ).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, np.nan]
    xt = torch.from_numpy(x)
    words = TPOL.encode_tensor(xt, fmt)
    ref_words = np.asarray(RPOL.encode_tensor(jnp.asarray(x), fmt))
    assert words.numpy().dtype == ref_words.dtype
    assert np.array_equal(words.numpy(), ref_words)
    assert np.array_equal(
        TPOL.decode_tensor(words, fmt).numpy().view(np.int32),
        np.asarray(RPOL.decode_tensor(jnp.asarray(ref_words), fmt)).view(
            np.int32))
    q = TPOL.quantize(xt[4:], fmt).numpy()
    rq = np.asarray(RPOL.quantize(jnp.asarray(x[4:]), fmt))
    assert np.array_equal(q.view(np.int32), rq.view(np.int32))
    pol = TPOL.get_policy("posit32")
    assert pol == TPOL.Policy(**dataclasses.asdict(RPOL.get_policy(
        "posit32")))


def test_configs_equal_reference():
    """Every published config, smoke config and tiny config, field by
    field; the policies and the shape cells too."""
    assert TC.ARCH_IDS == RC.ARCH_IDS
    for arch in RC.ARCH_IDS:
        for get in ("get_config", "get_smoke_config", "get_tiny_config"):
            r = dataclasses.asdict(getattr(RC, get)(arch))
            t = dataclasses.asdict(getattr(TC, get)(arch))
            assert t == r, (arch, get)
        r_cfg, t_cfg = RC.get_config(arch), TC.get_config(arch)
        assert t_cfg.layer_kinds() == r_cfg.layer_kinds()
        assert [c.name for c in TC.applicable_cells(t_cfg)] == \
            [c.name for c in RC.applicable_cells(r_cfg)]
    assert [dataclasses.asdict(c) for c in TC.SHAPE_CELLS] == \
        [dataclasses.asdict(c) for c in RC.SHAPE_CELLS]
    for name, pol in RPOL.POLICIES.items():
        assert dataclasses.asdict(TPOL.get_policy(name)) == \
            dataclasses.asdict(pol), name


def _shapes(tree):
    """The tree with every tensor replaced by its shape (axes names kept)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape) if torch.is_tensor(tree) else tree


def test_seeded_init_matches_reference_shapes(models):
    """The port's own init gives the layout ``params_from_reference``
    gives, at the reference's init scales (std 1/sqrt(fan_in))."""
    for arch in FAMILY_ARCHS:
        _, _, tc, tp = models(arch)
        own = init_params(0, tc, device="cpu")
        assert _shapes(own) == _shapes(tp), arch
    wide = dataclasses.replace(TC.get_tiny_config("qwen2-0.5b"),
                               d_model=512)
    w = init_params(0, wide, device="cpu")["layers"][0]["ffn"]["w_up"]
    w = w["w"]["w"]
    assert abs(float(w.std()) * np.sqrt(512) - 1.0) < 0.05


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.configs, repro_torch.models, "
            "repro_torch.serving, repro_torch.serving.study, "
            "repro_torch.core.policy, repro_torch.interop\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
