"""The port's serving stack (``repro_torch.serving``) against the JAX
package's on the CPU.

Tolerances: the quantizer, the KV codec and the storage accounting are
integer code, so words, exponents and byte counts are bit-identical;
``quant_matmul(backend="xla")`` is an f32 matmul in the library's own
order (1e-6 relative); ``backend="pallas"`` sums in f32 over K chunks of
32 in the port's order (its plain version here, the Hopper kernel on a
GPU) and is held, like the reference's interpret-mode Pallas call, to
the split3 bound sqrt(K) * 8e-8 of the exact product of the word values.
The engine's decode runs at f32: per-step logits within 1e-5 relative of
the reference engine's, fed the reference's tokens (teacher forcing).
"""
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posit_oracle as oracle
import torch_inputs as ti
import repro.configs as RC
import repro.serving as RS
from repro import obs as r_obs
from repro.models import init_params as r_init
from repro.models.common import Axes
from repro.serving import engine as r_engine
from repro.serving import kv_cache as r_kv
from repro.serving import quantize as r_q
from repro.serving import study as r_study

import repro_torch.configs as TC
import repro_torch.serving as TS
from repro_torch import obs as t_obs
from repro_torch.core import posit as t_posit
from repro_torch.core.formats import get_format as t_fmt
from repro_torch.interop import params_from_reference
from repro_torch.models import init_params
from repro_torch.serving import engine as t_engine
from repro_torch.serving import kv_cache as t_kv
from repro_torch.serving import quantize as t_q
from repro_torch.serving import study as t_study

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


# The reference's quantize_leaf, jitted for the tests that quantize whole
# models (quantize_params calls it leaf by leaf, ~10 eager ops a leaf):
# one program a leaf shape, the same words and exponents
# (test_quantize_leaf_bit_identical holds the port to the leaf itself).
_JIT_QUANTIZE_LEAF = jax.jit(r_q.quantize_leaf, static_argnames="qc")


@pytest.fixture
def jitted_reference_quantizer(monkeypatch):
    monkeypatch.setattr(r_q, "quantize_leaf", _JIT_QUANTIZE_LEAF)


FMTS = ("p32e2", "p16e1", "p8e2")
ENGINE_RTOL = 1e-5


def _rleaf(w):
    return {"w": jnp.asarray(w, jnp.float32), "axes": Axes((None,) * w.ndim)}


def _tleaf(w):
    return {"w": torch.from_numpy(np.asarray(w, np.float32)),
            "axes": (None,) * w.ndim}


def _weights(rng, shape):
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-6, 7, shape))).astype(np.float32)


@pytest.fixture(scope="module")
def qwen():
    """Tiny qwen2 at f32: (reference cfg, reference params, port cfg,
    port params carried over)."""
    rc = RC.get_tiny_config("qwen2-0.5b", policy="f32")
    rp = r_init(jax.random.PRNGKey(0), rc)
    tc = TC.get_tiny_config("qwen2-0.5b", policy="f32")
    tp = params_from_reference(jax.tree.map(np.asarray, rp), tc,
                               device="cpu")
    return rc, rp, tc, tp


# --------------------------------------------------------------------------
# quantizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("shape", [(12, 5), (3, 9, 7)])
def test_quantize_leaf_bit_identical(fmt, shape):
    """Words (wire dtype), exponents and dequantized values equal the
    reference's, on a 2-D leaf and a stacked 3-D one (per-layer scales);
    NaN and zero columns included."""
    rng = np.random.default_rng(3)
    w = _weights(rng, shape)
    w[..., 1, 2] = np.nan
    w[..., :, 3] = 0.0
    for per_channel in (True, False):
        qc_r = RS.QuantConfig(fmt=fmt, per_channel=per_channel)
        qc_t = TS.QuantConfig(fmt=fmt, per_channel=per_channel)
        rq = r_q.quantize_leaf(_rleaf(w), qc_r)
        tq = t_q.quantize_leaf(_tleaf(w), qc_t)
        assert tq["qw"].numpy().dtype == np.asarray(rq["qw"]).dtype
        assert np.array_equal(tq["qw"].numpy(), np.asarray(rq["qw"]))
        assert np.array_equal(tq["sexp"].numpy(), np.asarray(rq["sexp"]))
        assert tuple(tq["qmeta"]) == tuple(rq["qmeta"])
        deq = t_q.dequant_leaf(tq).numpy()
        rdeq = np.asarray(r_q.dequant_leaf(rq))
        assert np.array_equal(deq.view(np.int32), rdeq.view(np.int32))


def test_quantize_leaf_chunked_encode(monkeypatch):
    """The chunked encode (chunks of 7 elements here) gives the words of
    one whole-leaf encode."""
    rng = np.random.default_rng(15)
    leaf = _tleaf(_weights(rng, (3, 9, 7)))
    whole = t_q.quantize_leaf(leaf, TS.QuantConfig())
    monkeypatch.setattr(t_q, "_ENCODE_CHUNK", 7)
    assert torch.equal(t_q.quantize_leaf(leaf, TS.QuantConfig())["qw"],
                       whole["qw"])


@pytest.mark.parametrize("fmt", FMTS)
def test_words_match_oracle(fmt):
    """Every packed word is the rational oracle's nearest-even encode of
    the equilibrated weight."""
    f = t_fmt(fmt)
    rng = np.random.default_rng(4)
    w = _weights(rng, (10, 4))
    ql = t_q.quantize_leaf(_tleaf(w), TS.QuantConfig(fmt=fmt))
    words, sexp = ql["qw"].numpy().astype(np.int64), ql["sexp"].numpy()
    for i in range(w.shape[0]):
        for j in range(w.shape[1]):
            scaled = Fraction(float(w[i, j])) / Fraction(2) ** int(sexp[j])
            assert int(words[i, j]) == oracle.encode(scaled, f.nbits, f.es)


@pytest.mark.parametrize("fmt", FMTS)
def test_decode_words_table_equals_decode(fmt):
    """The table lookup decode gives ``to_float32_bits``'s values for
    every word (every pattern of the <= 16-bit formats)."""
    f = t_fmt(fmt)
    words = torch.from_numpy(ti.words(f, np.random.default_rng(5), 1 << 16))
    got = t_q.decode_words(words.to(t_q.wire_dtype(f)), fmt)
    want = t_posit.to_float32_bits(words, f)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)) or \
        bool(((got == want) | (got.isnan() & want.isnan())).all())


def test_encode_kernel_plain_equals_from_float32_bits():
    """The activation and K/V encode (``encode_posit_f32``: the kernel on
    a GPU, this plain version on the CPU) is the reference's
    ``from_float32_bits`` rounding, bit for bit, over random f32 bit
    patterns and the f32 corner set, in every format."""
    from repro_torch.kernels import posit_gemm as pg
    rng = np.random.default_rng(14)
    bits = rng.integers(0, 2**32, 1 << 18, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(np.concatenate([bits.view(np.float32),
                                         ti.f32_corners(20000)]))
    for name in ("p32e2", "p16e1", "p8e2", "p8e0"):
        f = t_fmt(name)
        assert torch.equal(pg.encode_posit_f32_plain(x, f),
                           t_posit.from_float32_bits(x, f)), name


def test_nar_refusal_and_saturation():
    wn = np.ones((4, 4), np.float32)
    wn[1, 2] = np.nan
    with pytest.raises(ValueError, match="NaR"):
        TS.quantize_params({"lin": {"w": _tleaf(wn)}})
    qp = TS.quantize_params({"lin": {"w": _tleaf(wn)}}, allow_nar=True)
    rq = RS.quantize_params({"lin": {"w": _rleaf(wn)}}, allow_nar=True)
    assert np.array_equal(qp["lin"]["w"]["qw"].numpy(),
                          np.asarray(rq["lin"]["w"]["qw"]))
    nar = t_posit.is_nar(qp["lin"]["w"]["qw"], t_fmt("p16e1")).numpy()
    assert nar.sum() == 1 and nar[1, 2]
    # an infinite weight is NaR; its channel's scale is 2^126, exact in
    # the port (the reference's exp2(-126) is 0 on the CPU)
    wi = np.ones((3, 2), np.float32)
    wi[0, 1] = np.inf
    qi = t_q.quantize_leaf(_tleaf(wi), TS.QuantConfig())
    assert qi["sexp"].tolist() == [0, 126]
    assert qi["qw"][0, 1] == t_fmt("p16e1").nar_pattern
    assert (qi["qw"][1:, 1] == 1).all()               # minpos, never zero
    big = np.full((2, 3), 1e30, np.float32)
    qc = TS.QuantConfig(fmt="p8e2", per_channel=False)
    qb = t_q.quantize_leaf(_tleaf(big), qc)
    assert np.isfinite(t_q.dequant_leaf(qb).numpy()).all()
    assert (qb["qw"].numpy() == t_fmt("p8e2").maxpos_pattern).all()


@pytest.mark.usefixtures("jitted_reference_quantizer")
def test_param_bytes_and_golden_zone_equal_reference(qwen):
    rc, rp, tc, tp = qwen
    for fmt in ("p16e1", "p8e2"):
        rq = RS.quantize_params(rp, RS.QuantConfig(fmt=fmt))
        tq = TS.quantize_params(tp, TS.QuantConfig(fmt=fmt))
        assert TS.param_bytes(tq) == RS.param_bytes(rq), fmt
        assert TS.weight_golden_zone(tq) == pytest.approx(
            RS.weight_golden_zone(rq), rel=1e-12)
    pb = TS.param_bytes(TS.quantize_params(tp, TS.QuantConfig("p16e1")))
    assert pb["q_f32_bytes"] / pb["word_bytes"] == 2.0
    back = TS.dequantize_params(TS.quantize_params(tp))
    assert back["layers"][0]["attn"]["wq"]["w"]["w"].dtype == torch.float32


def _matmul_case(rng, m, d_in, d_out, fmt, backend):
    w = (rng.standard_normal((d_in, d_out)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, d_in)).astype(np.float32)
    rq = r_q.quantize_leaf(_rleaf(w), RS.QuantConfig(fmt=fmt,
                                                     backend=backend))
    tq = t_q.quantize_leaf(_tleaf(w), TS.QuantConfig(fmt=fmt,
                                                     backend=backend))
    ref = np.asarray(r_q.quant_matmul(jnp.asarray(x), rq))
    out = t_q.quant_matmul(torch.from_numpy(x), tq)
    return x, tq, ref, out


@pytest.mark.parametrize("shape", [(6, 40, 24), (3, 64, 96)])
def test_quant_matmul_xla_matches_reference(shape):
    rng = np.random.default_rng(6)
    _, _, ref, out = _matmul_case(rng, *shape, "p16e1", "xla")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", ["p16e1", "p8e2"])
@pytest.mark.parametrize("shape", [(6, 40, 24), (5, 96, 33)])
def test_quant_matmul_pallas_within_split3_bound(fmt, shape):
    """The port's ``pallas`` backend (plain split3, bk=32 on the CPU) and
    the reference's (Pallas, interpret mode) both lie within
    sqrt(K)*8e-8 of the exact product of the activation and weight
    words; and within 1e-3 of the ``xla`` backend (the reference's
    bar)."""
    rng = np.random.default_rng(7)
    x, tq, ref, out = _matmul_case(rng, *shape, fmt, "pallas")
    f = t_fmt(fmt)
    av = t_posit.to_float64(t_posit.from_float32_bits(torch.from_numpy(x),
                                                      f), f)
    bv = t_q.dequant_leaf(tq).double()
    bound = np.sqrt(shape[1]) * 8e-8
    assert ti.gemm_rel_err(out, av, bv) < bound
    assert ti.gemm_rel_err(torch.from_numpy(np.array(ref)), av, bv) < bound
    yx = t_q.quant_matmul(torch.from_numpy(x), {**tq, "qmeta": (fmt, "xla")})
    assert float(torch.linalg.norm(yx - out) / torch.linalg.norm(yx)) < (
        1e-3 if fmt == "p16e1" else 5e-2)


def test_quant_matmul_reaches_kernel_through_ops(monkeypatch):
    """The ``pallas`` backend calls its GEMMs through ``kernels.ops``, the
    attributes chip_smoke's recorder patches, at bk=32: the skinny kernel
    (``quant_gemm_f32``) up to ``SKINNY_M_MAX`` rows, the tiled one
    (``posit_gemm_f32``, split3) above."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_gemm as pg
    seen = []
    real_q, real_t = ops.quant_gemm_f32, ops.posit_gemm_f32

    def spy_q(x, words, sexp, fmt, **kw):
        seen.append((tuple(x.shape), tuple(words.shape), kw["bk"]))
        return real_q(x, words, sexp, fmt, **kw)

    def spy_t(a, b, **kw):
        seen.append((tuple(a.shape), tuple(b.shape), kw["bk"], kw["mode"]))
        return real_t(a, b, **kw)
    monkeypatch.setattr(ops, "quant_gemm_f32", spy_q)
    monkeypatch.setattr(ops, "posit_gemm_f32", spy_t)
    w = np.random.default_rng(8).standard_normal((40, 24)).astype(np.float32)
    tq = t_q.quantize_leaf(_tleaf(w), TS.QuantConfig(backend="pallas"))
    t_q.quant_matmul(torch.ones((2, 3, 40)), tq)
    monkeypatch.setattr(pg, "SKINNY_M_MAX", 5)
    t_q.quant_matmul(torch.ones((2, 3, 40)), tq)
    assert seen == [((6, 40), (40, 24), 32),
                    ((6, 40), (40, 24), 32, "split3")]


@pytest.mark.usefixtures("jitted_reference_quantizer")
def test_quantized_prefill_matches_reference():
    """Quantized forward through every leaf kind the quantizer touches
    (embedding table, linears, MoE experts, conv kernels), xla backend."""
    from repro.models import forward_prefill as r_prefill
    from repro_torch.models import forward_prefill
    rf = jax.jit(r_prefill, static_argnames="cfg")
    for arch in ("granite-moe-1b-a400m", "mamba2-780m"):
        rc = RC.get_tiny_config(arch, policy="f32")
        tc = TC.get_tiny_config(arch, policy="f32")
        rp = RS.quantize_params(r_init(jax.random.PRNGKey(0), rc))
        tp = params_from_reference(jax.tree.map(np.asarray, rp), tc,
                                   device="cpu")
        toks = np.random.default_rng(9).integers(0, rc.vocab, (2, 8))
        ref = np.asarray(rf(rp, {"tokens": jnp.asarray(toks)}, cfg=rc))
        out = forward_prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
        rel = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
        assert rel < 1e-5, arch


# --------------------------------------------------------------------------
# paged KV
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["p16e1", "p8e2", None])
def test_encode_kv_bit_identical(fmt):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    got = t_kv.encode_kv(torch.from_numpy(x), fmt).numpy()
    want = np.asarray(r_kv.encode_kv(jnp.asarray(x), fmt))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    back = t_kv.decode_kv(torch.from_numpy(got), fmt).numpy()
    assert np.array_equal(back, np.asarray(r_kv.decode_kv(want, fmt)))


def test_gather_and_scatter_match_reference():
    """Linear indices of a block table with unallocated (-1 -> page 0)
    pages, and a scatter whose inactive rows share one out-of-bounds
    index: dropped, never clamped onto a page."""
    bt = np.array([[3, 1, -1], [-1, -1, -1], [2, -1, -1]], np.int32)
    got = t_kv.gather_linear_indices(bt, 4).numpy()
    want = np.asarray(r_kv.gather_linear_indices(jnp.asarray(bt), 4))
    assert np.array_equal(got, want)
    rng = np.random.default_rng(11)
    pool = rng.standard_normal((16, 2, 4)).astype(np.float32)
    t_pool = t_kv.encode_kv(torch.from_numpy(pool), "p16e1")
    r_pool = r_kv.encode_kv(jnp.asarray(pool), "p16e1")
    rows = rng.standard_normal((4, 2, 4)).astype(np.float32)
    idx = np.array([5, 16, 9, 16], np.int32)          # 16 = out of bounds
    got = t_kv.scatter_rows(t_pool, torch.from_numpy(idx),
                            torch.from_numpy(rows), "p16e1")
    want = r_kv.scatter_rows(r_pool[None], jnp.asarray(idx),
                             jnp.asarray(rows)[None], "p16e1")[0]
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[15], t_pool.numpy()[15])
    dense = t_kv.gather_dense(got, torch.arange(16)[None, :], "p16e1")
    assert torch.equal(dense[0], t_kv.decode_kv(got, "p16e1"))


def test_page_pool_allocator():
    cfg = TC.get_tiny_config("qwen2-0.5b", policy="f32")
    spec = TS.PagedKVSpec(page_size=4, n_pages=9, max_batch=2, max_pages=4,
                          fmt="p16e1")
    pool = TS.PagePool(cfg, spec, device="cpu")
    ref = RS.PagePool(RC.get_tiny_config("qwen2-0.5b", policy="f32"),
                      RS.PagedKVSpec(page_size=4, n_pages=9, max_batch=2,
                                     max_pages=4, fmt="p16e1"))
    assert pool.bytes() == ref.bytes()
    assert len(pool.free) == 8                  # page 0 reserved
    pool.alloc_row(0, 3)
    ref.alloc_row(0, 3)
    assert np.array_equal(pool.block_table, ref.block_table)
    assert pool.pages_in_use() == 3 and not pool.can_alloc(6)
    li = [pool.linear_index(0, t) for t in range(16)]
    assert li == [ref.linear_index(0, t) for t in range(16)]
    assert li[1] == li[0] + 1 and li[12] == spec.n_pages * spec.page_size
    pool.free_row(0)
    assert pool.pages_in_use() == 0 and len(pool.free) == 8
    with pytest.raises(ValueError):
        pool.alloc_row(0, 9)
    pool.alloc_row(1, 4)
    pool.alloc_row(0, 4)
    with pytest.raises(RuntimeError):
        pool.alloc_row(0, 1)
    for arch in ("gemma3-12b", "zamba2-2.7b", "whisper-tiny"):
        tc, rc = TC.get_tiny_config(arch), RC.get_tiny_config(arch)
        assert t_kv.kv_slot_indices(tc) == r_kv.kv_slot_indices(rc)
        assert t_kv.kv_layer_indices(tc) == [
            i for i, k in enumerate(rc.layer_kinds())
            if k in ("attn", "local")]


# --------------------------------------------------------------------------
# prefill and the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m"])
def test_prefill_equals_prefill_loop(arch):
    """The port's ``prefill`` against the reference's per-token
    ``prefill_loop`` from the same weights: the same next position and
    token, and a decode step from either cache gives logits within 1e-5
    relative (the caches are bf16 in both packages)."""
    from repro.models import serve_step as r_serve_step
    from repro_torch.models import serve_step
    rc = RC.get_tiny_config(arch, policy="f32")
    tc = TC.get_tiny_config(arch, policy="f32")
    rp = r_init(jax.random.PRNGKey(0), rc)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), tc,
                               device="cpu")
    toks = np.random.default_rng(12).integers(0, rc.vocab, (2, 7))
    rcache, rtok, rpos = r_engine.prefill_loop(rp, rc, toks, 32)
    tcache, ttok, tpos = TS.prefill(tp, tc, toks, 32)
    assert tpos == rpos == 7
    assert np.array_equal(ttok.numpy(), np.asarray(rtok))
    rl, _ = jax.jit(r_serve_step, static_argnames="cfg")(
        rp, rcache, rtok, jnp.int32(rpos), cfg=rc)
    tl, _ = serve_step(tp, tcache, ttok, tpos, tc)
    rl = np.asarray(rl, np.float64)
    assert np.linalg.norm(tl.numpy() - rl) / np.linalg.norm(rl) < \
        ENGINE_RTOL
    assert TS.prefill_loop is TS.prefill


def _requests(vocab, n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [TS.Request(rid=i, prompt=rng.integers(0, vocab, (4 + 3 * i,))
                       .astype(np.int32), max_new=5 + i) for i in range(n)]


def _run(params, cfg, reqs, *, max_inflight, kv_fmt, max_batch=3):
    eng = TS.Engine(params, cfg, max_batch=max_batch, page_size=8,
                    max_seq=64, kv_fmt=kv_fmt, max_inflight=max_inflight)
    return eng.run([dataclasses.replace(r) for r in reqs]), eng


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m"])
@pytest.mark.parametrize("kv_fmt", [None, "p16e1"])
def test_engine_batched_bit_identical_to_sequential(arch, kv_fmt):
    """Continuous-batched decode over paged posit KV gives the tokens of
    one-request-at-a-time decode through the same engine, bit for bit
    (p16e1 weights with the p16e1 pool)."""
    cfg = TC.get_tiny_config(arch, policy="f32")
    params = init_params(0, cfg, device="cpu")
    if kv_fmt is not None:
        params = TS.quantize_params(params, TS.QuantConfig(fmt="p16e1"))
    reqs = _requests(cfg.vocab)
    batched, eng = _run(params, cfg, reqs, max_inflight=3, kv_fmt=kv_fmt)
    seq, _ = _run(params, cfg, reqs, max_inflight=1, kv_fmt=kv_fmt)
    assert set(batched) == set(seq) == {0, 1, 2, 3}
    for rid in batched:
        assert np.array_equal(batched[rid], seq[rid]), rid
    assert eng.pool.pages_in_use() == 0
    if kv_fmt:
        kb = eng.kv_bytes()
        assert kb["f32_bytes"] == 2 * kb["bytes"]


def test_engine_matches_generate():
    """With f32 weights and KV and a cache that never wraps, the engine's
    tokens are the dense-cache greedy decode's."""
    cfg = TC.get_tiny_config("qwen2-0.5b", policy="f32")
    params = init_params(0, cfg, device="cpu")
    prompt = np.random.default_rng(13).integers(0, cfg.vocab, (1, 6))
    out, eng = _run(params, cfg, [TS.Request(rid=0, prompt=prompt[0],
                                             max_new=8)],
                    max_inflight=1, kv_fmt=None)
    ref = TS.generate(params, cfg, prompt, max_new=8,
                      cache_len=eng.spec.s_gather)
    assert np.array_equal(out[0], ref[0])


def test_engine_page_pressure_queues_and_drains():
    cfg = TC.get_tiny_config("qwen2-0.5b", policy="f32")
    params = init_params(0, cfg, device="cpu")
    eng = TS.Engine(params, cfg, max_batch=2, page_size=8, max_seq=32,
                    n_pages=5, kv_fmt="p16e1")
    rng = np.random.default_rng(9)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab, (6,))
                       .astype(np.int32), max_new=4) for i in range(5)]
    out = eng.run(reqs)
    assert set(out) == set(range(5))
    assert all(len(v) == 4 for v in out.values())
    assert eng.pool.pages_in_use() == 0


def test_engine_eos_rule():
    """A request stops at the first generated ``eos_id`` and keeps it as
    its last token (the engine's rule), else after max_new."""
    cfg = TC.get_tiny_config("qwen2-0.5b", policy="f32")
    params = init_params(0, cfg, device="cpu")
    prompt = np.arange(4, dtype=np.int32)
    base = TS.Engine(params, cfg, max_batch=2, page_size=8, max_seq=64).run(
        [TS.Request(rid=0, prompt=prompt, max_new=8)])[0]
    for eos in set(base.tolist()):
        out = TS.Engine(params, cfg, max_batch=2, page_size=8,
                        max_seq=64).run(
            [TS.Request(rid=0, prompt=prompt, max_new=8, eos_id=eos)])[0]
        stop = base.tolist().index(eos)
        assert out.tolist() == base[:stop + 1].tolist(), eos
    absent = next(t for t in range(cfg.vocab) if t not in base)
    out = TS.Engine(params, cfg, max_batch=2, page_size=8, max_seq=64).run(
        [TS.Request(rid=0, prompt=prompt, max_new=8, eos_id=absent)])[0]
    assert np.array_equal(out, base)


class _Recorder:
    """Wraps an engine module's ``_prefill_scan`` and ``_engine_step``:
    keeps each call's outputs (``force`` given: replaces the predicted
    tokens with the forced ones, call by call)."""

    def __init__(self, mod, monkeypatch, to_np, force=None):
        def forced(like, arr):
            return torch.as_tensor(np.array(arr)).to(like)
        self.prefill, self.steps = [], []
        real_prefill, real_step = mod._prefill_scan, mod._engine_step

        def prefill(*a, **kw):
            cache, last = real_prefill(*a, **kw)
            self.prefill.append(to_np(last))
            if force is not None:
                last = forced(last, force.prefill[len(self.prefill) - 1])
            return cache, last

        def step(*a, **kw):
            nxt, logits, pools, state = real_step(*a, **kw)
            self.steps.append((to_np(nxt), to_np(logits)))
            if force is not None:
                nxt = forced(nxt, force.steps[len(self.steps) - 1][0])
            return nxt, logits, pools, state
        monkeypatch.setattr(mod, "_prefill_scan", prefill)
        monkeypatch.setattr(mod, "_engine_step", step)


def test_engine_matches_reference_engine(qwen, monkeypatch):
    """Tiny qwen2 through both engines on one trace: the port fed the
    reference's tokens (teacher forcing) gives each step's logits within
    1e-5 relative, its own greedy token equals the reference's wherever
    the reference's top-2 margin exceeds ten times that, and the
    ``serve.*`` counters and gauges are the reference's."""
    rc, rp, tc, tp = qwen
    trace = TS.synth_trace(TS.TrafficConfig(
        n_requests=5, mean_plen=6, mean_new=5, vocab=rc.vocab, seed=1))
    r_trace = RS.synth_trace(RS.TrafficConfig(
        n_requests=5, mean_plen=6, mean_new=5, vocab=rc.vocab, seed=1))
    assert [(r.arrival, r.max_new, r.prompt.tolist()) for r in trace] == \
        [(r.arrival, r.max_new, r.prompt.tolist()) for r in r_trace]
    ref = _Recorder(r_engine, monkeypatch, np.asarray)
    with r_obs.scoped() as rm:
        r_rep = RS.replay(RS.Engine(rp, rc, max_batch=3, page_size=8,
                                    max_seq=64), r_trace)
    port = _Recorder(t_engine, monkeypatch,
                     lambda t: t.detach().cpu().numpy(), force=ref)
    t_engine_obj = TS.Engine(tp, tc, max_batch=3, page_size=8, max_seq=64)
    with t_obs.scoped() as tm:
        t_rep = TS.replay(t_engine_obj, trace)
    assert len(port.steps) == len(ref.steps) > 0
    assert len(port.prefill) == len(ref.prefill) == 5
    checked = 0
    for (t_nxt, t_log), (r_nxt, r_log) in zip(port.steps, ref.steps):
        rel = np.linalg.norm(t_log - r_log) / np.linalg.norm(r_log)
        assert rel < ENGINE_RTOL
        top2 = np.sort(r_log, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 10 * ENGINE_RTOL * np.abs(
            r_log).max()
        assert np.array_equal(t_nxt[sure], r_nxt[sure])
        checked += int(sure.sum())
    assert checked >= len(ref.steps)
    for rid, toks in r_rep["outputs"].items():
        assert np.array_equal(t_rep["outputs"][rid], toks)
    assert (t_rep["steps"], t_rep["tokens"], t_rep["requests"]) == \
        (r_rep["steps"], r_rep["tokens"], r_rep["requests"])
    t_d, r_d = tm.to_dict(), rm.to_dict()
    assert t_d["counters"] == r_d["counters"]
    assert t_d["gauges"] == r_d["gauges"]
    assert set(t_d["counters"]) == {"serve.steps", "serve.tokens"}
    assert t_d["counters"]["serve.tokens"] == t_rep["tokens"]
    assert t_d["counters"]["serve.steps"] == t_rep["steps"]


@pytest.mark.usefixtures("jitted_reference_quantizer")
def test_quant_study_rows_match_reference(qwen):
    """``arch_rows`` on the reference's params and tokens gives the
    reference study's rows (logit errors within 1e-5 of each other, KL
    within 1e-6, top-1 and golden-zone occupancy equal)."""
    rc, rp, tc, tp = qwen
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                       rc.vocab))
    ref = r_study.quant_study(("qwen2-0.5b",), ("p16e1",))
    rows = t_study.arch_rows(tc, tp, torch.from_numpy(toks), ("p16e1",))
    assert [(r["arch"], r["fmt"], r["equilibrated"]) for r in rows] == \
        [(r["arch"], r["fmt"], r["equilibrated"]) for r in ref]
    for t, r in zip(rows, ref):
        # each side's logits carry the f32 forward's order noise (< 1e-5
        # relative, test_torch_models); KL cancels to ~1e-5 from
        # log-probabilities of magnitude ~5, each with f32 noise of a few
        # 1e-7
        assert t["rel_err"] == pytest.approx(r["rel_err"], abs=1e-5)
        assert t["kl"] == pytest.approx(r["kl"], abs=1e-6)
        assert t["top1"] == r["top1"]
        assert t["gz"] == (None if r["gz"] is None
                           else pytest.approx(r["gz"], rel=1e-12))
    assert t_study.study_table(rows).count("\n") == len(rows) + 1
