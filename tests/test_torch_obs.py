"""The port's observability layer (repro_torch.obs) and its hooks, against
the JAX package's, on the same numpy-made words.

The contract, in order:

1. **Free when disabled**: with no collector open the hooked entry points
   call no function of ``obs.numerics`` (a spy on every one of them) and
   give the words they give with a collector open.
2. **The reference's record when enabled**: under a collector the port's
   ``to_dict()`` equals the reference's on the same inputs — the same
   counter, gauge, histogram and series keys with the same values, the
   same number of spans (their times excluded).  ``digits_gained`` is
   log10 of a ratio, which XLA and the port's math library may round an
   ulp apart: it is held to a relative 1e-12, every other value exactly.
   A call the reference makes inside a jitted or vmapped program records
   nothing in either package (``rgels``, a batch).
3. The word telemetry (``collect_numerics``, ``encode_round_stats``,
   ``quire_carry_stats``) equals the reference's on every p8e2 and p16e1
   word and sampled p32e2 words, and the oracle's bit-level parse
   (tests/posit_oracle.py).
4. Collectors nest, spans nest and round-trip as Chrome trace JSON.

Every driver runs once against the reference at one shape (n = 32,
nb = 16; QR (32, 16)) with the ``faithful`` GEMM, whose words both
packages give bit for bit.
"""
import json
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posit_oracle
import torch_inputs as ti
from repro import obs as JO
from repro.core import formats as JF
from repro.kernels import ops as JK
from repro.lapack import decomp as JD
from repro.lapack import error_eval as JE
from repro.lapack import qr as JQ
from repro.lapack import refine as JR
from repro.quire import quire_gemm_limbs as j_quire_gemm_limbs
from repro_torch import obs as TO
from repro_torch.core import posit as TP
from repro_torch.core.formats import P8E2, P16E1, P32E2
from repro_torch.ft import abft as TA
from repro_torch.kernels import ops as TK
from repro_torch.lapack import decomp as TD
from repro_torch.lapack import error_eval as TE
from repro_torch.lapack import qr as TQ
from repro_torch.lapack import refine as TR
from repro_torch.obs import metrics as TM
from repro_torch.obs import numerics as TN
from repro_torch.quire import quire_gemm_limbs

N, NB = 32, 16
BACKEND = "faithful"


def _words(x, fmt=P32E2):
    return TP.from_float64(torch.from_numpy(np.asarray(x, np.float64)),
                           fmt).numpy()


def _inputs():
    rng = np.random.default_rng(1)
    a64 = rng.standard_normal((N, N))
    return dict(a=_words(a64), spd=_words(a64.T @ a64 + N * np.eye(N)),
                b=_words(rng.standard_normal(N)),
                b2=_words(rng.standard_normal((N, 2))),
                rect=_words(rng.standard_normal((N, N // 2))),
                # a batch of two one-panel systems (the reference compiles
                # the whole vmapped driver: its cost grows with n)
                batch=np.stack([_words(a64[:NB, :NB]),
                                _words(a64[NB:, NB:])]),
                bbatch=_words(rng.standard_normal((2, NB))))


# The drivers of the contract, one call each, as (port, reference) runs on
# numpy words; each returns its words as a tuple of arrays.
def _flat(out):
    if isinstance(out, (tuple, list)):
        return tuple(x for o in out for x in _flat(o))
    return (np.asarray(out),)


CASES = {
    "rgemm": lambda m, x: m["K"].rgemm(x["a"], x["spd"], backend=BACKEND),
    "rgemm_trans_beta": lambda m, x: m["K"].rgemm(
        x["a"], x["a"], x["spd"], alpha=-1.0, beta=1.0, trans_b=True,
        backend=BACKEND),
    "rgetrf": lambda m, x: m["D"].rgetrf(x["a"], nb=NB,
                                         gemm_backend=BACKEND),
    "rpotrf": lambda m, x: m["D"].rpotrf(x["spd"], nb=NB,
                                         gemm_backend=BACKEND),
    "rgeqrf": lambda m, x: m["Q"].rgeqrf(x["rect"], nb=NB,
                                         gemm_backend=BACKEND),
    "rgetrf_loop": lambda m, x: m["D"].rgetrf_loop(x["a"], nb=NB,
                                                   gemm_backend=BACKEND),
    "rgeqrf_loop": lambda m, x: m["Q"].rgeqrf_loop(x["rect"], nb=NB,
                                                   gemm_backend=BACKEND),
    "rgesv_ir": lambda m, x: m["R"].rgesv_ir(x["a"], x["b2"], iters=2, nb=NB,
                                             gemm_backend=BACKEND),
    "rposv_ir_vector": lambda m, x: m["R"].rposv_ir(
        x["spd"], x["b"], iters=2, nb=NB, gemm_backend=BACKEND),
    "rgels": lambda m, x: m["Q"].rgels(x["rect"], x["b"], nb=NB,
                                       gemm_backend=BACKEND),
    "rgesv_ir_batched": lambda m, x: m["R"].rgesv_ir(
        x["batch"], x["bbatch"], iters=1, nb=NB, gemm_backend=BACKEND),
}


def _port(name, x):
    mods = dict(K=TK, D=TD, Q=TQ, R=TR)
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    return _flat(CASES[name](mods, xt))


def _reference(name, x):
    mods = dict(K=JK, D=JD, Q=JQ, R=JR)
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    return _flat(CASES[name](mods, xj))


def _same_record(got: dict, want: dict):
    mismatch = ti.record_mismatch(got, want)
    assert mismatch is None, mismatch


# --------------------------------------------------------------------------
# 1-2. free when disabled; the reference's record when enabled
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.mark.parametrize("name", list(CASES))
def test_record_equals_reference(name, inputs):
    """Under a collector: the words of the unobserved call, and the whole
    record of the reference's (nothing at all for ``rgels`` and the
    batched driver, which the reference runs jitted / vmapped)."""
    plain = _port(name, inputs)
    with TO.scoped() as mt:
        observed = _port(name, inputs)
    with JO.scoped() as mj:
        want = _reference(name, inputs)
    assert all(np.array_equal(p, o) for p, o in zip(plain, observed))
    assert all(np.array_equal(p, w) for p, w in zip(plain, want))
    got, ref = mt.to_dict(), mj.to_dict()
    _same_record(got, ref)
    if name in ("rgels", "rgesv_ir_batched"):
        assert got == {"counters": {}, "gauges": {}, "hists": {},
                       "series": {}, "spans": 0}
    assert json.loads(mt.to_json()) is not None


def test_disabled_hooks_call_no_numerics(inputs, monkeypatch):
    """With no collector open, no function of ``obs.numerics`` runs
    (every one replaced by a spy), on every observed entry point, the
    protected drivers and the guarded ladder."""
    calls = []
    for name in dir(TN):
        fn = getattr(TN, name)
        if callable(fn) and getattr(fn, "__module__", "") == TN.__name__:
            def spy(*a, _name=name, _fn=fn, **kw):
                calls.append(_name)
                return _fn(*a, **kw)
            monkeypatch.setattr(TN, name, spy)
    assert not TO.enabled()
    for name in CASES:
        _port(name, inputs)
    a = torch.from_numpy(inputs["a"])
    TD.rgetrf_ft(a, nb=NB, gemm_backend=BACKEND)
    TQ.rgeqrf_ft(torch.from_numpy(inputs["rect"]), nb=NB,
                 gemm_backend=BACKEND)
    TQ.rgels_ir(torch.from_numpy(inputs["rect"]),
                torch.from_numpy(inputs["b"]), iters=1, nb=NB,
                gemm_backend=BACKEND)
    TR.rgesv_guarded(a, torch.from_numpy(inputs["b"]), nb=NB)
    assert calls == []
    assert TO.active(a) is False


def test_ir_sweep_series(inputs):
    """One row a sweep, contracting, the digits of the reference's bar."""
    rng = np.random.default_rng(5)
    n = 40
    a = _words(rng.standard_normal((n, n)) + n * np.eye(n))
    b = _words(rng.standard_normal(n))
    with TO.scoped() as m:
        TR.rgesv_ir(torch.from_numpy(a), torch.from_numpy(b), iters=3,
                    nb=NB)
    rows = m.to_dict()["series"]["ir.sweep"]
    assert [r["sweep"] for r in rows] == [0, 1, 2]
    assert rows[-1]["r_norm"] < rows[0]["r_norm"]
    assert rows[-1]["digits_gained"] > 2
    assert all(isinstance(r["limb_carries"], int) for r in rows)
    assert m.to_dict()["counters"]["ir.sweeps"] == 3.0


def test_golden_zone_study_equals_reference():
    """n=32 over three sigmas, faithful: occupancy, e_plain, e_ir and the
    sweep rows equal; e_binary32 comes from two library LAPACKs in f32
    (0.12 digits apart at sigma=1e2 here), held within 0.5 digits as in
    tests/test_torch_lstsq_study.py; the table prints one row a cell."""
    sigmas = (1e-2, 1.0, 1e2)
    got = TE.golden_zone_study(N, sigmas, "lu", nb=NB, iters=2,
                               gemm_backend=BACKEND, device="cpu")
    want = JE.golden_zone_study(N, sigmas, "lu", nb=NB, iters=2,
                                gemm_backend=BACKEND)
    for g, w in zip(got, want):
        assert (g.occupancy, g.e_plain, g.e_ir) == (w.occupancy, w.e_plain,
                                                     w.e_ir)
        assert abs(np.log10(g.e_binary32 / w.e_binary32)) < 0.5
        _same_record({"counters": {}, "gauges": {}, "hists": {}, "spans": 0,
                      "series": {"ir.sweep": g.sweeps}},
                     {"counters": {}, "gauges": {}, "hists": {}, "spans": 0,
                      "series": {"ir.sweep": w.sweeps}})
    table = TE.golden_zone_table(got)
    assert table.count("\n| ") == len(sigmas)
    assert "occupancy/digits correlation" in table


# --------------------------------------------------------------------------
# 3. word telemetry vs the reference and the oracle
# --------------------------------------------------------------------------

def _oracle_word_stats(pattern: int, nbits: int, es: int):
    """(is_zero, is_nar, reg_len, scale, golden) by bit parsing and exact
    Fractions, sharing no code with either package."""
    mask = (1 << nbits) - 1
    p = pattern & mask
    if p == 0:
        return True, False, 0, 0, False
    if p == 1 << (nbits - 1):
        return False, True, 0, 0, False
    if p >> (nbits - 1):
        p = (-p) & mask
    bits = [(p >> i) & 1 for i in range(nbits - 2, -1, -1)]
    m = 1
    while m < len(bits) and bits[m] == bits[0]:
        m += 1
    k = (m - 1) if bits[0] == 1 else -m
    reg_len = min(m + 1, nbits - 1)
    val = abs(posit_oracle.decode(pattern, nbits, es))
    scale = math.floor(math.log2(val))           # significand in [1, 2)
    while Fraction(2) ** scale > val:            # exact floor(log2)
        scale -= 1
    while Fraction(2) ** (scale + 1) <= val:
        scale += 1
    golden = Fraction(2) ** -(1 << es) <= val < Fraction(2) ** (1 << es)
    assert golden == (k in (0, -1))
    return False, False, reg_len, scale, golden


def _format_words(fmt):
    rng = np.random.default_rng(7)
    return ti.words(fmt, rng, 4096)


@pytest.mark.parametrize("fmt", [P32E2, P16E1, P8E2], ids=lambda f: f.name)
def test_collect_numerics_vs_reference_and_oracle(fmt):
    words = _format_words(fmt)
    got = TO.collect_numerics(torch.from_numpy(words), fmt)
    want = JO.collect_numerics(jnp.asarray(words), JF.get_format(fmt.name))
    for key, w in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key
        assert got[key].dtype == torch.from_numpy(np.array(w)).dtype, key
    # the oracle on every word of p8e2 and a spread sample of the others
    sample = words if fmt.nbits <= 8 else words[::16]
    st = TO.collect_numerics(torch.from_numpy(sample), fmt)
    reg, scl = {}, {}
    nz = nnar = ngold = nfin = 0
    for w in sample.tolist():
        z, nar, reg_len, scale, golden = _oracle_word_stats(w, fmt.nbits,
                                                             fmt.es)
        nz += z
        nnar += nar
        if z or nar:
            continue
        nfin += 1
        ngold += golden
        reg[reg_len] = reg.get(reg_len, 0) + 1
        scl[scale] = scl.get(scale, 0) + 1
    assert (int(st["zero"]), int(st["nar"])) == (nz, nnar)
    assert {i: v for i, v in enumerate(st["regime_hist"].tolist())
            if v} == reg
    assert {i - fmt.max_scale: v for i, v in
            enumerate(st["scale_hist"].tolist()) if v} == scl
    assert float(st["golden_frac"]) == ngold / max(nfin, 1)


@pytest.mark.parametrize("fmt", [P32E2, P16E1, P8E2], ids=lambda f: f.name)
def test_encode_round_stats_vs_reference(fmt):
    """Every word's own value (never rounded), values over a wide scale
    range and the specials (subnormals included)."""
    words = torch.from_numpy(_format_words(fmt))
    x = np.concatenate([TP.to_float64(words, fmt).numpy(),
                        ti.values(np.random.default_rng(8), 20000)])
    got = TO.encode_round_stats(torch.from_numpy(x), fmt)
    want = JO.encode_round_stats(jnp.asarray(x), JF.get_format(fmt.name))
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()}
    exact = TO.encode_round_stats(TP.to_float64(words, fmt), fmt)
    assert int(exact["rounded"]) == int(exact["sticky"]) == 0


def test_encode_round_stats_cases():
    st = TO.encode_round_stats(torch.tensor([1.0, 1.5, -2.25, 0.0]), P32E2)
    assert (int(st["total"]), int(st["rounded"]), int(st["saturated"])) \
        == (3, 0, 0)
    st = TO.encode_round_stats(torch.tensor([1 / 3, 1e300, 1e-300],
                                            dtype=torch.float64), P32E2)
    assert (int(st["rounded"]), int(st["saturated"])) == (1, 2)


@pytest.mark.parametrize("fmt", [P32E2, P16E1], ids=lambda f: f.name)
def test_quire_carry_stats_vs_reference(fmt):
    rng = np.random.default_rng(3)
    a = ti.posits(rng, (8, 64), -2, 2, fmt)
    b = ti.posits(rng, (64, 8), -2, 2, fmt)
    limbs, _ = quire_gemm_limbs(a, b, fmt, negate=True)
    got = TO.quire_carry_stats(limbs)
    want = JO.quire_carry_stats(
        j_quire_gemm_limbs(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                           JF.get_format(fmt.name), negate=True)[0])
    assert np.array_equal(got["per_limb"].numpy(),
                          np.asarray(want["per_limb"]))
    assert int(got["total"]) == int(want["total"]) > 0
    assert int(TO.quire_carry_stats(torch.zeros((4, 16), dtype=torch.int64))
               ["total"]) == 0


def test_golden_zone_bounds_and_fraction():
    assert TO.golden_zone_bounds(P32E2) == (1 / 16, 16.0)
    assert TO.golden_zone_bounds(P16E1) == (1 / 4, 4.0)
    assert TO.golden_zone_bounds(P8E2) == (1 / 16, 16.0)
    w = TP.from_float64(torch.tensor([1 / 16, 15.9, 16.0, 0.05],
                                     dtype=torch.float64))
    assert TO.golden_zone_fraction(w, P32E2) == 0.5


def test_record_helpers_keys_equal_reference():
    """record_numerics / record_encode_stats / record_quire_carries fill
    the reference's keys with the reference's values."""
    rng = np.random.default_rng(9)
    words = ti.posits(rng, (16, 16), -6, 6)
    x = rng.standard_normal(200) * np.exp2(rng.uniform(-40, 40, 200))
    limbs = TA._word_limbs(words, P32E2)[0]
    with TO.scoped() as mt:
        TO.record_numerics("w", words)
        TO.record_encode_stats("e", torch.from_numpy(x))
        TO.record_quire_carries("q", limbs)
    with JO.scoped() as mj:
        JO.record_numerics("w", jnp.asarray(words.numpy()))
        JO.record_encode_stats("e", jnp.asarray(x))
        JO.record_quire_carries("q", jnp.asarray(limbs.numpy()))
    _same_record(mt.to_dict(), mj.to_dict())


# --------------------------------------------------------------------------
# 4. metrics, spans, chrome trace
# --------------------------------------------------------------------------

def test_log2_bucket():
    assert TM.log2_bucket(1.0) == 0
    assert TM.log2_bucket(0.5) == -1
    assert TM.log2_bucket(3.0) == 1
    assert TM.log2_bucket(-4.0) == 2
    assert TM.log2_bucket(0.0) == TM.ZERO_BUCKET
    assert TM.log2_bucket(float("nan")) == TM.ZERO_BUCKET


def test_disabled_recorders_are_noops():
    assert not TO.enabled()
    TO.inc("x")
    TO.gauge("x", 1.0)
    TO.observe("x", 2.0)
    TO.record("x", a=1)
    with TO.span("nope"):
        pass
    assert TO.active(torch.zeros(3)) is False


def test_scoped_nesting_and_json():
    with TO.scoped() as outer:
        TO.inc("n")
        with TO.scoped() as inner:
            TO.inc("n", 2)
            TO.observe("h", 3.0)
        TO.inc("n")
    assert inner.counters["n"] == 2
    assert outer.counters["n"] == 4
    assert outer.hists["h"] == {1: 1}
    json.loads(outer.to_json())
    # the port's switch is its own: the reference's collectors see nothing
    with JO.scoped() as ref:
        TO.inc("n")
    assert ref.counters == {}


def test_span_nesting_and_chrome_roundtrip(tmp_path):
    with TO.scoped() as m:
        with TO.span("outer", size=3):
            with TO.span("inner"):
                pass
    names = {e["name"]: e for e in m.events}
    assert set(names) == {"outer", "inner"}
    assert names["inner"]["args"]["path"] == "outer.inner"
    assert names["inner"]["args"]["depth"] == 2
    assert names["outer"]["args"]["size"] == 3
    assert names["inner"]["ts"] >= names["outer"]["ts"]
    assert names["inner"]["dur"] <= names["outer"]["dur"]
    path = tmp_path / "trace.json"
    m.save_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert len(doc["traceEvents"]) == 2
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X" and ev["cat"] == "positscope"
        for key in ("ts", "dur", "pid", "tid", "name", "cat", "args"):
            assert key in ev


def test_spans_reach_the_torch_profiler():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with TO.scoped():
            with TO.span("positscope_probe"):
                torch.ones(4).sum()
    assert any(e.name == "positscope_probe" for e in prof.events())
