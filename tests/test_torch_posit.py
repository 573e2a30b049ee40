"""The port's posit codec and arithmetic (repro_torch.core) against the JAX
package and the rational oracle, on the same numpy-made words and values.

Everything here is integer arithmetic or separately rounded IEEE f64
arithmetic, so the contract is bit-identity, never a tolerance.  The exact
backend is held to the reference on every pair of 8-bit words and every
p16e1 word, and to the oracle on a fixed sample of them (the oracle is
pure Python, a few hundred microseconds a word).
"""
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posit_oracle as O
import torch_inputs as ti
from cpu_tests import JIT_CODEC
from repro.core import formats as JF
from repro.core import posit as JP
from repro_torch.core import formats as TF
from repro_torch.core import posit as TP

FMTS = ["p32e2", "p16e1", "p8e2", "p8e0"]
_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _words(name, rng):
    return ti.words(TF.FORMATS[name], rng, 1 << 16)


_values = ti.values

BINOPS = ("add", "sub", "mul", "div")


# The reference's functions under test, each compiled once per format (as
# eager calls, every op inside them would compile on its own).
@functools.partial(jax.jit, static_argnames=("name",))
def _j_binops(a, b, name):
    return [getattr(JP, op)(a, b, JF.FORMATS[name]) for op in BINOPS]


@functools.partial(jax.jit, static_argnames=("name",))
def _j_unary(w, name):
    return [getattr(JP, op)(w, JF.FORMATS[name])
            for op in ("sqrt", "neg_", "abs_")]


@functools.partial(jax.jit, static_argnames=("src",))
def _j_pconvert_all(w, src):
    return [JP.pconvert(w, JF.FORMATS[src], JF.FORMATS[dst]) for dst in FMTS]


@functools.partial(jax.jit, static_argnames=("name",))
def _j_rounding_eps(x, name):
    return JP.rounding_eps(x, JF.FORMATS[name])


def _same_bits(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and np.array_equal(x.view(np.uint8),
                                                 y.view(np.uint8))


@functools.partial(jax.jit, static_argnames=("name",))
def _j_float32(x32, w, name):
    fmt = JF.FORMATS[name]
    return JP.from_float32(x32, fmt), JP.to_float32(w, fmt)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))
    return np.array_equal(a, b)


def test_formats_copy_matches_reference():
    assert sorted(TF.FORMATS) == sorted(JF.FORMATS)
    for name, jf in JF.FORMATS.items():
        tf = TF.FORMATS[name]
        for attr in ("nbits", "es", "max_scale", "maxpos_pattern",
                     "minpos_pattern", "nar_pattern", "max_frac_bits",
                     "maxpos", "minpos", "eps_at_1", "wire_dtype"):
            assert getattr(tf, attr) == getattr(jf, attr), (name, attr)


@pytest.mark.parametrize("name", FMTS)
def test_to_float64_and_decode_match_jax(name):
    rng = np.random.default_rng(0)
    w = _words(name, rng)
    jfmt, tfmt = JF.FORMATS[name], TF.FORMATS[name]
    want = np.asarray(JP.to_float64(jnp.asarray(w), jfmt))
    got = TP.to_float64(torch.from_numpy(w), tfmt).numpy()
    assert _same(got.view(np.int64), want.view(np.int64)) or _same(got, want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.array_equal(got[fin].view(np.int64), want[fin].view(np.int64))
    for jv, tv in zip(JP.decode(jnp.asarray(w), jfmt),
                      TP.decode(torch.from_numpy(w), tfmt)):
        assert np.array_equal(np.asarray(jv), tv.numpy()), name


@pytest.mark.parametrize("name", FMTS)
def test_from_float64_matches_jax(name):
    rng = np.random.default_rng(1)
    x = np.concatenate([_values(rng, lo=-300, hi=300),
                        np.asarray(JP.to_float64(
                            jnp.asarray(_words(name, rng)),
                            JF.FORMATS[name]))])
    want = np.asarray(JP.from_float64(jnp.asarray(x), JF.FORMATS[name]))
    got = TP.from_float64(torch.from_numpy(x), TF.FORMATS[name]).numpy()
    assert np.array_equal(got, want), x[got != want][:5]


@pytest.mark.parametrize("name", FMTS)
def test_jitted_reference_codec_equals_eager(name):
    """The jitted reference codec that the drivers' test files run
    (tests/cpu_tests.py) gives the eager calls' bits on the inputs of
    the codec tests above and below (the same seeds, so the same arrays),
    and on the f32 corners."""
    jfmt = JF.FORMATS[name]
    rng = np.random.default_rng(0)
    w0 = _words(name, rng)
    rng = np.random.default_rng(1)
    x1 = _values(rng, lo=-300, hi=300)
    x1 = np.concatenate([x1, np.asarray(JP.to_float64(
        jnp.asarray(_words(name, rng)), jfmt))])
    rng = np.random.default_rng(2)
    with np.errstate(over="ignore"):
        x32 = _values(rng, 20000, -160, 140).astype(np.float32)
    bits = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    x32 = np.concatenate([x32, bits.view(np.float32)])
    w2 = _words(name, rng)
    corners = ti.f32_corners()
    for fn, arg in (("to_float64", w0), ("from_float64", x1),
                    ("from_float64", _values(np.random.default_rng(7))),
                    ("from_float32_bits", x32),
                    ("from_float32_bits", corners),
                    ("to_float32_bits", w2)):
        eager = getattr(JP, fn)(jnp.asarray(arg), jfmt)
        assert _same_bits(JIT_CODEC[fn](jnp.asarray(arg), jfmt), eager), \
            (name, fn)


@pytest.mark.parametrize("name", ["p16e1", "p8e2", "p8e0"])
def test_codec_matches_rational_oracle(name):
    """Every word of the narrow formats decodes to the oracle's value, and
    the oracle's value (plus the midpoints between neighbours, the tie
    cases) encodes back to the oracle's pattern."""
    fmt = TF.FORMATS[name]
    w = np.arange(-(1 << (fmt.nbits - 1)), 1 << (fmt.nbits - 1),
                  dtype=np.int32)
    if fmt.nbits == 16:
        w = w[::29]                                  # keep the oracle cheap
    vals = TP.to_float64(torch.from_numpy(w), fmt).numpy()
    xs, want = [], []
    for p, v in zip(w.tolist(), vals.tolist()):
        ov = O.decode(p, fmt.nbits, fmt.es)
        if ov is None:
            assert np.isnan(v), p
            continue
        assert v == float(ov), (p, v, ov)
        xs.append(v)
        want.append(p)
        mid = O.decode(((p & ((1 << fmt.nbits) - 1)) << 1) | 1,
                       fmt.nbits + 1, fmt.es)
        if mid is not None and p != fmt.maxpos_pattern and p != -1:
            xs.append(float(mid))
            want.append(O.encode(mid, fmt.nbits, fmt.es))
    got = TP.from_float64(torch.tensor(xs, dtype=torch.float64), fmt).numpy()
    assert np.array_equal(got, np.array(want, np.int32))


@pytest.mark.parametrize("name", ["p32e2", "p16e1"])
def test_chain_round_matches_jax_and_round_trip(name):
    """The reference's chain_round input set (test_perf_paths.py)."""
    rng = np.random.default_rng(7)
    x = _values(rng)
    jfmt, tfmt = JF.FORMATS[name], TF.FORMATS[name]
    got = TP.chain_round(torch.from_numpy(x), tfmt).numpy()
    want = np.asarray(JP.chain_round(jnp.asarray(x), jfmt))
    assert _same(got, want), x[~((got == want)
                                 | (np.isnan(got) & np.isnan(want)))][:5]
    trip = TP.to_float64(TP.from_float64(torch.from_numpy(x), tfmt),
                         tfmt).numpy()
    assert _same(got, trip)


@pytest.mark.parametrize("name", FMTS)
def test_float32_bit_paths_match_jax(name):
    rng = np.random.default_rng(2)
    with np.errstate(over="ignore"):
        x32 = _values(rng, 20000, -160, 140).astype(np.float32)
    bits = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    x32 = np.concatenate([x32, bits.view(np.float32)])
    jfmt, tfmt = JF.FORMATS[name], TF.FORMATS[name]
    assert np.array_equal(
        TP.from_float32_bits(torch.from_numpy(x32), tfmt).numpy(),
        np.asarray(JP.from_float32_bits(jnp.asarray(x32), jfmt)))
    w = _words(name, rng)
    got = TP.to_float32_bits(torch.from_numpy(w), tfmt).numpy()
    want = np.asarray(JP.to_float32_bits(jnp.asarray(w), jfmt))
    assert _same(got.view(np.int32), want.view(np.int32)) or _same(got, want)
    assert np.array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "sqrt"])
@pytest.mark.parametrize("name", ["p32e2", "p16e1"])
def test_fast_ops_match_jax(op, name):
    rng = np.random.default_rng(3)
    w = _words(name, rng)
    a = rng.choice(w, 4000)
    b = rng.choice(w, 4000)
    jfmt, tfmt = JF.FORMATS[name], TF.FORMATS[name]
    if op == "sqrt":
        want = JP.sqrt(jnp.asarray(a), jfmt, backend="fast")
        got = TP.sqrt(torch.from_numpy(a), tfmt, backend="fast")
    else:
        want = getattr(JP, op)(jnp.asarray(a), jnp.asarray(b), jfmt,
                               backend="fast")
        got = getattr(TP, op)(torch.from_numpy(a), torch.from_numpy(b), tfmt,
                              backend="fast")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_chain_ops_match_word_ops():
    """chain_* on decoded values == the fast word ops, decoded."""
    rng = np.random.default_rng(5)
    w = _words("p32e2", rng)
    a, b = torch.from_numpy(rng.choice(w, 4000)), torch.from_numpy(
        rng.choice(w, 4000))
    av, bv = TP.chain_decode(a), TP.chain_decode(b)
    for op in ("add", "sub", "mul", "div"):
        got = getattr(TP, f"chain_{op}")(av, bv)
        want = TP.to_float64(getattr(TP, op)(a, b, backend="fast"))
        assert _same(got.numpy(), want.numpy()), op
    got = TP.chain_sqrt(av)                  # negatives -> NaN, as NaR
    want = TP.to_float64(TP.sqrt(a, backend="fast"))
    assert _same(got.numpy(), want.numpy())


def test_is_nar_and_unported_backend():
    """is_nar matches the reference; the arithmetic's default backend is
    the exact one, as in the reference, and an unknown backend raises."""
    for name in FMTS:
        fmt = TF.FORMATS[name]
        w = torch.tensor([0, 1, -1, fmt.nar_pattern, fmt.maxpos_pattern],
                         dtype=torch.int32)
        assert TP.is_nar(w, fmt).tolist() == [False, False, False, True,
                                              False]
        assert np.array_equal(TP.is_nar(w, fmt).numpy(),
                              np.asarray(JP.is_nar(jnp.asarray(w.numpy()),
                                                   JF.FORMATS[name])))
    assert np.array_equal(TP.add(w, w).numpy(),
                          np.asarray(JP.add(jnp.asarray(w.numpy()),
                                            jnp.asarray(w.numpy()))))
    assert torch.equal(TP.add(w, w), TP.add(w, w, backend="exact"))
    with pytest.raises(ValueError):
        TP.add(w, w, backend="nope")


def _pairs(fmt):
    """Every (a, b) pair of an 8-bit format's words."""
    w = np.arange(-(1 << (fmt.nbits - 1)), 1 << (fmt.nbits - 1),
                  dtype=np.int32)
    return np.repeat(w, w.size), np.tile(w, w.size)


def _oracle_binop(op, a, b, fmt):
    va, vb = (O.decode(int(x), fmt.nbits, fmt.es) for x in (a, b))
    if va is None or vb is None or (op == "div" and vb == 0):
        return fmt.nar_pattern
    exact = {"add": va + vb, "sub": va - vb, "mul": va * vb,
             "div": va / vb if vb else None}[op]
    return O.encode(exact, fmt.nbits, fmt.es)


@pytest.fixture(scope="module")
def exact_pairs():
    """Per 8-bit format: every (a, b) pair and the reference's exact
    add/sub/mul/div of them, the four from one compiled program."""
    out = {}
    for name in ("p8e0", "p8e2"):
        a, b = _pairs(TF.FORMATS[name])
        want = _j_binops(jnp.asarray(a), jnp.asarray(b), name=name)
        out[name] = (a, b, dict(zip(BINOPS, map(np.asarray, want))))
    return out


@pytest.mark.parametrize("op", BINOPS)
@pytest.mark.parametrize("name", ["p8e0", "p8e2"])
def test_exact_ops_every_pair_match_jax_and_oracle(exact_pairs, op, name):
    fmt = TF.FORMATS[name]
    a, b, want = exact_pairs[name]
    got = getattr(TP, op)(torch.from_numpy(a), torch.from_numpy(b),
                          fmt).numpy()
    assert np.array_equal(got, want[op])
    for i in range(0, a.size, 61):
        assert got[i] == _oracle_binop(op, a[i], b[i], fmt), (a[i], b[i])


def test_exact_unary_every_p16e1_word():
    fmt = TF.P16E1
    w = np.arange(-(1 << 15), 1 << 15, dtype=np.int32)
    for op, want in zip(("sqrt", "neg_", "abs_"),
                        _j_unary(jnp.asarray(w), name="p16e1")):
        got = getattr(TP, op)(torch.from_numpy(w), fmt).numpy()
        assert np.array_equal(got, np.asarray(want)), op
    got = TP.sqrt(torch.from_numpy(w), fmt).numpy()
    for i in range(0, w.size, 257):
        v = O.decode(int(w[i]), 16, 1)
        want = (fmt.nar_pattern if v is None or v < 0
                else O.sqrt_nearest(v, 16, 1))
        assert got[i] == want, w[i]
    neg = TP.neg_(torch.from_numpy(w), fmt).numpy()
    assert neg[0] == fmt.nar_pattern and np.array_equal(
        neg[1:], -w[1:])


def test_exact_ops_p32_sampled_and_specials():
    fmt = TF.P32E2
    rng = np.random.default_rng(11)
    w = ti.words(fmt, rng, 1 << 14)
    sp = ti.P32_SPECIALS
    a = np.concatenate([rng.choice(w, 20000), np.repeat(sp, sp.size)])
    b = np.concatenate([rng.choice(w, 20000), np.tile(sp, sp.size)])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    wants = _j_binops(jnp.asarray(a), jnp.asarray(b), name="p32e2")
    for op, want in zip(BINOPS, wants):
        got = getattr(TP, op)(ta, tb).numpy()
        assert np.array_equal(got, np.asarray(want)), op
        for i in list(range(0, 20000, 97)) + list(range(20000, a.size)):
            assert got[i] == _oracle_binop(op, a[i], b[i], fmt), (op, i)
    got = TP.sqrt(ta).numpy()
    assert np.array_equal(got, np.asarray(_j_unary(jnp.asarray(a),
                                                   name="p32e2")[0]))
    for i in range(0, a.size, 211):
        v = O.decode(int(a[i]), 32, 2)
        assert got[i] == (fmt.nar_pattern if v is None or v < 0
                          else O.sqrt_nearest(v, 32, 2)), a[i]


def test_pconvert_every_pair_of_formats():
    """All p8/p16 words and sampled p32 words, each format to each."""
    rng = np.random.default_rng(12)
    for src in FMTS:
        w = _words(src, rng)
        wants = _j_pconvert_all(jnp.asarray(w), src=src)
        for dst, want in zip(FMTS, wants):
            got = TP.pconvert(torch.from_numpy(w), TF.FORMATS[src],
                              TF.FORMATS[dst]).numpy()
            assert np.array_equal(got, np.asarray(want)), (src, dst)
            if src == dst:
                assert np.array_equal(got, w)


@pytest.mark.parametrize("name", FMTS)
def test_rounding_eps_matches_jax(name):
    """Bit-equal f64, over zero, f64 subnormals (zero, as XLA's CPU reads
    them), inf/NaN, huge values and every posit value of the format."""
    rng = np.random.default_rng(13)
    jfmt, tfmt = JF.FORMATS[name], TF.FORMATS[name]
    x = np.concatenate([
        _values(rng), [5e-324, -5e-324, 2.0 ** -1030, 2.0 ** -1022, np.inf,
                       -np.inf, np.nan, 1e300, -1.7e308],
        np.asarray(JP.to_float64(jnp.asarray(_words(name, rng)), jfmt))])
    got = TP.rounding_eps(torch.from_numpy(x), tfmt).numpy()
    want = np.asarray(_j_rounding_eps(jnp.asarray(x), name=name))
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert got[-1] == 0 or got.max() <= 1.0


@pytest.mark.parametrize("name", FMTS)
def test_float32_conversions_match_jax(name):
    """to_float32 / from_float32 over the f32 corner set (subnormals read
    as zero, as the reference's f32 -> f64 conversion gives on XLA's CPU)
    and every word."""
    rng = np.random.default_rng(14)
    jfmt, tfmt = JF.FORMATS[name], TF.FORMATS[name]
    x32 = ti.f32_corners(20000)
    w = _words(name, rng)
    want_p, want = map(np.asarray, _j_float32(jnp.asarray(x32),
                                              jnp.asarray(w), name=name))
    got = TP.from_float32(torch.from_numpy(x32), tfmt).numpy()
    assert np.array_equal(got, want_p)
    got = TP.to_float32(torch.from_numpy(w), tfmt).numpy()
    assert _same(got.view(np.int32), want.view(np.int32)) or _same(got, want)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def test_port_imports_no_jax():
    """repro_torch, its kernels, the quire, the refinement drivers, the
    training launch, optimizer and data, and chip_smoke.py import neither
    jax nor the JAX package."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import repro_torch, repro_torch.interop
        import repro_torch.core.posit, repro_torch.kernels.ops
        import repro_torch.kernels._build, repro_torch.lapack
        import repro_torch.quire, repro_torch.lapack.refine
        import repro_torch.dist, repro_torch.checkpoint
        import repro_torch.launch.train, repro_torch.launch.steps
        import repro_torch.launch.collectives, repro_torch.optim
        import repro_torch.data
        sys.path.insert(0, %r)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("BAD", bad)
    """) % (_SRC, os.path.dirname(_SRC))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
