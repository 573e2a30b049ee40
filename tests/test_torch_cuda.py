"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode);
without a GPU each one skips.  The file imports neither jax nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the decode/encode kernels and the GEMM's decode pre-pass are
integer/IEEE-exact, so they must equal their plain versions bit for bit
(the encode's int16/int8 wire words too);
the GEMM sums in f32 in its own order, so it is held to the reference's
bound sqrt(K) * 8e-8 against the exact product, and its fused encode must
equal encode(± its own f32 output) bit for bit.  The tiled GEMM kernel
keeps the first (simple) kernel's order of operations per output, so its
output must equal the simple kernel's bit for bit.  Where the lo planes decide the product (one nonzero
per row of A), split3 is held to two f32 roundings of the exact product,
which a GEMM without the lo planes misses (tests/torch_inputs.py).  The
quire is integer PyTorch code, so on the card it must give the CPU's words;
so must the checksums, the observability records of faithful runs and the
guarded solve ladder.  A collector changes no word and no kernel launch.
Four ranks on the one card (gloo, host-staged collectives) factor a 2x2
block-cyclic LU whose words and pivots must equal the single-device LU's.
The serving path's quantized matmul runs on the skinny kernel within the
same bound; the skinny kernel's output equals the tiled kernel's chain
(encode, widened words, pre-pass, tiled GEMM, scale) bit for bit at every
M, and the serving engine's batched tokens equal its sequential ones.
"""
import numpy as np
import pytest
import torch

import torch_inputs as ti
from repro_torch.core import formats as TF
from repro_torch.core import posit as TP
from repro_torch.kernels import posit_gemm as TG

FMTS = ["p32e2", "p16e1", "p8e2", "p8e0"]


def _rel_err(got, a, b):
    return ti.gemm_rel_err(got, TP.to_float64(a), TP.to_float64(b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_codec_kernels_match_plain(cuda_device, name):
    rng = np.random.default_rng(10)
    fmt = TF.FORMATS[name]
    w = torch.from_numpy(ti.words(fmt, rng, 1 << 20)).to(cuda_device)
    kh, kl = TG.decode_split_f32(w, fmt)
    ph, pl = TG.decode_split_f32_plain(w, fmt)
    assert torch.equal(kh.view(torch.int32), ph.view(torch.int32))
    assert torch.equal(kl.view(torch.int32), pl.view(torch.int32))
    bits = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32)).to(cuda_device)
    assert torch.equal(TG.encode_posit_f32(x, fmt),
                       TG.encode_posit_f32_plain(x, fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_encode_narrow_words_and_one_kv_launch(cuda_device, name):
    """The encode kernel's wire-dtype words equal its int32 words narrowed
    (aligned, unaligned and odd-length inputs); encode_kv makes one encode
    launch and no cast after it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.policy import wire_dtype
    from repro_torch.serving.kv_cache import encode_kv
    fmt = TF.FORMATS[name]
    wire = wire_dtype(fmt)
    x = torch.from_numpy(np.concatenate(
        [ti.f32_corners(20000),
         ti.encode_boundaries(fmt, np.random.default_rng(3))])).to(
             cuda_device)
    for xs in (x, x[1:], x[:4095]):
        got = TG.encode_posit_f32(xs, fmt, out_dtype=wire)
        assert got.dtype == wire
        assert torch.equal(got, TG.encode_posit_f32(xs, fmt).to(wire))
        assert torch.equal(got, TG.encode_posit_f32_plain(xs, fmt, wire))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))
    rows = torch.randn(4, 2, 64, device=cuda_device)
    before = TG.encode_posit_f32.launches
    with Ops() as seen:
        words = encode_kv(rows, name)
    assert TG.encode_posit_f32.launches == before + 1
    assert words.dtype == wire
    assert not [op for op in seen.ops if "copy" in op or "_to" in op], \
        seen.ops
    assert torch.equal(words, TG.encode_posit_f32_plain(rows.cpu(), fmt,
                                                        wire).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("shape", [(65, 17, 130), (33, 65, 9),
                                   (257, 300, 129)])
def test_cuda_gemm_kernel_within_bound(cuda_device, mode, shape):
    m, k, n = shape
    rng = np.random.default_rng(11)
    a = ti.posits(rng, (m, k), -4, 4, device=cuda_device)
    b = ti.posits(rng, (k, n), -4, 4, device=cuda_device)
    got = TG.posit_gemm_f32(a, b, mode=mode)
    assert _rel_err(got, a, b) < np.sqrt(k) * 8e-8
    assert _rel_err(TG.posit_gemm_f32_plain(a, b, mode=mode), a, b) \
        < np.sqrt(k) * 8e-8
    for neg in (False, True):
        fused = TG.posit_gemm(a, b, mode=mode, negate=neg)
        assert torch.equal(fused,
                           TG.encode_posit_f32_plain(-got if neg else got))


@pytest.mark.cuda
def test_cuda_gemm_strided_operands_and_launch_count(cuda_device):
    """Row-strided views (a factorization's trailing blocks) are read in
    place; each wrapper call is one launch."""
    rng = np.random.default_rng(12)
    big = ti.posits(rng, (200, 200), -2, 2, device=cuda_device)
    a, b = big[70:, 3:67], big[3:67, 70:]
    before = TG.posit_gemm_f32.launches
    got = TG.posit_gemm_f32(a, b)
    assert TG.posit_gemm_f32.launches == before + 1
    assert torch.equal(got, TG.posit_gemm_f32(a.contiguous(),
                                              b.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("shape", ti.LO_PLANE_SHAPES)
def test_cuda_gemm_kernel_uses_lo_planes(cuda_device, mode, shape):
    rng = np.random.default_rng(13)
    a, b = ti.lo_plane_operands(rng, *shape, device=cuda_device)
    assert ti.lo_plane_err(ti.hi_only_product(a, b), a, b) > ti.LO_PLANE_LIMIT
    got = TG.posit_gemm_f32(a, b, mode=mode)
    assert ti.lo_plane_err(got, a, b) <= ti.LO_PLANE_LIMIT


GEMM_SHAPES = [(65, 17, 130), (33, 65, 9), (257, 300, 129), (4032, 64, 4032)]


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("name", FMTS)
def test_cuda_tiled_gemm_bit_identical_to_simple(cuda_device, name, mode,
                                                 shape):
    """Every kc (several chunks where K > kc), both output forms."""
    m, k, n = shape
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(14)
    a = ti.posits(rng, (m, k), -4, 4, fmt, cuda_device)
    b = ti.posits(rng, (k, n), -4, 4, fmt, cuda_device)
    a[0, 0] = fmt.nar_pattern                          # NaN through both
    for kc in (16, 48, 128):
        got = TG.posit_gemm_f32(a, b, bk=kc, mode=mode, fmt=fmt)
        want = TG.posit_gemm_f32_simple(a, b, bk=kc, mode=mode, fmt=fmt)
        assert torch.equal(_bits(got), _bits(want)), kc
        for neg in (False, True):
            fused = TG.posit_gemm(a, b, bk=kc, mode=mode, negate=neg, fmt=fmt)
            assert torch.equal(fused, TG.encode_posit_f32_plain(
                -got if neg else got, fmt)), (kc, neg)
            assert torch.equal(fused, TG.posit_gemm_simple(
                a, b, bk=kc, mode=mode, negate=neg, fmt=fmt)), (kc, neg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("name", FMTS)
def test_cuda_tiled_gemm_cancelling_bit_identical(cuda_device, name, mode):
    """An exactly zero product: every output is the residue of the
    kernels' roundings, so any reordered product or fold would show."""
    fmt = TF.FORMATS[name]
    a, b = ti.cancelling_operands(np.random.default_rng(18), 257, 96, 129,
                                  fmt, cuda_device)
    for kc in (16, 48, 128):
        got = TG.posit_gemm_f32(a, b, bk=kc, mode=mode, fmt=fmt)
        want = TG.posit_gemm_f32_simple(a, b, bk=kc, mode=mode, fmt=fmt)
        assert torch.equal(_bits(got), _bits(want)), kc


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_tiled_gemm_views_bit_identical(cuda_device, name):
    """Row-strided views (LU's trailing blocks) and a transposed B
    (Cholesky's trans_b) are read in place, with the simple kernel's
    bits."""
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(15)
    big = ti.posits(rng, (300, 300), -2, 2, fmt, cuda_device)
    a = big[70:, 3:67]
    for b in (big[3:67, 70:], big[70:233, 3:67].T):
        for mode in ("split3", "split3_comp"):
            got = TG.posit_gemm_f32(a, b, mode=mode, fmt=fmt)
            want = TG.posit_gemm_f32_simple(a, b, mode=mode, fmt=fmt)
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_decode_planes_match_plain(cuda_device, name):
    """The pre-pass planes: decode_split_f32_plain of A transposed and of
    B, padded with zeros as the kernel lays them out."""
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(16)
    words = rng.choice(ti.words(fmt, rng, 1 << 16), (300, 300))
    big = torch.from_numpy(words).to(cuda_device)
    for a, b in ((big[:65, :17], big[17:34, :130]),
                 (big[5:38, 3:68], big[100:109, 3:68].T),
                 (big[:257, :300], big[:300, 1:130])):
        got = TG.decode_planes(a, b, fmt)
        want = TG.decode_planes_plain(a, b, fmt)
        assert (want.a_lo is None) == (fmt.nbits <= 16)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.shape == w.shape
                assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_cuda_rgemm_launches_tiled_kernel_only(cuda_device):
    """rgemm's trailing-update and fused forms go through the pre-pass and
    the tiled kernel; the simple kernel is launched by no rgemm call."""
    from repro_torch.kernels.ops import rgemm
    rng = np.random.default_rng(17)
    a = ti.posits(rng, (200, 64), -2, 2, device=cuda_device)
    b = ti.posits(rng, (64, 150), -2, 2, device=cuda_device)
    c = ti.posits(rng, (200, 150), -2, 2, device=cuda_device)
    TG.reset_launch_counts()
    rgemm(a, b, c, alpha=-1.0, beta=1.0, backend="pallas_split3")
    rgemm(a, b.T.contiguous(), c, alpha=-1.0, beta=1.0, trans_b=True,
          backend="pallas_split3_comp")
    rgemm(a, b, alpha=-1.0, backend="pallas_split3")
    counts = TG.launch_counts()
    assert counts["posit_gemm_f32"] == 2 and counts["posit_gemm"] == 1
    assert counts["decode_planes"] == 3
    assert counts["posit_gemm_f32_simple"] == 0
    assert counts["posit_gemm_simple"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_quire_matches_cpu(cuda_device, name):
    """The quire is plain PyTorch integer code: on the card it gives the
    CPU's words (quire_gemm, quire_dot with init/negate, rgemm
    quire_exact) and the quire sweeps give the CPU's solution."""
    from repro_torch import quire as TQ
    from repro_torch.kernels.ops import rgemm
    from repro_torch.lapack import solve as TS
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(18)
    a = ti.posits(rng, (33, 40), -8, 8, fmt)
    b = ti.posits(rng, (40, 21), -8, 8, fmt)
    c = ti.posits(rng, (33, 21), -2, 2, fmt)
    ag, bg, cg = (x.to(cuda_device) for x in (a, b, c))
    assert torch.equal(TQ.quire_gemm(ag, bg, cg, fmt, negate=True).cpu(),
                       TQ.quire_gemm(a, b, c, fmt, negate=True))
    assert torch.equal(
        TQ.quire_dot(ag[:, None, :], bg.T[None], fmt, init_p=cg,
                     negate=True, kc=7).cpu(),
        TQ.quire_dot(a[:, None, :], b.T[None], fmt, init_p=c, negate=True,
                     kc=7))
    assert torch.equal(
        rgemm(ag, bg, cg, alpha=2.0, beta=-0.5, backend="quire_exact",
              fmt=fmt).cpu(),
        rgemm(a, b, c, alpha=2.0, beta=-0.5, backend="quire_exact",
              fmt=fmt))
    m = ti.posits(rng, (24, 24), -1, 1, fmt)
    rhs = ti.posits(rng, (24,), -1, 1, fmt)
    got = TS.rtrtrs(m.to(cuda_device), rhs.to(cuda_device), lower=True,
                    unit_diag=True, quire=True, fmt=fmt)
    assert torch.equal(got.cpu(), TS.rtrtrs(m, rhs, lower=True,
                                            unit_diag=True, quire=True,
                                            fmt=fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p32e2", "p16e1"])
def test_cuda_batched_gemm_equals_per_matrix(cuda_device, name):
    """One batched pre-pass + GEMM launch gives each matrix the 2-D
    launch's bits: ragged K (below one 16-row stage), N = 1, a transposed
    A; both modes, f32 and fused ±encode."""
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(19)

    def words(shape):
        return ti.posits(rng, shape, -4, 4, fmt, cuda_device)
    cases = [(words((3, 150, 7)), words((3, 7, 70))),
             (words((3, 260, 200)), words((3, 200, 1))),
             (words((3, 40, 130)).mT, words((3, 40, 33)))]
    for a, b in cases:
        for mode in TG.MODES:
            TG.reset_launch_counts()
            got = TG.posit_gemm_f32(a, b, bk=16, mode=mode, fmt=fmt)
            assert TG.launch_counts()["posit_gemm_f32"] == 1
            assert TG.launch_counts()["decode_planes"] == 1
            want = torch.stack([TG.posit_gemm_f32(a[i], b[i], bk=16,
                                                  mode=mode, fmt=fmt)
                                for i in range(3)])
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            for neg in (False, True):
                got = TG.posit_gemm(a, b, bk=16, mode=mode, negate=neg,
                                    fmt=fmt)
                assert torch.equal(got, torch.stack([
                    TG.posit_gemm(a[i], b[i], bk=16, mode=mode, negate=neg,
                                  fmt=fmt) for i in range(3)]))


@pytest.mark.cuda
def test_cuda_qr_words_match_cpu(cuda_device):
    """rgels with the faithful GEMM (separately rounded ops only): the
    card's factors, tau and solution are the CPU's words."""
    from repro_torch.lapack import qr as TQR
    rng = np.random.default_rng(20)
    a = ti.posits(rng, (30, 18), -1, 1)
    b = ti.posits(rng, (30,), -1, 1)
    xg, (qg, tg) = TQR.rgels(a.to(cuda_device), b.to(cuda_device), nb=8,
                             gemm_backend="faithful")
    xc, (qc, tc) = TQR.rgels(a, b, nb=8, gemm_backend="faithful")
    assert torch.equal(xg.cpu(), xc) and torch.equal(qg.cpu(), qc)
    assert torch.equal(tg.cpu(), tc)


@pytest.mark.cuda
def test_cuda_chain_sum_graph_matches_cpu(cuda_device):
    """The chained scan replays a CUDA graph of one rounded add per step:
    its values equal the CPU's eager scan bit for bit (vector, scalar and
    matrix lanes; a cached graph reused), and potf2, which runs its column
    chains through it, gives the CPU's words."""
    from repro_torch.core.formats import P32E2
    from repro_torch.lapack import blas as TB
    from repro_torch.lapack import decomp as TD
    rng = np.random.default_rng(21)

    def vals(shape):
        return TP.chain_decode(ti.posits(rng, shape, -6, 6))
    for init, terms, dim in ((vals((7,)), vals((50, 7)), -2),
                             (vals((1,))[0], vals((40,)), -1),
                             (vals((5, 5)), vals((30, 5, 5)), -3),
                             (vals((7,)), vals((9, 7)), -2)):
        want = TB.chain_sum(init, terms, dim, P32E2)
        got = TB.chain_sum(init.to(cuda_device), terms.to(cuda_device), dim,
                           P32E2)
        assert torch.equal(got.cpu().view(torch.int64),
                           want.view(torch.int64))
    x = rng.standard_normal((40, 40))
    a = TP.from_float64(torch.from_numpy(x.T @ x))
    assert torch.equal(TD.potf2(a.to(cuda_device)).cpu(), TD.potf2(a))


@pytest.mark.cuda
def test_cuda_chain_sum_graph_cache_bounded(cuda_device, monkeypatch):
    """The scan's graph cache keeps at most ``_ADD_STEPS_MAX`` graphs, the
    least recently used leaving first; scans before and after an eviction
    (graphs sharing one memory pool) give the CPU's values."""
    from collections import OrderedDict
    from repro_torch.core.formats import P32E2
    from repro_torch.lapack import blas as TB
    monkeypatch.setattr(TB, "_ADD_STEPS_MAX", 2)
    monkeypatch.setattr(TB, "_ADD_STEPS", OrderedDict())
    rng = np.random.default_rng(23)
    for width in (3, 4, 3, 5, 6, 4):
        init = TP.chain_decode(ti.posits(rng, (width,), -6, 6))
        terms = TP.chain_decode(ti.posits(rng, (20, width), -6, 6))
        want = TB.chain_sum(init, terms, -2, P32E2)
        got = TB.chain_sum(init.to(cuda_device), terms.to(cuda_device), -2,
                           P32E2)
        assert torch.equal(got.cpu().view(torch.int64),
                           want.view(torch.int64))
        assert len(TB._ADD_STEPS) <= 2
        assert next(reversed(TB._ADD_STEPS))[0] == (width,)


@pytest.mark.cuda
def test_cuda_observed_record_matches_cpu(cuda_device):
    """Observability on the card: the LU and Cholesky records (faithful,
    so the words are the CPU's) equal the CPU's, and the observed words
    are the unobserved ones."""
    from repro_torch import obs
    from repro_torch.lapack import decomp as TD
    rng = np.random.default_rng(30)
    x = rng.standard_normal((64, 64))
    a = TP.from_float64(torch.from_numpy(x))
    s = TP.from_float64(torch.from_numpy(x @ x.T + 64 * np.eye(64)))
    records = []
    for dev in (cuda_device, torch.device("cpu")):
        with obs.scoped() as m:
            lu, piv = TD.rgetrf(a.to(dev), nb=16, gemm_backend="faithful")
            l_p = TD.rpotrf(s.to(dev), nb=16, gemm_backend="faithful")
        records.append((m.to_dict(), lu.cpu(), piv.cpu(), l_p.cpu()))
    (got, *gw), (want, *cw) = records
    assert ti.record_mismatch(got, want) is None
    assert all(torch.equal(g, c) for g, c in zip(gw, cw))
    lu0, _ = TD.rgetrf(a.to(cuda_device), nb=16, gemm_backend="faithful")
    assert torch.equal(lu0.cpu(), gw[0])


@pytest.mark.cuda
def test_cuda_observed_launch_counts_unchanged(cuda_device):
    """A collector changes neither the words nor the GEMM kernel's
    launches of a split3 LU on the card."""
    from repro_torch import obs
    from repro_torch.lapack import decomp as TD
    rng = np.random.default_rng(31)
    a = ti.posits(rng, (256, 256), -2, 2, device=cuda_device)
    runs = []
    for observed in (False, True):
        TG.reset_launch_counts()
        if observed:
            with obs.scoped() as m:
                lu, piv = TD.rgetrf(a, nb=64, gemm_backend="pallas_split3")
            assert len(m.to_dict()["series"]["rgetrf.step"]) == 4
        else:
            lu, piv = TD.rgetrf(a, nb=64, gemm_backend="pallas_split3")
        runs.append((TG.launch_counts(), lu, piv))
    (c0, lu0, p0), (c1, lu1, p1) = runs
    assert c0 == c1 and c0["posit_gemm_f32"] == 3
    assert torch.equal(lu0, lu1) and torch.equal(p0, p1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p32e2", "p16e1", "p8e2"])
def test_cuda_checksums_match_cpu(cuda_device, name):
    from repro_torch import ft
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(32)
    w = ti.posits(rng, (96, 80), -6, 6, fmt)
    w[5, 7] = fmt.nar_pattern
    got, want = ft.checksum(w.to(cuda_device), fmt), ft.checksum(w, fmt)
    for field in ("row", "col", "row_nar", "col_nar", "row_w", "col_w"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field))


@pytest.mark.cuda
def test_cuda_protected_lu_recovers(cuda_device):
    """rgetrf_ft with the kernel: fault-free the unprotected words; one
    injected fault detected and recovered to them."""
    from repro_torch import ft
    from repro_torch.lapack import decomp as TD
    rng = np.random.default_rng(33)
    a = ti.posits(rng, (256, 256), -2, 2, device=cuda_device)
    lu0, piv0 = TD.rgetrf(a, nb=64, gemm_backend="pallas_split3")
    lu, piv, rep = TD.rgetrf_ft(a, nb=64, gemm_backend="pallas_split3")
    assert torch.equal(lu, lu0) and torch.equal(piv, piv0)
    assert rep.detections == 0
    plan = ft.make_plan(0, "rgetrf.step", size=256 * 256, steps=4)
    lu, piv, rep = TD.rgetrf_ft(a, nb=64, gemm_backend="pallas_split3",
                                plan=plan)
    assert rep.detections == 1 and rep.retries == 1
    assert torch.equal(lu, lu0) and torch.equal(piv, piv0)


@pytest.mark.cuda
def test_cuda_guarded_solve_matches_cpu(cuda_device):
    """The guarded ladder with two injected faults (faithful): the card's
    pair words and SolveReport are the CPU's."""
    from repro_torch import ft
    from repro_torch.lapack import refine as TR
    rng = np.random.default_rng(34)
    a = ti.posits(rng, (48, 48), -1, 1)
    b = ti.posits(rng, (48,), -1, 1)
    plan = ft.FaultPlan((ft.Fault("rgetrf.step", 0, 17, 21),
                         ft.Fault("rgetrf.step", 1, 3, 5)))
    (hg, lg), rg = TR.rgesv_guarded(a.to(cuda_device), b.to(cuda_device),
                                    nb=16, gemm_backend="faithful",
                                    plan=plan)
    (hc, lc), rc = TR.rgesv_guarded(a, b, nb=16, gemm_backend="faithful",
                                    plan=plan)
    assert torch.equal(hg.cpu(), hc) and torch.equal(lg.cpu(), lc)
    assert vars(rg) == vars(rc) and rc.detections >= 2


@pytest.mark.cuda
def test_cuda_host_staged_2x2_rgetrf(cuda_device, tmp_path):
    """Four gloo ranks on one GPU (host-staged collectives): a 2x2
    ``p_rgetrf`` at n=256 with every rank's trailing updates on the
    kernel gives the single-device LU's words and pivots."""
    from repro_torch.dist import launch
    from repro_torch.kernels import _build
    from repro_torch.lapack import decomp
    from repro_torch.lapack.error_eval import make_general
    import torch_dist_cases as tc
    n, nb = 256, 64
    _build.lib()                  # build once; the ranks load the cache
    ranks = launch.run(tc.card_rgetrf, 2, 2, tmp_path / "grid",
                       args=(n, nb), backend="gloo", device="cuda",
                       host_staging=True, timeout=600)
    a = TP.from_float64(torch.from_numpy(make_general(n, 1.0, 0))
                        .to(cuda_device))
    lu, ipiv = decomp.rgetrf(a, nb=nb, gemm_backend="pallas_split3")
    for rank in ranks:
        assert np.array_equal(rank["lu"], lu.cpu().numpy())
        assert np.array_equal(rank["ipiv"], ipiv.cpu().numpy())
        assert rank["launches"]["posit_gemm_f32"] == n // nb - 1
        assert rank["launches"]["decode_planes"] == n // nb - 1


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["p16e1", "p8e2"])
def test_cuda_quant_matmul_kernel_matches_plain(cuda_device, fmt):
    """``quant_matmul(backend="pallas")`` on the card: one launch of the
    skinny kernel (no separate encode, pre-pass or tiled GEMM launch), the
    quantized words the CPU's, and the output, like the plain CPU run's,
    within sqrt(K)*8e-8 of the exact product of the activation and weight
    words."""
    from repro_torch.serving import QuantConfig
    from repro_torch.serving import quantize as TQ
    f = TF.FORMATS[fmt]
    rng = np.random.default_rng(40)
    w = torch.from_numpy((rng.standard_normal((896, 128)) * 0.05)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 896)).astype(np.float32))
    qc = QuantConfig(fmt=fmt, backend="pallas")
    leaf = TQ.quantize_leaf({"w": w, "axes": (None, None)}, qc)
    card = TQ.quantize_leaf({"w": w.to(cuda_device), "axes": (None, None)},
                            qc)
    assert torch.equal(card["qw"].cpu(), leaf["qw"])
    assert torch.equal(card["sexp"].cpu(), leaf["sexp"])
    before = TG.launch_counts()
    got = TQ.quant_matmul(x.to(cuda_device), card)
    torch.cuda.synchronize()
    after = TG.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"quant_gemm_f32": 1}
    av = TP.to_float64(TP.from_float32_bits(x, f), f)
    bv = TQ.dequant_leaf(leaf).double()
    bound = np.sqrt(896) * 8e-8
    assert ti.gemm_rel_err(got.cpu(), av, bv) < bound
    assert ti.gemm_rel_err(TQ.quant_matmul(x, leaf), av, bv) < bound


@pytest.mark.cuda
def test_cuda_engine_batched_equals_sequential(cuda_device):
    """A tiny qwen2 with p16e1 weights on the kernel and a p16e1 paged KV
    pool: the engine's batched tokens equal its sequential ones on the
    card, and every linear ran on the kernel."""
    import dataclasses
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import init_params
    from repro_torch.serving import (Engine, QuantConfig, Request,
                                     quantize_params)
    cfg = get_tiny_config("qwen2-0.5b", policy="f32")
    params = quantize_params(init_params(0, cfg, cuda_device),
                             QuantConfig(fmt="p16e1", backend="pallas"))
    rng = np.random.default_rng(41)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, (4 + 3 * i,))
                    .astype(np.int32), max_new=5 + i) for i in range(4)]

    def run(inflight):
        eng = Engine(params, cfg, max_batch=3, page_size=8, max_seq=64,
                     kv_fmt="p16e1", max_inflight=inflight)
        return eng.run([dataclasses.replace(r) for r in reqs])
    TG.reset_launch_counts()
    batched, seq = run(3), run(1)
    assert set(batched) == set(seq) == {0, 1, 2, 3}
    for rid in batched:
        assert np.array_equal(batched[rid], seq[rid]), rid
    counts = TG.launch_counts()
    assert counts["quant_gemm_f32"] > 0
    assert counts["quant_gemm_f32"] % (7 * cfg.n_layers) == 0
    assert counts["posit_gemm_f32"] == counts["decode_planes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["p16e1", "p8e2"])
def test_cuda_skinny_kernel_equals_tiled_chain(cuda_device, fmt):
    """The skinny kernel against the path it replaces (the encode kernel,
    the words widened to int32, the pre-pass and the tiled kernel at
    bk=32, the channel scales), bit for bit, at M in {1, 3, 4, 16} and
    ragged K and N (one to 27 chunks, 16-byte staged rows or not), with
    ±inf and NaN activations and a NaR weight word; one launch each."""
    from repro_torch.serving import QuantConfig
    from repro_torch.serving import quantize as TQ
    f = TF.FORMATS[fmt]
    rng = np.random.default_rng(43)
    for k, n in ((300, 70), (40, 9), (856, 96), (16, 33), (64, 128)):
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
        w[k // 3, n // 2] = np.nan
        leaf = TQ.quantize_leaf({"w": torch.from_numpy(w).to(cuda_device),
                                 "axes": (None, None)},
                                QuantConfig(fmt=fmt, backend="pallas"))
        for m in (1, 3, 4, 16):
            x = rng.standard_normal((m, k)).astype(np.float32)
            if m >= 4:
                x[1, 2], x[2, k - 1], x[3, 0] = np.inf, -np.inf, np.nan
            x = torch.from_numpy(x).to(cuda_device)
            before = TG.quant_gemm_f32.launches
            got = TG.quant_gemm_f32(x, leaf["qw"], leaf["sexp"], f)
            assert TG.quant_gemm_f32.launches == before + 1
            want = TG.posit_gemm_f32(TG.encode_posit_f32(x, f),
                                     leaf["qw"].to(torch.int32), bk=32,
                                     fmt=f) * TG.channel_scales(leaf["sexp"])
            torch.cuda.synchronize()
            g, h = got.cpu(), want.cpu()
            assert torch.equal(g.isnan(), h.isnan()), (k, n, m)
            assert torch.equal(g[~g.isnan()].view(torch.int32),
                               h[~h.isnan()].view(torch.int32)), (k, n, m)
            assert not g.isnan().all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_policy_codec_on_the_kernels(cuda_device, name):
    """``decode_tensor``, ``encode_tensor`` and ``quantize`` on the card:
    one decode / encode kernel launch each, values and words equal to the
    plain codec on a stride sweep of the words (every p32e2 word near
    zero, the tiny words below the decode pair's range included) and on
    the f32 corners, the straight-through gradient the identity."""
    from repro_torch.core import policy as TPOL
    fmt = TF.FORMATS[name]
    wire = TPOL.wire_dtype(fmt)
    if fmt.nbits <= 16:
        w = torch.arange(-(1 << (fmt.nbits - 1)), 1 << (fmt.nbits - 1),
                         dtype=torch.int32)
    else:
        w = torch.cat([torch.arange(-5000, 5000, dtype=torch.int32),
                       torch.arange(-2 ** 31, 2 ** 31 - 1, 65537,
                                    dtype=torch.int32)])
    TG.reset_launch_counts()
    got = TPOL.decode_tensor(w.to(wire).to(cuda_device), fmt)
    assert TG.launch_counts()["decode_split_f32"] == 1
    want = TP.to_float32_bits(w, fmt)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got.cpu()), nan)
    assert torch.equal(got.cpu()[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    x = torch.from_numpy(ti.f32_corners())
    TG.reset_launch_counts()
    words = TPOL.encode_tensor(x.to(cuda_device), fmt)
    assert TG.launch_counts()["encode_posit_f32"] == 1
    assert words.dtype == wire
    assert torch.equal(words.cpu(), TP.from_float32_bits(x, fmt).to(wire))
    xf = x[torch.isfinite(x)].to(cuda_device).requires_grad_(True)
    TG.reset_launch_counts()
    q = TPOL.quantize(xf, fmt)
    counts = TG.launch_counts()
    assert counts["encode_posit_f32"] == counts["decode_split_f32"] == 1
    want_q = TP.to_float32_bits(TP.from_float32_bits(xf.detach().cpu(), fmt),
                                fmt)
    assert torch.equal(q.detach().cpu().view(torch.int32),
                       want_q.view(torch.int32))
    g = torch.randn(xf.shape, device=cuda_device)
    q.backward(g)
    assert torch.equal(xf.grad, g)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One tiny qwen2 ``make_train_step`` (posit32: every linear's
    weights and activations through the codec kernels) on the card and
    on the CPU from the same params and batch: loss, params and moments
    within 1e-5 relative (all leaves as one vector)."""
    from repro_torch import tree
    from repro_torch.configs import ShapeCell, get_tiny_config
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    cfg = get_tiny_config("qwen2-0.5b", policy="posit32")
    outs = []
    TG.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        p = init_params(0, cfg, device="cpu")
        p = tree.map(lambda t, d=dev: t.to(d), p)
        batch = make_batch(cfg, ShapeCell("e2e", "train", 8, 2), 0,
                           device=dev)
        outs.append(make_train_step(cfg, remat=False, lr=1e-3)(
            p, adamw_init(p), batch))
    assert TG.launch_counts()["encode_posit_f32"] > 0
    (cp, co, cm), (gp, go, gm) = outs

    def rel(a, b):
        a = torch.cat([t.detach().cpu().double().ravel() for t in a])
        b = torch.cat([t.detach().double().ravel() for t in b])
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    assert abs(float(gm["loss"]) - float(cm["loss"])) <= 1e-5 * float(
        cm["loss"])
    assert rel(tree.leaves(gp), tree.leaves(cp)) < 1e-5
    assert rel(tree.leaves(go["moments"]), tree.leaves(co["moments"])) < 1e-5


@pytest.mark.cuda
def test_cuda_sharded_train_step_codec_on_the_kernels(cuda_device, tmp_path):
    """Four gloo ranks sharing the card (host-staged collectives) as a 2x2
    ("data", "model") mesh: one sharded ``make_train_step`` of tiny qwen2
    at posit32.  Every codec call of every rank (the gathered weights'
    and the activations' rounding) is bit-identical to the plain codec on
    its operand, each launches its kernel once, and the loss is within
    1e-5 of one process's on the card (the same seeded params: the
    card's generator)."""
    from repro_torch.configs import ShapeCell, get_tiny_config
    from repro_torch.data import make_batch
    from repro_torch.dist import launch
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    import torch_dist_cases as tc
    case = dict(arch="qwen2-0.5b", policy="posit32", mesh=(2, 2),
                seq_shard=True, seq=16, batch=4, steps=1, lr=1e-3, seed=0,
                remat=False)
    _build.lib()                  # build once; the ranks load the cache
    ranks = launch.run(tc.card_sharded_codec, 2, 2, tmp_path / "grid",
                       args=(case,), backend="gloo", device="cuda",
                       host_staging=True, timeout=600)
    cfg = get_tiny_config(case["arch"], policy=case["policy"])
    p = init_params(0, cfg, device=cuda_device)
    _, _, m = make_train_step(cfg, remat=False, lr=1e-3)(
        p, adamw_init(p), make_batch(cfg, ShapeCell("e2e", "train", 16, 4),
                                     0, device=cuda_device))
    for rank in ranks:
        assert rank["calls"] > 0 and not rank["bad"], rank["bad"]
        assert rank["launches"]["encode_posit_f32"] == rank["calls"] // 2
        assert rank["launches"]["decode_split_f32"] == rank["calls"] // 2
        assert abs(rank["losses"][0] - float(m["loss"])) <= 1e-5 * float(
            m["loss"])


@pytest.mark.cuda
def test_cuda_train_cli(cuda_device, tmp_path):
    """``python -m repro_torch.launch.train --smoke --steps 3`` runs on
    the card by default and prints finite losses."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--smoke", "--steps", "3", "--batch", "2",
                          "--seq", "16"], capture_output=True, text=True,
                         timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    import re
    losses = [float(v) for v in re.findall(r"loss (\S+)",
                                           out.stdout.splitlines()[-1])]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), out.stdout
