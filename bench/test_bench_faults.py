"""``correct`` can fail: each control (the reference in a lower precision,
in the program's place) fails one of the cell's numbers, and a run whose
timed path is broken underneath comes out not correct, once for each
fault the cells can have (one chip: no exchange between chips to leave
out)."""
import argparse

import pytest
import torch

import calibrate
import run
from conftest import CELLS


def _run(tiny, name):
    args = argparse.Namespace(workload=name, seed=2**31 + 77, seconds=0.1,
                              trace=0)
    return run.run(args, device="cpu", cell=tiny(name))[0]


def _holds(row, limits):
    """The sound numbers within their limits, and each control beyond
    the limit of one number at least."""
    assert all(row["numbers"][k] <= v for k, v in limits.items())
    for name, numbers in row["controls"].items():
        assert any(numbers[k] > v for k, v in limits.items()), name


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(tiny, name):
    cell = tiny(name)
    for seed in (3, 2**31 + 5):
        row = calibrate.readings(cell, seed, 1, True, device="cpu")
        _holds(row, cell["limits"])
        if name.startswith("lu_"):
            # the panel and the solve in float32 show in the first step
            panel = row["controls"]["float32_panel_trsm"]
            assert panel["panel0_dev"] > cell["limits"]["panel0_dev"]
            assert panel["trsm0_dev"] > cell["limits"]["trsm0_dev"]


def _lu_unchanged(a_p, **kw):
    n = a_p.shape[-1]
    return a_p.clone(), torch.arange(n, dtype=torch.int32).expand(
        a_p.shape[0], n).clone()


def _half(real):
    def lu(a_p, **kw):
        out, ipiv = real(a_p, **kw)
        keep, ipiv0 = _lu_unchanged(a_p)
        h = a_p.shape[0] // 2
        out[h:], ipiv[h:] = keep[h:], ipiv0[h:]
        return out, ipiv
    return lu


def _altered(real):
    def lu(a_p, **kw):
        out, ipiv = real(a_p, **kw)
        out[0, -1, -1] = -out[0, -1, -1]
        return out, ipiv
    return lu


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_broken_factorization_is_not_correct(tiny, monkeypatch, fault):
    from repro_torch.lapack import decomp
    real = decomp.rgetrf_batched
    fake = {"unchanged": _lu_unchanged, "half": _half(real),
            "altered": _altered(real)}[fault]
    monkeypatch.setattr(decomp, "rgetrf_batched", fake)
    result = _run(tiny, CELLS[0])
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_broken_update_is_not_correct(tiny, monkeypatch, fault):
    from repro_torch.kernels import ops
    real = ops.rgemm

    def fake(a, b, c, *args, **kw):
        if fault == "unchanged":
            return c.clone()
        out = real(a, b, c, *args, **kw)
        if fault == "half":
            h = out.shape[0] // 2
            out[h:] = c[h:]
        else:
            out[0, 0, 0] = -out[0, 0, 0]
        return out
    monkeypatch.setattr(ops, "rgemm", fake)
    result = _run(tiny, CELLS[1])
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card_at_full_size(name):
    """The cell at its own size on the card, three seeds: every sound
    reading within its limit, each control beyond one limit at least."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import workload as wl
    from repro_torch.kernels import _build
    _build.lib()
    cell = wl.load_cell(name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        row = calibrate.readings(cell, seed, 1, True)
        _holds(row, cell["limits"])
