"""The port's examples (``examples/torch_*.py``, one for each of the JAX
package's ten example scripts) run on the CPU at a small size and held to
the JAX package on the same numpy inputs, or to their own claims where
the reference's call would cost more than a few seconds to compile.

Each script is loaded by path and its ``main(argv)`` called once, with
``--device cpu``; the examples held to the reference's drivers run at
n=16, nb=8, so that those compile once for the file.

* Bit-identical: the posit words and ``x + x`` of the quickstart's
  section 1, the ``faithful`` GEMM words, ``faithful`` ``e_posit`` of the
  §5.1 study (the quickstart and ``cholesky_lu_accuracy``), and the
  ``quire_exact`` words (``dist_solve``'s distributed GEMM).
* Within the reference's bounds: ``xla_quire`` words within one ulp, the
  split3 GEMM within sqrt(K)*8e-8 of the exact product.  ``e_binary32``
  comes from two library LAPACKs in f32 (torch's and XLA's), whose pivots
  and sum orders differ: at n=16 the backward error is the norm of 16
  residuals, and the two libraries' errors were 0.006-0.40 decimal digits
  apart over the §5.1 sigma grid (on the CPU; 0.01-0.22 at n=32), so they
  are held to 0.5 digits.
* Their own claims: the quickstart's formats ordered by width, its
  ``xla_quire`` p32e2 study within 0.5 digits of the ``faithful`` one
  (as tests/test_torch_refine_study.py holds studies to the reference's),
  least squares on the floor, refinement gains >= 2 digits at sigma=1
  (tests/test_quire.py:172-181), faults detected and recovered bit for
  bit, distributed words equal to one process's, 2.0x storage, batched
  == sequential tokens, losses finite and falling.
"""
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as JO
from repro.configs import get_config as j_get_config
from repro.core import posit as JP
from repro.kernels.ops import rgemm as j_rgemm
from repro.lapack import error_eval as JE
from repro.models import init_params as j_init_params
from repro.quire import gemm as JQ
from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.core import posit as TP
from repro_torch.models import init_params
from repro_torch.serving import generate

import torch_inputs as ti
from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")

N, NB = 16, 8                   # the examples held to reference drivers
DIGITS = 0.5                    # xla_quire vs faithful studies
B32_DIGITS = 0.5                # binary32 baselines: two library LAPACKs
SIZE = ["--n", str(N), "--nb", str(NB)]
# The examples held to their own claims run in a process of their own,
# started with the module, so that they (and dist_solve's ranks) run while
# the other tests do; here they would also share this process's
# positscope collectors.  The refinement examples' quire sweeps (n rows a
# sweep, 16 right-hand sides in quire_refine, 5 sigmas x 6 sweeps in
# observe_solve) are the slowest loop on the CPU, so they run at n=8.
BACKGROUND = {
    "dist_solve": [*SIZE, "--p", "1", "--q", "2"],
    "fault_tolerant_solve": SIZE,
    "quire_refine": ["--n", "8", "--nb", "4"],
    "observe_solve": ["--n", "8"],          # the trace file: added below
}


def run(name, *argv):
    return ti.load_example(name).main([*argv, "--device", "cpu"])


def digits_apart(x, y) -> float:
    return abs(math.log10(max(x, 1e-300) / max(y, 1e-300)))


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """BACKGROUND's examples' ``main`` in one process of its own, in turn;
    their results come back through a file."""
    tmp = tmp_path_factory.mktemp("examples")
    runs = dict(BACKGROUND, observe_solve=[*BACKGROUND["observe_solve"],
                                           "--trace", str(tmp / "trace.json")])
    code = ("import json, sys, torch, torch_inputs as ti; torch.save("
            "{k: ti.load_example(k).main([*v, '--device', 'cpu']) for k, v "
            "in json.loads(sys.argv[2]).items()}, sys.argv[1])")
    here = os.path.dirname(os.path.abspath(__file__))
    path = [here, os.path.join(os.path.dirname(here), "src"),
            os.environ.get("PYTHONPATH", "")]
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / "out.pt"), json.dumps(runs)],
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, path))),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def background_runs(background):
    proc, tmp = background
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(torch.load(tmp / "out.pt", weights_only=False),
                trace=tmp / "trace.json")


# --------------------------------------------------------------------------
# every script
# --------------------------------------------------------------------------

def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("name", ti.EXAMPLES)
def test_example_imports_neither_jax_nor_the_jax_package(name):
    path = ti.EXAMPLES_DIR / f"torch_{name}.py"
    mods = set(_imports(ast.parse(path.read_text())))
    bad = {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.name} imports {sorted(bad)}"
    assert any(m.startswith("repro_torch") for m in mods), path.name


@pytest.mark.parametrize("name", ti.EXAMPLES)
def test_example_wants_a_gpu_by_default(name, tmp_path, capsys):
    """Without ``--device cpu`` a script asks for the GPU and raises where
    torch sees none; it never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    argv = {"observe_solve": ["--trace", str(tmp_path / "t.json")],
            "train_100m": ["--ckpt-dir", str(tmp_path)]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        ti.load_example(name).main(argv)
    assert "loss" not in capsys.readouterr().out


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    return run("quickstart", *SIZE, "--m", str(3 * N // 2))


def test_quickstart_codec_bit_identical(quickstart):
    x = np.array([1.0, 3.141592653589793, -0.001, 1e6])
    words = np.asarray(JP.from_float64(jnp.asarray(x)))
    # jitted: eager, the reference compiles each op anew (cpu_tests.py)
    add = jax.jit(JP.add, static_argnames=("fmt", "backend"))
    eps = jax.jit(JP.rounding_eps, static_argnames="fmt")
    assert np.array_equal(quickstart["words"], words)
    assert np.array_equal(quickstart["sum_words"],
                          np.asarray(add(words, words)))
    assert np.array_equal(quickstart["decoded"],
                          np.asarray(JP.to_float64(words)))
    assert np.array_equal(quickstart["rel_eps"],
                          np.asarray(eps(jnp.asarray(x))))


def test_quickstart_gemm_backends(quickstart):
    a, b = quickstart["gemm_a"], quickstart["gemm_b"]
    got = quickstart["gemm_words"]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(got["faithful"],
                          np.asarray(j_rgemm(ja, jb, backend="faithful")))
    want = np.asarray(j_rgemm(ja, jb, backend="xla_quire")).astype(np.int64)
    assert np.abs(got["quire"].astype(np.int64) - want).max() <= 1
    av, bv = (TP.to_float64(torch.from_numpy(w)) for w in (a, b))
    err = ti.gemm_rel_err(TP.to_float64(torch.from_numpy(got["pallas"])),
                          av, bv)
    assert err < np.sqrt(N) * 8e-8
    assert set(quickstart["gemm_err"]) == {"quire", "faithful", "pallas"}


@pytest.fixture(scope="module")
def lu_faithful_reference():
    return {sigma: JE.backward_error_study(N, sigma, "lu", nb=NB,
                                           gemm_backend="faithful")
            for sigma in (1.0, 1e6)}


@pytest.mark.parametrize("sigma", [1.0, 1e6])
def test_quickstart_faithful_study_bit_identical(quickstart,
                                                 lu_faithful_reference,
                                                 sigma):
    got, want = quickstart["lu"][sigma], lu_faithful_reference[sigma]
    assert got.e_posit == want.e_posit
    assert digits_apart(got.e_binary32, want.e_binary32) < B32_DIGITS


def test_quickstart_formats(quickstart, lu_faithful_reference):
    """Own claims (each format compiles the reference's study anew): the
    error grows as the format narrows, and the p32e2 study on the
    ``xla_quire`` GEMM lands within 0.5 digits of the ``faithful`` one,
    which equals the reference's bit for bit."""
    e = {fmt: r.e_posit for fmt, r in quickstart["formats"].items()}
    assert list(e) == ["p32e2", "p16e1", "p8e2"]
    assert e["p32e2"] < e["p16e1"] < e["p8e2"], e
    assert digits_apart(e["p32e2"],
                        lu_faithful_reference[1.0].e_posit) < DIGITS


def test_quickstart_least_squares_and_observability(quickstart):
    ls = quickstart["ls"]
    # rgels_ir lands on the least-squares floor of the posit-held problem
    assert digits_apart(ls["rgels_ir"], ls["optimum"]) < 0.1, ls
    assert ls["rgels"] > ls["rgels_ir"], ls
    d = quickstart["observed"]
    assert d["counters"]["ir.sweeps"] == 3
    assert len(d["series"]["ir.sweep"]) == 3
    assert 0.0 < d["gauges"]["rgetrf.last_panel.golden_zone"] <= 1.0
    assert d["spans"] > 0
    assert quickstart["weight_ratio"] == 2.0


# --------------------------------------------------------------------------
# cholesky_lu_accuracy
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def accuracy():
    return run("cholesky_lu_accuracy", *SIZE)


@pytest.mark.parametrize("algo", ["cholesky", "lu"])
@pytest.mark.parametrize("sigma", [1e-2, 1.0, 1e2, 1e4])
def test_accuracy_study_bit_identical(accuracy, lu_faithful_reference,
                                      algo, sigma):
    got = accuracy[algo, sigma]
    want = JE.backward_error_study(N, sigma, algo, nb=NB,
                                   gemm_backend="faithful")
    assert got.e_posit == want.e_posit
    assert digits_apart(got.e_binary32, want.e_binary32) < B32_DIGITS


# --------------------------------------------------------------------------
# quire_refine, observe_solve: own claims (the reference's refinement
# drivers compile a scan a call)
# --------------------------------------------------------------------------

def test_quire_refine_claims(background_runs):
    out = background_runs["quire_refine"]
    for algo, r in out["studies"].items():
        assert r.digits_gained >= 2.0, (algo, r)
        assert r.e_ir < 1e-12, (algo, r)
    assert len(out["batched"]) == 16 and out["batched"].max() < 1e-12
    assert digits_apart(out["plain"], out["batched"][0]) >= 2.0
    assert digits_apart(out["mp"], out["batched"][0]) < DIGITS


def test_observe_solve_claims(background_runs):
    """The occupancy of each sigma's A equals the reference's statistic on
    the same words; six ir.sweep rows a solve; >= 2 digits at sigma=1."""
    out = background_runs["observe_solve"]
    assert background_runs["trace"].exists() and out["trace_events"] > 0
    # JO.golden_zone_fraction's statistic, compiled once for the five
    occupancy = jax.jit(lambda w: JO.step_stats(w)["golden_frac"])
    for sigma, row in out["sigmas"].items():
        assert [r["sweep"] for r in row["sweeps"]] == list(range(6))
        want = occupancy(jnp.asarray(row["a_words"]))
        assert row["occupancy"] == float(want), sigma
    best = out["sigmas"][1.0]["sweeps"][-1]["digits_gained"]
    assert best >= 2.0 and out["sigmas"][1.0]["error"] < 1e-12


# --------------------------------------------------------------------------
# fault_tolerant_solve, dist_solve: own claims (the guarded ladder and the
# distributed drivers cost the reference far more than a few seconds)
# --------------------------------------------------------------------------

def test_fault_tolerant_solve_claims(background_runs):
    out = background_runs["fault_tolerant_solve"]
    assert out["gemm"] == dict(detections=1, retries=1, identical=True)
    assert out["lu"]["detections"] >= 1 and out["lu"]["identical"]
    assert out["benign"]["report"].outcome == "converged"
    assert out["benign"]["residual"] < 1e-9
    assert out["faulted"]["report"].detections >= 1
    assert out["faulted"]["identical"]


def test_dist_solve_words_equal_one_process_and_quire_exact(background_runs):
    """A 1x2 grid of gloo ranks on the host: its words equal one
    process's, and the k-split quire GEMM's the reference's quire."""
    out = background_runs["dist_solve"]
    assert out["identical"] == dict(x_hi=True, x_lo=True, lu=True, c=True)
    assert out["residuals"].max() < 1e-12
    a = jnp.asarray(out["a_words"])
    want = np.asarray(JQ.quire_gemm(a, a, kc=1, unroll=1))
    assert np.array_equal(out["c_words"], want)


# --------------------------------------------------------------------------
# serving and training
# --------------------------------------------------------------------------

def test_serve_posit_claims():
    out = run("serve_posit")
    assert out["weight_ratio"] == 2.0 and out["kv_ratio"] == 2.0
    rep = out["replay"]
    assert rep["requests"] == 6 and rep["tokens"] > 0
    assert set(rep["outputs"]) == set(out["sequential"])
    for rid, toks in out["sequential"].items():
        assert np.array_equal(rep["outputs"][rid], toks), rid


def test_serve_batched_rows_equal_served_alone():
    out = run("serve_batched")
    prompts = np.array([[5, 6, 7, 8], [1, 2, 3, 4]], np.int32)
    for arch, toks in out.items():
        cfg = get_smoke_config(arch)
        assert toks.shape == (2, 8) and (0 <= toks).all()
        assert (toks < cfg.vocab).all()
        params = init_params(0, cfg, device="cpu")
        for row in range(2):
            alone = generate(params, cfg, prompts[row:row + 1], max_new=8)
            assert np.array_equal(alone[0], toks[row]), (arch, row)


@pytest.fixture(scope="module")
def posit_training():
    return run("posit_training", "--steps", "3")


@pytest.mark.parametrize("policy", ["bf16", "posit32", "bf16_opt16"])
def test_posit_training_losses_fall(posit_training, policy):
    losses = posit_training[policy]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0], losses


def test_train_100m_param_count_and_losses(tmp_path):
    """The published 100M config's parameter count equals the reference's
    (its init traced, not run); a run of the script at small widths
    trains and writes no checkpoint before step 50."""
    mod = ti.load_example("train_100m")
    j_cfg = dataclasses.replace(
        j_get_config("qwen2-0.5b"), name="qwen2-100m", n_layers=8,
        d_model=512, n_heads=8, n_kv_heads=2, d_head=64, d_ff=2048,
        vocab=32000)
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(
        jax.eval_shape(lambda k: j_init_params(k, j_cfg),
                       jax.random.PRNGKey(0))))
    got = sum(leaf.numel() for leaf in tree.leaves(
        init_params(0, mod.config_100m(), device="meta")))
    assert got == want
    out = mod.main(["--steps", "3", "--layers", "2", "--d-model", "128",
                    "--vocab", "512", "--ckpt-dir", str(tmp_path),
                    "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0], losses
