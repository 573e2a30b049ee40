"""The port's protected distributed drivers and its checkpoint store.

* ``pdgemm_ft`` and ``p_rpotrf_ft`` / ``p_rgetrf_ft`` on gloo ranks (2x2
  and 1x4, spawned at once): detections, retries and the recovered words
  equal the JAX package's on its 2x2 grid (one ``multi_device``
  subprocess, read back on the host with ``gather_array``) and the
  port's unprotected words;
* a seeded ``make_plan(..., devs=4)`` fires on the same linear id on 2x2
  and 1x4 and both recover to the same global words;
* a driver killed after a step and resumed from its checkpoint gives the
  same words, also when the checkpoint was written by the JAX package;
* the 8 cases of tests/test_checkpoint.py on the port's store, and a
  checkpoint round trip between the packages in both directions.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import store as JS
from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.dist import launch

import torch_dist_cases as tc
import cpu_tests  # noqa: F401  (one PyTorch thread)

GRIDS = [(2, 2), (1, 4)]
GIDS = [f"{p}x{q}" for p, q in GRIDS]

_REF = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.core import posit as P
from repro.dist import distribute, make_grid_mesh
from repro.dist.layout import gather_array
from repro.dist.pblas import pdgemm_ft
from repro.dist.pdecomp import p_rgetrf_ft, p_rpotrf_ft
from repro.ft import Fault, FaultPlan, make_plan

raw = np.load(%(inp)r)
keys = ("a", "b", "g", "spd")
# one encode of the four arrays, flat (the codec is elementwise)
words = np.asarray(P.from_float64(jnp.asarray(
    np.concatenate([raw[k].ravel() for k in keys]))))
w, i = {}, 0
for k in keys:
    w[k] = jnp.asarray(words[i:i + raw[k].size].reshape(raw[k].shape))
    i += raw[k].size
mesh = make_grid_mesh(2, 2)
nb = %(nb)d
def g(d):
    return np.asarray(gather_array(np.asarray(d.data), d.layout))
def rep(r):
    return dict(detections=r.detections, retries=r.retries,
                failed=r.failed, sites=[list(s) for s in r.sites])
out, reps = {}, {}
ad, bd = distribute(w["a"], mesh, nb), distribute(w["b"], mesh, nb)
c, r = pdgemm_ft(ad, bd)
out["pdgemm_ft"], reps["pdgemm_ft"] = g(c), rep(r)
for site in %(sites)r:
    c, r = pdgemm_ft(ad, bd, plan=FaultPlan((Fault(site=site, **%(gf)r),)))
    out["pdgemm_ft." + site], reps["pdgemm_ft." + site] = g(c), rep(r)
spd, gd = distribute(w["spd"], mesh, nb), distribute(w["g"], mesh, nb)
l, r = p_rpotrf_ft(spd)
out["rpotrf_ft"], reps["rpotrf_ft"] = g(l), rep(r)
lu, piv, r = p_rgetrf_ft(gd)
out["rgetrf_ft"], out["rgetrf_ft.ipiv"] = g(lu), np.asarray(piv)
reps["rgetrf_ft"] = rep(r)
l, r = p_rpotrf_ft(spd, plan=FaultPlan((Fault(dev=3, **%(pf)r),)))
out["rpotrf_ft.panel"], reps["rpotrf_ft.panel"] = g(l), rep(r)
lu, piv, r = p_rgetrf_ft(gd, plan=make_plan(**%(seeded)r))
out["rgetrf_ft.seeded0"], out["rgetrf_ft.seeded0.ipiv"] = g(lu), np.asarray(piv)
reps["rgetrf_ft.seeded0"] = rep(r)
killed = p_rgetrf_ft(gd, checkpoint_dir=%(ck)r, _stop_after=1)
assert killed[0] is None
np.savez(%(out)r, **out)
with open(%(out)r + ".json", "w") as f:
    json.dump(reps, f)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, multi_device):
    """(reference 2x2 words, reports, {grid: per-rank results}, the
    port's resume from the reference's checkpoint)."""
    d = tmp_path_factory.mktemp("dist_ft")
    inp = d / "in.npz"
    np.savez(inp, **tc.make_inputs())
    ranks = {g: launch.spawn(tc.dist_ft_words, *g, d / f"grid{g[0]}x{g[1]}",
                             args=(str(inp), str(d / f"ck{g[0]}x{g[1]}")),
                             backend="gloo", device="cpu")
             for g in GRIDS}
    out, ref_ck = d / "ref.npz", d / "ref_ck"
    assert "DONE" in multi_device(_REF % dict(
        inp=str(inp), out=str(out), ck=str(ref_ck), nb=tc.NB,
        sites=tc.GEMM_FT_SITES, gf=tc.GEMM_FAULT, pf=tc.PANEL_FAULT,
        seeded=tc.PLAN_SEED), timeout=900)
    res = {g: r.join(timeout=900) for g, r in ranks.items()}
    resumed = launch.run(tc.resume_lu, 2, 2, d / "resume",
                         args=(str(inp), str(ref_ck)), backend="gloo",
                         device="cpu", timeout=600)
    with open(str(out) + ".json") as f:
        reps = json.load(f)
    return dict(np.load(out)), reps, res, resumed


def _words(res, grid, key):
    got = res[grid][0]["words"][key]
    for r in res[grid][1:]:
        assert np.array_equal(r["words"][key], got), (grid, key, r["rank"])
    return got


def _report(res, grid, key):
    rep = res[grid][0]["reports"][key]
    assert all(r["reports"][key] == rep for r in res[grid][1:]), key
    return rep


def _same_report(got, want):
    assert (got["detections"], got["retries"], got["failed"]) == (
        want["detections"], want["retries"], want["failed"])
    assert [list(s) for s in got["sites"]] == want["sites"]


@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_pdgemm_ft_fault_free(runs, grid):
    ref, reps, res, _ = runs
    got = _words(res, grid, "pdgemm_ft")
    assert np.array_equal(got, _words(res, grid, "pdgemm"))
    assert np.array_equal(got, ref["pdgemm_ft"])
    _same_report(_report(res, grid, "pdgemm_ft"), reps["pdgemm_ft"])
    assert reps["pdgemm_ft"]["detections"] == 0


@pytest.mark.parametrize("site", tc.GEMM_FT_SITES)
@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_pdgemm_ft_recovers(runs, grid, site):
    """A flip in rank 1's gathered copy: detected once, retried once, the
    words of the fault-free GEMM."""
    ref, reps, res, _ = runs
    key = f"pdgemm_ft.{site}"
    got = _words(res, grid, key)
    assert np.array_equal(got, _words(res, grid, "pdgemm"))
    assert np.array_equal(got, ref[key])
    rep = _report(res, grid, key)
    _same_report(rep, reps[key])
    assert rep["detections"] == rep["retries"] == 1


@pytest.mark.parametrize("algo", ["rpotrf", "rgetrf"])
@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_ft_factorizations_fault_free(runs, grid, algo):
    ref, reps, res, _ = runs
    got = _words(res, grid, f"{algo}_ft")
    assert np.array_equal(got, _words(res, grid, algo))
    assert np.array_equal(got, ref[f"{algo}_ft"])
    if algo == "rgetrf":
        piv = _words(res, grid, "rgetrf_ft.ipiv")
        assert np.array_equal(piv, _words(res, grid, "rgetrf.ipiv"))
        assert np.array_equal(piv, ref["rgetrf_ft.ipiv"])
    _same_report(_report(res, grid, f"{algo}_ft"), reps[f"{algo}_ft"])


@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_panel_fault_detected_and_repaired(runs, grid):
    """A ``dist.panel`` flip on rank 3's replica at step 1: detected once,
    retried once, bit-identical words."""
    ref, reps, res, _ = runs
    got = _words(res, grid, "rpotrf_ft.panel")
    assert np.array_equal(got, _words(res, grid, "rpotrf"))
    assert np.array_equal(got, ref["rpotrf_ft.panel"])
    rep = _report(res, grid, "rpotrf_ft.panel")
    _same_report(rep, reps["rpotrf_ft.panel"])
    assert rep["detections"] == rep["retries"] == 1


def test_seeded_plan_same_linear_id_across_grids(runs):
    """``make_plan(..., devs=4)`` on 2x2 and 1x4: the fault fires on the
    same linear id, every run detects it, and both grids (twice each)
    recover to the same global words as the reference's 2x2 run."""
    ref, reps, res, _ = runs
    for grid in GRIDS:
        for run in range(2):
            key = f"rgetrf_ft.seeded{run}"
            assert np.array_equal(_words(res, grid, key),
                                  ref["rgetrf_ft.seeded0"]), (grid, run)
            assert np.array_equal(_words(res, grid, key + ".ipiv"),
                                  ref["rgetrf_ft.seeded0.ipiv"])
            rep = _report(res, grid, key)
            _same_report(rep, reps["rgetrf_ft.seeded0"])
            assert rep["detections"] >= 1
    assert np.array_equal(ref["rgetrf_ft.seeded0"], ref["rgetrf_ft"])


@pytest.mark.parametrize("algo", ["lu", "chol"])
@pytest.mark.parametrize("grid", GRIDS, ids=GIDS)
def test_kill_and_resume_bit_identity(runs, grid, algo):
    _, _, res, _ = runs
    assert res[grid][0]["words"][f"killed.{algo}"] is True
    plain = "rgetrf" if algo == "lu" else "rpotrf"
    assert np.array_equal(_words(res, grid, f"resumed.{algo}"),
                          _words(res, grid, plain))
    if algo == "lu":
        assert np.array_equal(_words(res, grid, "resumed.lu.ipiv"),
                              _words(res, grid, "rgetrf.ipiv"))
    else:       # the public wrapper delegates to the checkpointing path
        assert np.array_equal(_words(res, grid, "resumed.chol.public"),
                              _words(res, grid, "rpotrf"))


def test_resume_from_reference_checkpoint(runs):
    """The JAX package's LU, killed after one step, resumes in the port
    (the checkpoint holds the same dist array) to the unprotected
    words."""
    ref, _, res, resumed = runs
    for rank in resumed:
        assert np.array_equal(rank["lu"], _words(res, (2, 2), "rgetrf"))
        assert np.array_equal(rank["ipiv"], ref["rgetrf_ft.ipiv"])


# --------------------------------------------------------------------------
# the port's checkpoint store: tests/test_checkpoint.py's cases
# --------------------------------------------------------------------------

def _tree(rng):
    return {
        "words": rng.integers(-2**31, 2**31, (48, 48)).astype(np.int32),
        "limbs": rng.integers(-2**62, 2**62, (8, 16)).astype(np.int64),
        "ipiv": rng.integers(0, 48, (48,)).astype(np.int32),
    }


def test_store_roundtrip_bit_exact_int32_words_int64_limbs(tmp_path):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    save_checkpoint(str(tmp_path), 3, tree)
    got, step, extra = restore_checkpoint(str(tmp_path), tree)
    assert step == 3 and extra == {}
    for k in tree:
        assert got[k].dtype == tree[k].dtype, k
        assert np.array_equal(got[k], tree[k]), k


def test_store_roundtrip_torch_tensors_and_extra(tmp_path):
    words = torch.arange(64, dtype=torch.int32).reshape(8, 8)
    save_checkpoint(str(tmp_path), 1, {"a": words},
                    extra={"nb": 32, "fmt": "p32e2"})
    got, step, extra = restore_checkpoint(str(tmp_path), {"a": words})
    assert extra == {"nb": 32, "fmt": "p32e2"}
    assert got["a"].dtype == np.int32
    assert np.array_equal(got["a"], words.numpy())


def test_store_latest_step_and_gc_window(tmp_path):
    tree = _tree(np.random.default_rng(1))
    assert latest_step(str(tmp_path)) is None
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, tree, keep_last=2)
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_store_rejects_dtype_mismatch(tmp_path):
    words = np.arange(16, dtype=np.int32).reshape(4, 4)
    save_checkpoint(str(tmp_path), 1, {"a": words})
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(str(tmp_path), {"a": words.astype(np.int64)})
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(str(tmp_path),
                           {"a": torch.zeros((4, 4), dtype=torch.int64)})


def test_store_rejects_shape_mismatch_and_leaf_count(tmp_path):
    words = np.arange(16, dtype=np.int32).reshape(4, 4)
    save_checkpoint(str(tmp_path), 1, {"a": words})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": words.reshape(2, 8)})
    with pytest.raises(AssertionError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"a": words, "b": words})


def test_store_detects_corruption(tmp_path):
    words = np.arange(16, dtype=np.int32).reshape(4, 4)
    final = save_checkpoint(str(tmp_path), 1, {"a": words})
    leaf = os.path.join(final, "leaf_00000.npy")
    arr = np.load(leaf)
    arr[0, 0] ^= 1 << 7                       # single-bit on-disk flip
    np.save(leaf, arr)
    with pytest.raises(IOError, match="integrity"):
        restore_checkpoint(str(tmp_path), {"a": words})


def test_store_manifest_dtype_pins_file_contents(tmp_path):
    words = np.arange(16, dtype=np.int32).reshape(4, 4)
    final = save_checkpoint(str(tmp_path), 1, {"a": words})
    leaf = os.path.join(final, "leaf_00000.npy")
    np.save(leaf, words.astype(np.int64))
    with open(leaf, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    mpath = os.path.join(final, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["leaves"][0]["sha256_16"] = digest
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(str(tmp_path), {"a": words})


def test_store_interrupted_save_leaves_latest_intact(tmp_path):
    words = np.arange(16, dtype=np.int32).reshape(4, 4)
    save_checkpoint(str(tmp_path), 1, {"a": words})
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1
    got, step, _ = restore_checkpoint(str(tmp_path), {"a": words})
    assert step == 1 and np.array_equal(got["a"], words)


TREES = [{"a": 1, "ipiv": 2}, {"b": [1, 2], "a": (3, None)}, [1, 2], (1,),
         {"x": {"y": 1}}]


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_store_crosses_between_packages(tmp_path, direction):
    """A checkpoint written by either package restores in the other with
    the same leaves and the same manifest (treedef string included)."""
    import jax
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    tree["nested"] = [tree["ipiv"][:3].copy(), (tree["words"][0].copy(),)]
    save, restore = ((save_checkpoint, JS.restore_checkpoint)
                     if direction == "port_to_reference"
                     else (JS.save_checkpoint, restore_checkpoint))
    final = save(str(tmp_path), 7, tree, extra={"step": 7})
    got, step, extra = restore(str(tmp_path), tree)
    assert step == 7 and extra == {"step": 7}
    assert (jax.tree.structure(got) == jax.tree.structure(tree))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with open(os.path.join(final, "manifest.json")) as f:
        assert json.load(f)["treedef"] == str(jax.tree.structure(tree))
    for t in TREES:
        from repro_torch.checkpoint.store import _flatten
        assert _flatten(t)[1] == str(jax.tree.structure(t)), t
