"""The port's sharded training (``launch.steps.make_train_step`` with a
``DistContext``) and its expert-parallel MoE (``models.ffn.moe_apply_ep``)
on four gloo ranks on the CPU, against the JAX package and one process.

One spawn of a 2x2 grid (``tests/torch_dist_cases.py::sharded_cases``)
runs, on the 2x2, 1x4 and 4x1 ("data", "model") meshes:

* ``moe_apply_ep`` (the granite-moe smoke config at f32, capacity factor
  4) with the sequence replicated and sharded over "model": y and aux
  within 1e-6 relative of the reference's ``moe_apply_ep`` on the same
  mesh (a subprocess with four forced host devices, under
  ``jax.set_mesh``); on 2x2 the gradients of sum(y * c) with respect to
  x, the router and the three expert stacks, gathered, within 1e-5 of the
  reference's; on 1x4 within 1e-5 of one process's local path;
* two steps of the sharded ``make_train_step`` of tiny qwen2 (2x2, the
  sequence sharded over "model") and tiny granite-moe (1x4, expert
  parallelism over four ranks, the sequence replicated: the aux loss is
  then the global one; 4x1, data parallelism alone: the load-balance
  fractions averaged over "data" give the whole batch's aux loss) at
  f32, posit32 and bf16_opt16: the losses and
  the gathered params within 1e-5 relative of one process's
  ``make_train_step`` on the global batch (at bf16_opt16, whose bf16
  products round in another order, the first loss and the change of
  the loss and of the params, within BF16_LIMITS), every rank's gathered
  params equal;
* one step of tiny granite-moe on 2x2 (expert parallelism beside data
  parallelism, the sequence sharded): the loss is one process's with
  its aux term swapped for the EP aux, the reference's mean of the
  per-rank values.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
import torch_dist_cases as tc
from repro_torch import tree
from repro_torch.configs import ShapeCell
from repro_torch.data import make_batch
from repro_torch.dist import launch
from repro_torch.launch import sharding as shd
from repro_torch.launch.context import DistContext
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import (ParamPlan, _cast_params,
                                      _loss_and_grads, make_train_step)
from repro_torch.models import init_params
from repro_torch.optim import adamw_init, adamw_update

import cpu_tests  # noqa: F401  (one intra-op thread)

EP_RTOL = 1e-6
GRAD_RTOL = 1e-5
F32_RTOL = 1e-5
# bf16_opt16 (bf16 products, whose sums round in another order on ranks):
# ``change_readings`` against one process's run, the limits set from the
# readings of sound runs and of a run without updates (PERF.md, section
# 2).  Expert parallelism rounds each expert's output to bf16 before the
# all-to-all back (the reference's EP), where one process's local path
# keeps it f32 until the sum, so its run reads further off.
BF16_LIMITS = {"dense": dict(first_loss=1e-3, loss_update=0.2,
                             param_change=0.2),
               "ep": dict(first_loss=5e-3, loss_update=0.4,
                          param_change=0.5)}
RUN = dict(seq=16, batch=4, steps=2, lr=1e-3, seed=0, remat=False)
RUNS = {f"{arch}.{mesh[0]}x{mesh[1]}.{policy}": dict(
            RUN, arch=arch, policy=policy, mesh=mesh, seq_shard=seq_shard)
        for arch, mesh, seq_shard in (("qwen2-0.5b", (2, 2), True),
                                      ("granite-moe-1b-a400m", (1, 4), False),
                                      ("granite-moe-1b-a400m", (4, 1), False))
        for policy in ("f32", "posit32", "bf16_opt16")}
# expert parallelism with data parallelism: the aux loss is the mean of
# the per-rank values (the reference's), not one process's
EP_RUNS = {f"granite-moe-1b-a400m.2x2.{policy}": dict(
               RUN, arch="granite-moe-1b-a400m", policy=policy, mesh=(2, 2),
               seq_shard=True, steps=1, aux=True)
           for policy in ("f32", "posit32")}

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

# The reference's moe_apply_ep on four forced host devices: y and aux on
# every mesh and sequence choice, the gradients on 2x2.
_REF = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.context import DistContext
from repro.models import ffn as F
from repro.models.common import Axes
d = dict(np.load(sys.argv[1]))
cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                          policy="f32")
keys = ("router", "w_gate", "w_up", "w_down")
axes = ((None, None), ("experts", None, "mlp"), ("experts", None, "mlp"),
        ("experts", "mlp", None))
def params(ws):
    p = {k: {"w": w, "axes": Axes(a)} for k, w, a in zip(keys, ws, axes)}
    p["router"] = {"w": p["router"]}
    return p
ws = tuple(jnp.asarray(d[k]) for k in keys)
x, c = jnp.asarray(d["x"]), jnp.asarray(d["c"])
out = {}
for shape in ((2, 2), (1, 4)):
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])
    for seq in (None, "model"):
        ctx = DistContext(mesh=mesh, dp=("data",), seq=seq)
        tag = f"{shape[0]}x{shape[1]}.{seq}"
        def f(x, ws, ctx=ctx):
            y, aux = F.moe_apply_ep(params(ws), x, cfg, cfg.get_policy(),
                                    jnp.float32, ctx, capacity_factor=%(cf)r)
            return jnp.sum(y * c), (y, aux)
        with jax.set_mesh(mesh):
            if shape == (2, 2):
                (_, (y, aux)), (gx, gw) = jax.jit(jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True))(x, ws)
                out[tag + ".x"] = np.asarray(gx)
                for k, g in zip(keys, gw):
                    out[f"{tag}.{k}"] = np.asarray(g)
            else:
                _, (y, aux) = jax.jit(f)(x, ws)
        out[tag + ".y"], out[tag + ".aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The reference's subprocess and the ranks, started together."""
    d = tmp_path_factory.mktemp("sharded")
    inp = d / "ep.npz"
    np.savez(inp, **tc.ep_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", PYTHONPATH=_SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF % dict(
            cf=tc.EP_CAPACITY)), str(inp), str(d / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = launch.spawn(tc.sharded_cases, 2, 2, d / "grid",
                         args=(str(inp), {**RUNS, **EP_RUNS}), backend="gloo",
                         device="cpu")
    yield ref, ranks, d
    if ref.poll() is None:
        ref.kill()
    for proc in ranks.procs:
        if proc.is_alive():
            proc.kill()
            proc.join()


@pytest.fixture(scope="module")
def results(started):
    ref, ranks, d = started
    res = ranks.join(timeout=900)
    out, err = ref.communicate(timeout=900)
    assert ref.returncode == 0 and "DONE" in out, err[-4000:]
    return dict(np.load(d / "ref.npz")), res


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (nb if nb else 1.0))


def _rel_leaves(got, want):
    return _rel(np.concatenate([np.ravel(g) for g in got]),
                np.concatenate([np.ravel(w) for w in want]))


@pytest.mark.parametrize("seq", tc.EP_SEQS)
@pytest.mark.parametrize("shape", tc.MESHES)
def test_ep_matches_reference(results, shape, seq):
    ref, res = results
    tag = f"{shape[0]}x{shape[1]}.{seq}"
    y, grads = tc.ep_assemble([r["ep"] for r in res], tag, shape)
    assert _rel(y, ref[tag + ".y"]) < EP_RTOL, tag
    want_aux = float(ref[tag + ".aux"])
    for r in res:
        assert abs(r["ep"][tag]["aux"] - want_aux) <= EP_RTOL * want_aux
    if shape == (2, 2):
        want = {k: ref[f"{tag}.{k}"] for k in ("x",) + tc.EXPERT_KEYS}
    else:
        y_local, want = tc.ep_local()
        assert _rel(y, y_local) < EP_RTOL
    for k, g in grads.items():
        assert _rel(g, want[k]) < GRAD_RTOL, (tag, k, _rel(g, want[k]))
    kinds = set(res[0]["ep"][tag]["counts"])
    assert {"all-to-all", "all-reduce"} <= kinds
    assert ("all-gather" in kinds) == (seq is not None)


def _one_process(case):
    """``case``'s steps in one process on the global batches: (losses,
    params, moments)."""
    cfg = TC.get_tiny_config(case["arch"], policy=case["policy"])
    params = init_params(case["seed"], cfg, device="cpu")
    opt = adamw_init(params, cfg.get_policy().opt_compression is not None)
    step = make_train_step(cfg, remat=case["remat"], lr=case["lr"])
    cell = ShapeCell("e2e", "train", case["seq"], case["batch"])
    losses = []
    for i in range(case["steps"]):
        params, opt, m = step(params, opt, make_batch(
            cfg, cell, i, seed=case["seed"], device="cpu"))
        losses.append(float(m["loss"]))
    return losses, tree.leaves(params), tree.leaves(opt["moments"])


def change_readings(got, want, still, init) -> dict:
    """``got`` against ``want`` (each (losses, params)), with ``still``
    the losses of a run from the params ``init`` without updates: the
    first loss's relative error, the last loss's error over what the
    updates moved it (``want``'s last loss minus ``still``'s), and the
    relative error of the params' change (one vector)."""
    (gl, gp), (wl, wp) = got, want
    return {"first_loss": abs(gl[0] / wl[0] - 1),
            "loss_update": abs((gl[-1] - wl[-1]) / (wl[-1] - still[-1])),
            "param_change": _rel_leaves(
                [np.asarray(a) - b for a, b in zip(gp, init)],
                [np.asarray(a) - b for a, b in zip(wp, init)])}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sharded_train_step_matches_one_process(results, name):
    _, res = results
    case = RUNS[name]
    losses, params, moments = _one_process(case)
    got = res[0]["runs"][name]
    assert got["seq"] == ("model" if case["seq_shard"] else None)
    if case["policy"] == "bf16_opt16":
        cfg = TC.get_tiny_config(case["arch"], policy=case["policy"])
        init = [w.numpy() for w in tree.leaves(init_params(
            case["seed"], cfg, device="cpu"))]
        want = (losses, [p.numpy() for p in params])
        still, still_p, _ = _one_process(dict(case, lr=0.0))
        r = change_readings((got["losses"], got["params"]), want, still,
                            init)
        ep = case["arch"] == "granite-moe-1b-a400m" and case["mesh"][1] > 1
        limits = BF16_LIMITS["ep" if ep else "dense"]
        assert all(r[k] < v for k, v in limits.items()), (r, limits)
        # the run without updates fails the limits on the changes
        r0 = change_readings((still, [p.numpy() for p in still_p]), want,
                             still, init)
        assert r0["loss_update"] > limits["loss_update"], r0
        assert r0["param_change"] > limits["param_change"], r0
        assert all(m.dtype == np.int16 for m in got["moments"])
        assert [m.shape for m in got["moments"]] == \
            [tuple(m.shape) for m in moments]
    else:
        np.testing.assert_allclose(got["losses"], losses, rtol=F32_RTOL)
        assert _rel_leaves(got["params"],
                           [p.numpy() for p in params]) < F32_RTOL
    for r in res[1:]:
        other = r["runs"][name]
        assert other["losses"] == got["losses"]
        assert all(np.array_equal(a, b) for a, b in zip(other["params"],
                                                        got["params"]))
    kinds = set(got["counts"])
    model = case["mesh"][1]
    assert "all-reduce" in kinds
    assert ({"all-gather", "reduce-scatter"} <= kinds) == (model > 1)
    assert ("all-to-all" in kinds) == (
        case["arch"] == "granite-moe-1b-a400m" and model > 1)


@pytest.mark.parametrize("name", sorted(EP_RUNS))
def test_sharded_ep_step_loss(results, name):
    """Expert parallelism on 2x2 (the sequence sharded over "model"): the
    step's loss is one process's with the aux term swapped for the EP
    aux (the mean of the per-rank values, the reference's), which differs
    from the whole batch's: ``loss + 0.01 * (aux_ep - aux_local) /
    n_layers``, within 1e-5 relative."""
    from repro_torch.core.policy import torch_dtype
    from repro_torch.models.lm import _backbone, forward_train
    _, res = results
    case = EP_RUNS[name]
    cfg = TC.get_tiny_config(case["arch"], policy=case["policy"])
    cell = ShapeCell("e2e", "train", case["seq"], case["batch"])
    params = _cast_params(init_params(case["seed"], cfg, device="cpu"),
                          torch_dtype(cfg.get_policy().compute_dtype))
    batch = make_batch(cfg, cell, 0, seed=case["seed"], device="cpu")
    with torch.no_grad():
        loss, _ = forward_train(params, batch, cfg)
        _, aux_local = _backbone(params, batch, cfg)
    got = res[0]["runs"][name]
    assert abs(got["aux"] - float(aux_local)) > 1e-3 * float(aux_local)
    want = float(loss) + 0.01 * (got["aux"] - float(aux_local)) / \
        cfg.n_layers
    assert abs(got["losses"][0] / want - 1) < F32_RTOL, (got, want)
    for r in res[1:]:
        other = r["runs"][name]
        assert (other["losses"], other["aux"]) == (got["losses"],
                                                   got["aux"])
        assert all(np.array_equal(a, b) for a, b in zip(other["params"],
                                                        got["params"]))
    assert {"all-to-all", "all-gather", "reduce-scatter",
            "all-reduce"} <= set(got["counts"])


def test_adamw_on_blocks_gives_the_same_words():
    """AdamW on the 2x2 mesh's blocks, with the global gradient norm, is
    AdamW on the whole leaves: the same params and the same p16e1 moment
    words, block for block (tiny qwen2, bf16_opt16, two steps)."""
    cfg = TC.get_tiny_config("qwen2-0.5b", policy="bf16_opt16")
    full = init_params(0, cfg, device="cpu")
    full_opt = adamw_init(full, compress_moments=True)
    cell = ShapeCell("e2e", "train", 16, 4)
    blocks = {}
    for d in range(2):
        for m in range(2):
            mesh = Mesh(("data", "model"), (2, 2),
                        coords={"data": d, "model": m})
            plan = ParamPlan(cfg, DistContext(mesh=mesh, dp=("data",)))
            ospecs = shd.opt_shardings(full_opt, plan.specs, mesh)
            blocks[d, m] = (mesh, plan, ospecs, plan.shard(full),
                            shd.shard_tree(full_opt, ospecs, mesh))
    for i in range(2):
        batch = make_batch(cfg, cell, i, device="cpu")
        _, _, grads = _loss_and_grads(_cast_params(full, torch.bfloat16),
                                      batch, cfg, remat=False)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                               for g in tree.leaves(grads)))
        full, full_opt, _ = adamw_update(full, full_opt, grads, lr=1e-3,
                                         compress_moments=True)
        for key, (mesh, plan, ospecs, p, o) in blocks.items():
            g = shd.shard_tree(grads, plan.specs, mesh)
            p, o, n = adamw_update(p, o, g, lr=1e-3, compress_moments=True,
                                   grad_norm=gnorm)
            blocks[key] = (mesh, plan, ospecs, p, o)
            want_p = plan.shard(full)
            want_o = shd.shard_tree(full_opt, ospecs, mesh)
            assert all(torch.equal(a, b) for a, b in zip(
                tree.leaves(p), tree.leaves(want_p)))
            words = tree.leaves(o["moments"])
            assert all(w.dtype == torch.int16 for w in words)
            assert all(torch.equal(a, b) for a, b in zip(
                words, tree.leaves(want_o["moments"])))
