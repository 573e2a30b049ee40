"""The port's sharded launch layer (``repro_torch.launch.{mesh, context,
sharding, dryrun}`` and the vocab-parallel ``embed``) against the JAX
package's on the CPU.

The sharding rules are pure logic and must give the reference's spec for
every leaf: the params and AdamW moments of all ten architectures at
their published widths (the reference's abstract trees from
``jax.eval_shape``, the port's on the meta device), and the batch, cache
and ``DistContext`` of every applicable shape cell, on both production
meshes (the reference's as ``jax.sharding.AbstractMesh``).  The reference
stacks the layers of a period along a leading axis, which never takes a
mesh axis; the port's spec of layer ``i`` is the reference's spec of slot
``i % period`` without that entry.

Four gloo ranks (``tests/torch_dist_cases.py::launch_cases``, started with
the module) run the vocab-parallel embedding on the 2x2 and 1x4 meshes,
alone and with a tied table's logits, which must give the plain gather's
rows, logits and table gradient bit for bit,
and an FSDP leaf of 4M elements through ``shard_tree``/``gather_tree``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.data.pipeline import input_specs as r_input_specs
from repro.launch import sharding as rshd
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models.common import Axes as RAxes
from repro.optim import adamw_init as r_adamw_init

import repro_torch.configs as TC
import torch_dist_cases as tc
from repro_torch.dist import launch
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.context import DistContext, current, use
from repro_torch.launch.mesh import (dp_axes, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import ffn as t_ffn
from repro_torch.models import init_cache, init_params
from repro_torch.models.lm import period_of
from repro_torch.optim import adamw_init
from repro_torch.tree import Axes

import cpu_tests  # noqa: F401  (one intra-op thread)

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def launch_ranks(tmp_path_factory):
    """One spawn of a 2x2 grid of gloo ranks, started with the module so
    that it runs while the spec tests do."""
    d = tmp_path_factory.mktemp("launch")
    np.savez(d / "in.npz", **tc.embed_inputs())
    ranks = launch.spawn(tc.launch_cases, 2, 2, d / "grid",
                         args=(str(d / "in.npz"),), backend="gloo",
                         device="cpu")
    yield ranks
    for proc in ranks.procs:
        if proc.is_alive():
            proc.kill()
            proc.join()


@pytest.fixture(scope="module")
def launch_runs(launch_ranks):
    return launch_ranks.join(timeout=600)


# --------------------------------------------------------------------------
# the counterparts of tests/test_launch.py
# --------------------------------------------------------------------------

def test_spec_for_axes_rules():
    mesh = make_smoke_mesh()
    P = shd.P
    # TP: mlp -> model
    assert shd._spec_for_axes(Axes((None, "mlp")), (64, 128), mesh,
                              fsdp=False) == P(None, "model")
    # stacked leading dim gets None
    assert shd._spec_for_axes(Axes((None, "mlp")), (12, 64, 128), mesh,
                              fsdp=False) == P(None, None, "model")
    # duplicate mesh axes: first wins (EP over mlp)
    assert shd._spec_for_axes(Axes(("experts", None, "mlp")), (8, 64, 128),
                              mesh, fsdp=False) == P("model", None, None)
    # non-divisible dims are dropped (a 16-wide "model" axis)
    pod = make_production_mesh()
    assert shd._spec_for_axes(Axes(("heads",)), (7,), pod,
                              fsdp=False) == P(None)
    assert shd._spec_for_axes(Axes(("heads",)), (32,), pod,
                              fsdp=False) == P("model")


def test_mesh_helpers():
    m = make_smoke_mesh()
    assert dp_axes(m) == ("data",)
    assert m.shape["model"] == 1 and m.grid is None
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.size) == ({"data": 16, "model": 16}, 256)
    assert multi.axis_names == ("pod", "data", "model")
    assert dp_axes(multi) == ("pod", "data") and multi.size == 512
    # a tuple of axes counts major to minor, as a spec entry does
    m = make_production_mesh(multi_pod=True)
    m.coords.update(pod=1, data=3)
    assert m.axis_index(("pod", "data")) == 16 + 3


def test_dist_context_plumbing():
    assert current() is None
    m = make_smoke_mesh()
    ctx = DistContext(mesh=m, dp=("data",))
    with use(ctx):
        assert current() is ctx
    assert current() is None


@pytest.mark.parametrize("policy,dtype", [("bf16", torch.bfloat16),
                                          ("f32", torch.float32)])
def test_ep_moe_matches_local_on_one_device(policy, dtype):
    """The EP path on a 1x1 mesh must agree with the local path (same
    routing, no drops at capacity_factor=4 with E=4): at bf16 within the
    reference's tolerance, at f32 to the rounding."""
    cfg = dataclasses.replace(TC.get_smoke_config("granite-moe-1b-a400m"),
                              policy=policy)
    moe = init_params(0, cfg, device="cpu")["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).to(dtype)
    pol = cfg.get_policy()
    y_local, aux_l = t_ffn.moe_apply_local(moe, x, cfg, pol, dtype)
    ctx = DistContext(mesh=make_smoke_mesh(), dp=("data",), seq=None)
    y_ep, aux_e = t_ffn.moe_apply_ep(moe, x, cfg, pol, dtype, ctx,
                                     capacity_factor=4.0)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(y_local.float().numpy(),
                                   y_ep.float().numpy(), rtol=0.15,
                                   atol=0.05)
        np.testing.assert_allclose(float(aux_l), float(aux_e), rtol=1e-3)
    else:
        np.testing.assert_allclose(y_local.numpy(), y_ep.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert abs(float(aux_l) - float(aux_e)) <= 1e-6 * float(aux_l)


# --------------------------------------------------------------------------
# the rules against the reference's, leaf for leaf
# --------------------------------------------------------------------------

def _spec(s):
    """A spec of either package as a plain tuple."""
    return tuple(getattr(s, "spec", s))


def _leaf_specs(tree, is_leaf):
    """{path: spec} of a specs tree (list indices in the path)."""
    out = {}

    def walk(t, path):
        if is_leaf(t):
            out[path] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)) and not isinstance(t, (RAxes,
                                                                 Axes)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
    walk(tree, ())
    return out


def _ref_path(path, per: int):
    """The reference's path of a port leaf and whether it is stacked: the
    port's layer ``i`` is slot ``i % per``; the encoder's layers, the
    hybrid's shared caches and the per-layer cross K/V are one stack."""
    if path[:1] == ("layers",):
        return ("layers", path[1] % per) + path[2:], True
    if path[:2] == ("enc", "layers"):
        return ("enc", "layers") + path[3:], True
    if path[:1] in (("shared",), ("cross_kv",)):
        return path[:1] + path[2:], True
    return path, False


def _assert_same(port, ref, per, what):
    assert len(port) >= len(ref) > 0
    for path, spec in port.items():
        rpath, stacked = _ref_path(path, per)
        want = _spec(ref[rpath])
        if stacked:
            assert want[0] is None, (what, rpath, want)
            want = want[1:]
        assert _spec(spec) == want, (what, path, _spec(spec), want)
    hit = {_ref_path(p, per)[0] for p in port}
    assert hit == set(ref), (what, set(ref) - hit)


def _is_param(t):
    return isinstance(t, dict) and set(t) == {"w", "axes"}


def _is_moment(t):
    return isinstance(t, dict) and set(t) == {"m", "v"}


@pytest.fixture(scope="module")
def published():
    """{arch: (reference cfg, reference abstract params, port cfg, port
    meta params)} at the published widths."""
    out = {}
    for arch in TC.ARCH_IDS:
        rc, tcfg = RC.get_config(arch), TC.get_config(arch)
        rp = jax.eval_shape(lambda k, c=rc: r_init_params(k, c),
                            jax.random.PRNGKey(0))
        out[arch] = (rc, rp, tcfg, init_params(0, tcfg, device="meta"))
    return out


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_and_opt_specs_match_reference(published, arch):
    """The moments take f32 here: their specs do not depend on their
    dtype, and the p16e1 moments' abstract trees cost the reference a
    trace of its codec per leaf."""
    rc, rp, tcfg, tp = published[arch]
    ropt = jax.eval_shape(r_adamw_init, rp)
    topt = adamw_init(tp)
    per = period_of(tcfg)
    for kind, (shape, names) in MESHES.items():
        rmesh = AbstractMesh(shape, names)
        mesh = make_production_mesh(multi_pod=kind == "multipod")
        rsh = rshd.param_shardings(rp, rc, rmesh)
        tsh = shd.param_shardings(tp, tcfg, mesh)
        _assert_same({p: v["w"] for p, v in _leaf_specs(tsh, _is_param)
                      .items()},
                     {p: v["w"] for p, v in _leaf_specs(rsh, _is_param)
                      .items()}, per, (arch, kind, "params"))
        ro = rshd.opt_shardings(ropt, rsh, rmesh)
        to = shd.opt_shardings(topt, tsh, mesh)
        assert _spec(to["step"]) == _spec(ro["step"]) == ()
        _assert_same({p: v["m"] for p, v in _leaf_specs(
            to["moments"], _is_moment).items()},
            {p: v["m"] for p, v in _leaf_specs(
                ro["moments"], _is_moment).items()}, per,
            (arch, kind, "moments"))


def _ref_cache(rc, cell):
    cache = jax.eval_shape(lambda: r_init_cache(rc, cell.global_batch,
                                                cell.seq_len))
    if rc.family == "encdec":
        cache = dict(cache)
        kv = jax.ShapeDtypeStruct((rc.n_layers, cell.global_batch,
                                   rc.enc_seq, rc.n_kv_heads, rc.d_head),
                                  jnp.bfloat16)
        cache["cross_kv"] = (kv, kv)
    return cache


def _port_cache(tcfg, cell):
    cache = init_cache(tcfg, cell.global_batch, cell.seq_len, device="meta")
    if tcfg.family == "encdec":
        kv = torch.empty((cell.global_batch, tcfg.enc_seq, tcfg.n_kv_heads,
                          tcfg.d_head), dtype=torch.bfloat16, device="meta")
        cache["cross_kv"] = [(kv, kv) for _ in range(tcfg.n_layers)]
    return cache


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cell_specs_match_reference(arch):
    """``_dp_for``, ``dist_for``, ``batch_shardings`` and (decode cells)
    ``cache_shardings`` of every applicable cell on both meshes."""
    rc, tcfg = RC.get_config(arch), TC.get_config(arch)
    cells = TC.applicable_cells(tcfg)
    assert [c.name for c in cells] == [c.name for c in
                                       RC.applicable_cells(rc)]
    for kind, (shape, names) in MESHES.items():
        rmesh = AbstractMesh(shape, names)
        mesh = make_production_mesh(multi_pod=kind == "multipod")
        for cell in cells:
            rcell = RC.cell_by_name(cell.name)
            assert shd._dp_for(cell.global_batch, mesh) == \
                rshd._dp_for(rcell.global_batch, rmesh)
            rd, td = rshd.dist_for(rc, rcell, rmesh), \
                shd.dist_for(tcfg, cell, mesh)
            assert (td.dp, td.ep, td.seq) == (rd.dp, rd.ep, rd.seq), \
                (arch, cell.name)
            if cell.kind == "decode":
                rsh = rshd.cache_shardings(rc, rcell, rmesh,
                                           _ref_cache(rc, rcell))
                tsh = shd.cache_shardings(tcfg, cell, mesh,
                                          _port_cache(tcfg, cell))
                leaf_r = (lambda t: hasattr(t, "spec"))
                leaf_t = (lambda t: isinstance(t, shd.PartitionSpec))
                _assert_same(_leaf_specs(tsh, leaf_t),
                             _leaf_specs(rsh, leaf_r), period_of(tcfg),
                             (arch, kind, cell.name))
                continue
            rb = rshd.batch_shardings(rc, rcell, rmesh)
            tb = shd.batch_shardings(tcfg, cell, mesh)
            assert set(tb) == set(rb)
            assert all(_spec(tb[k]) == _spec(rb[k]) for k in rb), arch


# --------------------------------------------------------------------------
# per-rank blocks and the vocab-parallel embedding on ranks
# --------------------------------------------------------------------------

def test_meshes_on_ranks(launch_runs):
    """Rank ``d*Q + m`` of a 2x2 grid holds (d, m) of the 2x2 ("data",
    "model") mesh (``jax.make_mesh``'s device order) and (0, rank) of the
    1x4 one; ``make_grid_mesh`` is the grid's own ("row", "col")."""
    for rank, res in enumerate(launch_runs):
        c = res["coords"]
        assert c["grid"] == {"row": rank // 2, "col": rank % 2}
        assert c["2x2"] == {"data": rank // 2, "model": rank % 2}
        assert c["1x4"] == {"data": 0, "model": rank}


def test_fsdp_shard_gather_bit_identical(launch_runs):
    """A (4096, 1024) leaf (4M elements) with the FSDP rule on the 2x2
    mesh: ("data", "model"), a (2048, 512) block a rank, gathered back bit
    for bit with one all-gather a sharded dim."""
    for res in launch_runs:
        f = res["fsdp"]
        assert f["spec"] == ("data", "model")
        assert f["block_shape"] == (2048, 512)
        assert f["identical"]
        # dim 0 over "data" to (4096, 512), then dim 1 over "model"
        assert f["counts"] == {"all-gather": 4 * (4096 * 512 + 4096 * 1024)}


@pytest.mark.parametrize("form", tc.EMBED_FORMS)
@pytest.mark.parametrize("mesh", tc.MESHES)
def test_vocab_parallel_embed_matches_gather(launch_runs, mesh, form):
    """Each rank's rows (and, tied, their logits against the table that
    ``lm._logit_params`` gathers) equal the plain gather's, and the
    gradient on its table rows equals the plain gather's on them, bit for
    bit; the loss is ``embed_loss`` over the rank's batch rows."""
    inp = {k: torch.from_numpy(v) for k, v in tc.embed_inputs().items()}
    p, q = mesh
    rows, v_local = 4 // p, inp["table"].shape[0] // q
    tag = f"{p}x{q}.{form}"
    for res in launch_runs:
        got = res[tag]
        d, m = got["coords"]["data"], got["coords"]["model"]
        t = inp["table"].clone().requires_grad_(True)
        y, logits, loss = tc.embed_loss(
            t, *(inp[k][d * rows:(d + 1) * rows] for k in ("ids", "c",
                                                           "c2")), form)
        loss.backward()
        assert np.array_equal(got["y"], y.detach().numpy()), (tag, d, m)
        if form == "tied":
            assert np.array_equal(got["logits"], logits.detach().numpy())
        want = t.grad.numpy()[m * v_local:(m + 1) * v_local]
        assert np.array_equal(got["grad"], want), (tag, d, m)
        kinds = {"all-reduce"} | ({"all-gather", "reduce-scatter"}
                                  if form == "tied" and q > 1 else set())
        assert set(got["counts"]) == kinds


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------

def test_dryrun_cell_argument_bytes(published, tmp_path):
    """qwen2-0.5b x train_4k x pod on the meta device: the record's
    argument bytes are the local block bytes the reference's specs imply
    (f32 params and moments, the int32 step, the int32 token and target
    blocks), and its collectives are the gather plan's kinds."""
    rc, rp, _, _ = published["qwen2-0.5b"]
    rmesh = AbstractMesh((16, 16), ("data", "model"))
    cell = RC.cell_by_name("train_4k")

    def local_bytes(sds, sharding):
        n = 1
        for size, entry in zip(sds.shape, tuple(sharding.spec)
                               + (None,) * len(sds.shape)):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= size // int(np.prod([rmesh.shape[a] for a in names]))
        return n * np.dtype(sds.dtype).itemsize

    rsh = rshd.param_shardings(rp, rc, rmesh)
    ropt = jax.eval_shape(r_adamw_init, rp)
    rosh = rshd.opt_shardings(ropt, rsh, rmesh)
    rb = r_input_specs(rc, cell)
    rbsh = rshd.batch_shardings(rc, cell, rmesh)
    want = sum(local_bytes(a, s) for a, s in zip(
        jax.tree.leaves((rp, ropt)), jax.tree.leaves(
            (rsh, rosh), is_leaf=lambda t: hasattr(t, "spec"))))
    want += sum(local_bytes(rb[k], rbsh[k]) for k in rbsh)
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "pod",
                          outdir=str(tmp_path), verbose=False)
    assert rec["argument_size_bytes"] == want
    assert (tmp_path / "qwen2-0.5b_train_4k_pod.json").exists()
    assert rec["n_devices"] == 256 and rec["flops"] > 0
    assert set(rec["collective_bytes"]) == {"all-gather", "reduce-scatter",
                                            "all-reduce"}
    assert rec["temp_size_bytes"] is None and rec["bytes_accessed"] is None
