"""Move posit words, pivots, quire states and model params between numpy
and the port's tensors.

The reference keeps posit matrices as int32 word arrays, LU pivots as
0-based int32 vectors and a quire as int64 limbs (..., L) with a bool NaR
flag (...); the port keeps the same as tensors.  These helpers convert in
both directions and check dtype and shape on the way, so the same words
(or the same unrounded quire) can be handed to both packages (the tests
do) or a result of one can be loaded into the other.

``params_from_reference`` loads the reference's model param tree (its
leaves turned into numpy arrays, e.g. ``jax.tree.map(np.asarray, p)``)
into the port's layout: one dict per layer where the reference stacks
each period slot along a leading axis; ``params_to_reference`` stacks
them back.  Any tree in the params' structure goes the same way (the
gradients, the AdamW moments: ``opt_state_from_reference``), and
``train_state_to_reference`` / ``train_state_from_reference`` carry a
whole training state (params, AdamW state), which is what the
checkpoints of ``launch.train`` hold: the reference's layout, so a
checkpoint of either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch import tree as _tree
from repro_torch.models.common import ArchConfig, Axes
from repro_torch.models.lm import period_of
from repro_torch.quire import Quire
from repro_torch.serving.quantize import QMeta


def _check(arr: np.ndarray, what: str, ndim: int | None, shape) -> None:
    if arr.dtype != np.int32:
        raise TypeError(f"{what} must be int32, got {arr.dtype}")
    if ndim is not None and arr.ndim != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape {arr.shape}")
    if shape is not None and tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {arr.shape}, expected "
                         f"{tuple(shape)}")


def words_to_torch(words, device="cuda", shape=None) -> torch.Tensor:
    """int32 posit words (numpy, or anything ``np.asarray`` takes without
    a cast) -> an int32 tensor on ``device``."""
    arr = np.asarray(words)
    _check(arr, "posit words", None, shape)
    return torch.from_numpy(np.array(arr, copy=True)).to(
        _device.resolve(device))


def words_to_numpy(t: torch.Tensor, shape=None) -> np.ndarray:
    """int32 posit-word tensor (any device) -> numpy int32 array."""
    if t.dtype != torch.int32:
        raise TypeError(f"posit words must be int32, got {t.dtype}")
    arr = t.detach().cpu().numpy()
    _check(arr, "posit words", None, shape)
    return arr


def pivots_to_torch(ipiv, device="cuda", n: int | None = None
                    ) -> torch.Tensor:
    """0-based int32 LU pivots (numpy) -> an int32 tensor on ``device``."""
    arr = np.asarray(ipiv)
    _check(arr, "pivots", 1, None if n is None else (n,))
    if arr.size and (arr.min() < 0):
        raise ValueError("pivots must be 0-based and non-negative")
    return torch.from_numpy(np.array(arr, copy=True)).to(
        _device.resolve(device))


def pivots_to_numpy(t: torch.Tensor, n: int | None = None) -> np.ndarray:
    """0-based int32 pivot tensor -> numpy int32 vector."""
    if t.dtype != torch.int32:
        raise TypeError(f"pivots must be int32, got {t.dtype}")
    arr = t.detach().cpu().numpy()
    _check(arr, "pivots", 1, None if n is None else (n,))
    return arr


def quire_to_torch(limbs, nar, device="cuda") -> Quire:
    """A quire state as numpy holds it (int64 limbs (..., L), bool NaR
    flags (...)) -> a ``Quire`` on ``device``."""
    limbs, nar = np.asarray(limbs), np.asarray(nar)
    if limbs.dtype != np.int64:
        raise TypeError(f"quire limbs must be int64, got {limbs.dtype}")
    if nar.dtype != np.bool_:
        raise TypeError(f"quire NaR flags must be bool, got {nar.dtype}")
    if limbs.ndim < 1 or nar.shape != limbs.shape[:-1]:
        raise ValueError(f"limbs {limbs.shape} and nar {nar.shape} do not "
                         "describe one quire per element")
    dev = _device.resolve(device)
    return Quire(limbs=torch.from_numpy(np.array(limbs, copy=True)).to(dev),
                 nar=torch.from_numpy(np.array(nar, copy=True)).to(dev))


def quire_to_numpy(q: Quire) -> tuple[np.ndarray, np.ndarray]:
    """A ``Quire`` (any device) -> (int64 limbs, bool NaR flags) in numpy."""
    if q.limbs.dtype != torch.int64 or q.nar.dtype != torch.bool:
        raise TypeError(f"a quire holds int64 limbs and bool flags, got "
                        f"{q.limbs.dtype} and {q.nar.dtype}")
    return q.limbs.detach().cpu().numpy(), q.nar.detach().cpu().numpy()


_NAME_KEYS = {"axes": Axes, "qmeta": QMeta}     # names: no tensor data


def _tree_to_torch(node, dev, index=None):
    """A reference param subtree -> the port's, taking entry ``index`` of
    the leading (stacked) axis of every array when given.  ``axes`` and
    ``qmeta`` stay names."""
    if isinstance(node, dict):
        return {k: _NAME_KEYS[k](v) if k in _NAME_KEYS
                else _tree_to_torch(v, dev, index) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_to_torch(v, dev, index) for v in node]
    arr = np.asarray(node)
    if index is not None:
        arr = arr[index]
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def params_from_reference(tree, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's model params (numpy leaves, f32 or quantized) ->
    the port's tree on ``device``.  Layer ``i`` is the reference's slot
    ``i % period`` at stack index ``i // period``; the encoder's layers
    are unstacked likewise; the tied embedding, the untied ``unembed``
    and the hybrid's single shared block carry over as they are."""
    dev = _device.resolve(device)
    per = period_of(cfg)
    if len(tree["layers"]) != per:
        raise ValueError(f"expected {per} stacked slots, got "
                         f"{len(tree['layers'])}")
    out = {k: _tree_to_torch(v, dev) for k, v in tree.items()
           if k not in ("layers", "enc")}
    out["layers"] = [_tree_to_torch(tree["layers"][i % per], dev, i // per)
                     for i in range(cfg.n_layers)]
    if "enc" in tree:
        enc = tree["enc"]
        out["enc"] = {
            "pos": _tree_to_torch(enc["pos"], dev),
            "layers": [_tree_to_torch(enc["layers"], dev, i)
                       for i in range(cfg.enc_layers)],
            "final_norm": _tree_to_torch(enc["final_norm"], dev)}
    return out


def tree_to_numpy(tree):
    """A port tree (params, gradients, optimizer state) with every tensor
    turned into a numpy array; names and other leaves kept."""
    return _tree.map(lambda t: t.detach().cpu().numpy(), tree)


def _stack(trees):
    """Trees of one structure -> one tree whose arrays are theirs stacked
    along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: first[k] if k in _NAME_KEYS else
                _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack([np.asarray(t) for t in trees])


def params_to_reference(tree, cfg: ArchConfig) -> dict:
    """A tree in the port's params layout (params, gradients, moments;
    tensors or numpy) -> the reference's, numpy: layer ``i`` goes to slot
    ``i % period`` at stack index ``i // period``, the encoder's layers
    are stacked, the rest carries over."""
    tree = tree_to_numpy(tree)
    per = period_of(cfg)
    out = {k: v for k, v in tree.items() if k not in ("layers", "enc")}
    out["layers"] = [_stack(tree["layers"][j::per]) for j in range(per)]
    if "enc" in tree:
        enc = tree["enc"]
        out["enc"] = {"pos": enc["pos"], "layers": _stack(enc["layers"]),
                      "final_norm": enc["final_norm"]}
    return out


def opt_state_from_reference(state, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's AdamW state (numpy leaves: f32 or int16 moments,
    the 0-d int32 step) -> the port's on ``device``."""
    step = np.asarray(state["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise TypeError(f"the step must be a 0-d int32, got {step.dtype} "
                        f"{step.shape}")
    return {"moments": params_from_reference(state["moments"], cfg, device),
            "step": torch.from_numpy(np.array(step)).to(
                _device.resolve(device))}


def train_state_to_reference(params, opt_state, cfg: ArchConfig) -> tuple:
    """(params, AdamW state) of the port -> the reference's layout, numpy
    (what ``save_checkpoint`` writes and ``restore_checkpoint`` takes as
    its ``tree_like``)."""
    return (params_to_reference(params, cfg),
            {"moments": params_to_reference(opt_state["moments"], cfg),
             "step": tree_to_numpy(opt_state["step"])})


def train_state_from_reference(state, cfg: ArchConfig, device="cuda"
                               ) -> tuple:
    """The reverse of ``train_state_to_reference``."""
    params, opt_state = state
    return (params_from_reference(params, cfg, device),
            opt_state_from_reference(opt_state, cfg, device))
