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
each period slot along a leading axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
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
