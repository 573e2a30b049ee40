"""Move posit words, pivots and quire states between numpy and the port's
tensors.

The reference keeps posit matrices as int32 word arrays, LU pivots as
0-based int32 vectors and a quire as int64 limbs (..., L) with a bool NaR
flag (...); the port keeps the same as tensors.  These helpers convert in
both directions and check dtype and shape on the way, so the same words
(or the same unrounded quire) can be handed to both packages (the tests
do) or a result of one can be loaded into the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch.quire import Quire


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
