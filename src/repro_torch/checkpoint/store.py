"""Step-atomic checkpointing with manifest + integrity hashes
(counterpart of ``repro.checkpoint.store``, in the same on-disk form, so
a checkpoint written by either package restores in the other).

Layout:   <dir>/step_<N>/leaf_<i>.npy  +  manifest.json
Writes go to a temp dir and are atomically renamed, so a crash mid-save
never corrupts the latest checkpoint.  ``keep_last`` old steps are
garbage-collected after a successful save.

A tree is nested dicts, lists and tuples (``None`` and a param's
``Axes`` names hold no leaf, as in the reference) of leaves — torch
tensors (any device), numpy arrays or scalars — flattened in the
reference's order (dict keys sorted), its structure written to the
manifest in the reference's ``PyTreeDef(...)`` notation.  A training
state goes through ``interop.train_state_to_reference`` first, so that
it is stacked as the reference's.  Restore returns
numpy arrays in the structure of ``tree_like`` and refuses a leaf whose
shape, dtype or hash does not match: posit words are int32 and quire
limb planes int64, and a silent cast would corrupt bit-exact state.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]


def _any(leaf) -> bool:
    return True


def _flatten(tree):
    """(leaves, structure string) in the reference's order; every value
    that is not a node is a leaf."""
    return flatten(tree, _any)


def _unflatten(like, leaves):
    return unflatten(like, leaves, _any)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape_dtype(ref):
    if isinstance(ref, torch.Tensor):
        return (tuple(ref.shape),
                torch.empty((), dtype=ref.dtype).numpy().dtype)
    arr = np.asarray(ref)
    return arr.shape, arr.dtype


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def save_checkpoint(ckpt_dir: str, step: int, tree, keep_last: int = 3,
                    extra: dict | None = None) -> str:
    leaves, treedef = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": treedef,
                "n_leaves": len(leaves), "leaves": [],
                "extra": extra or {}}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        path = os.path.join(tmp, f"leaf_{i:05d}.npy")
        np.save(path, arr)
        manifest["leaves"].append({
            "i": i, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256_16": _digest(path)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep_last)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (validates shape and
    dtype).  Returns (tree of numpy arrays, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, _ = _flatten(tree_like)
    if manifest["n_leaves"] != len(leaves):
        raise AssertionError(f"checkpoint has {manifest['n_leaves']} "
                             f"leaves, model expects {len(leaves)}")
    out = []
    for i, ref in enumerate(leaves):
        path = os.path.join(d, f"leaf_{i:05d}.npy")
        arr = np.load(path)
        meta = manifest["leaves"][i]
        if _digest(path) != meta["sha256_16"]:
            raise IOError(f"integrity check failed for {path}")
        shape, dtype = _shape_dtype(ref)
        if list(arr.shape) != list(shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"model {shape}")
        if str(arr.dtype) != meta["dtype"]:
            raise ValueError(f"leaf {i}: file dtype {arr.dtype} != manifest "
                             f"{meta['dtype']}")
        if arr.dtype != dtype:
            raise ValueError(f"leaf {i}: checkpoint dtype {arr.dtype} != "
                             f"model {dtype}")
        out.append(arr)
    return _unflatten(tree_like, out), step, manifest["extra"]


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted([d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                    and not d.endswith(".tmp")])
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
