"""Checkpointing: atomic and async; counterpart of
``repro.checkpoint.manager``, writing the reference's on-disk format.

Layout (one directory per step):
    <dir>/step_000042.tmp-<nonce>/   — written first
        arrays.npz                    — the leaves, ``a0``, ``a1``, ...
        manifest.json                 — step, tree structure, shapes, dtypes
    <dir>/step_000042/               — atomic rename on commit

Guarantees:
  * atomicity — a crash mid-write leaves only a .tmp dir (ignored on scan);
    the rename is the commit point.
  * async   — ``save_async`` copies the leaves to host memory synchronously
    and writes on a worker thread; ``wait()`` joins before the next save.
  * one format for both packages — leaves are flattened in the reference's
    order (a dict by sorted key, as ``jax.tree_util`` flattens it, where
    ``torch.utils._pytree`` keeps insertion order), and a bfloat16 leaf is
    stored as its 2-byte patterns, which numpy reads back as ``|V2`` (as it
    reads the reference's ``ml_dtypes`` leaves); the manifest's dtype
    string says how to read them.  A checkpoint written by either package
    restores in the other.
  * placement — a tree of placed leaves (``dist.placement``) is written
    as its logical arrays, so the format does not change with the mesh;
    ``restore(shardings=)`` places each leaf on a mesh, which may differ
    from the one that saved it (elastic resume).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..dist.placement import Placed, get, put


def _canon(tree: Any) -> Any:
    """``tree`` with every dict's keys in sorted order, as JAX orders them."""
    if isinstance(tree, dict):
        return {k: _canon(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_canon(v) for v in tree)
    return tree


def _reorder(tree: Any, like: Any) -> Any:
    """``tree`` (canonical order) with its dicts' keys in ``like``'s order."""
    if isinstance(like, dict):
        return {k: _reorder(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)) and not hasattr(like, "_fields"):
        return type(like)(_reorder(t, lk) for t, lk in zip(tree, like))
    return tree


def _treedef_str(tree: Any) -> str:
    """The manifest's structure string, in the shape of JAX's ``PyTreeDef``."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "None" if t is None else "*"
    return f"PyTreeDef({walk(tree)})"


def _to_host(leaf) -> tuple:
    """(array as stored, dtype name) of one leaf; a placed leaf's logical
    array."""
    if isinstance(leaf, Placed):
        leaf = get(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array
        return a.view("V2"), "bfloat16"
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.array(a, order="C")          # 0-d stays 0-d, unlike ascontiguous
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.astype(dtype, copy=False))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any):
        self.wait()
        host = self._snapshot(tree)
        self._write(step, host)

    def save_async(self, step: int, tree: Any):
        self.wait()
        host = self._snapshot(tree)  # sync D2H; disk IO goes to the thread
        self._thread = threading.Thread(target=self._write, args=(step, host))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, tree: Any):
        leaves, _ = pytree.tree_flatten(_canon(tree))
        leaves = [l for l in leaves if l is not None]
        return [_to_host(l) for l in leaves], _treedef_str(tree)

    def _write(self, step: int, host):
        leaves, treedef = host
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, (a, _) in enumerate(leaves)})
        manifest = {
            "step": step,
            "treedef": treedef,
            "num_leaves": len(leaves),
            "shapes": [list(a.shape) for a, _ in leaves],
            "dtypes": [dt for _, dt in leaves],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, f"step_{step:09d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)              # commit point
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Rebuild the tree of ``like`` (structure donor) from step's arrays,
        each leaf a tensor of the stored type on the device of the matching
        leaf of ``like`` (the CPU where that leaf is no tensor), placed by
        ``like``'s sharding where that leaf is placed.  ``shardings`` (a
        tree of ``NamedSharding`` of the same keys, None leaves kept as
        above) places each leaf on its mesh instead: pass shardings on a
        *different* mesh for an elastic resume."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = [z[f"a{i}"] for i in range(len(z.files))]
        like_leaves, spec = pytree.tree_flatten(_canon(like))
        slots = [i for i, l in enumerate(like_leaves) if l is not None]
        if len(slots) != len(arrays):
            raise ValueError(f"step {step} holds {len(arrays)} leaves; the "
                             f"structure donor has {len(slots)}")
        leaves = list(like_leaves)
        sh_leaves = ([None] * len(like_leaves) if shardings is None else
                     _sharding_leaves(shardings, like))
        for i, a, dt in zip(slots, arrays, dtypes):
            t = _from_host(a, dt)
            ref, sh = like_leaves[i], sh_leaves[i]
            if sh is None and isinstance(ref, Placed):
                sh = ref.sharding
            if sh is not None:
                leaves[i] = put(t, sh, ref.name if isinstance(ref, Placed)
                                else "")
            else:
                leaves[i] = (t.to(ref.device) if isinstance(ref, torch.Tensor)
                             else t)
        return _reorder(pytree.tree_unflatten(leaves, spec), like)


def _sharding_leaves(shardings: Any, like: Any) -> list:
    """``shardings`` flattened in ``like``'s canonical leaf order (a None
    where it has no sharding for a leaf)."""
    def walk(sh, lk):
        if isinstance(lk, dict):
            return {k: walk(sh.get(k) if isinstance(sh, dict) else sh, lk[k])
                    for k in sorted(lk)}
        return _Leaf(sh)
    leaves, _ = pytree.tree_flatten(walk(shardings, like))
    return [l.sharding for l in leaves]


class _Leaf:
    """A sharding held as one pytree leaf (a ``NamedSharding`` is a tuple,
    which the flattening would open)."""
    __slots__ = ("sharding",)

    def __init__(self, sharding):
        self.sharding = sharding
