"""Tree checkpointing (npz + structure manifest, no external deps).

A tree is a nested dict whose leaves are torch tensors or numpy arrays.  Its
leaves are written in sorted-key order at every level, the order in which
``jax.tree.flatten`` lays out a nested dict, so the JAX package's ``restore``
reads a checkpoint of f32 (or any numpy-typed) leaves written here, given the
JAX template of the same tree.  The manifest's ``treedef`` is this module's
own description of the key structure, not JAX's ``PyTreeDef`` string; both
restores ignore it.

bfloat16 leaves (numpy has no such dtype) are stored as the JAX package
stores them: 2-byte void records holding the raw bit patterns, with
``bfloat16`` recorded in ``shapes.json``.  This module's ``restore`` turns
them back into bfloat16 tensors bit for bit, from either package.  The JAX
package's ``restore`` cannot cast such records and raises, for its own bf16
checkpoints too: it never reads them as numbers.

``save`` is crash-atomic: the three files are written into a fresh temp
directory next to the target and swapped into place with ``os.replace``, so a
crash mid-save leaves either the previous complete checkpoint or none — never
a half-written directory that ``restore`` would half-load.  ``restore``
validates both shape *and* dtype against the checkpoint (a silent cast of,
e.g., bf16 KV lanes into f32 templates corrupts restored state undetected).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_BF16_RECORD = np.dtype("V2")      # a bf16 leaf's bits, as the JAX package's npz holds them


def _flatten(tree) -> list:
    """Leaves of a nested dict in sorted-key order (``jax.tree.flatten``'s)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    return "*"


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf's host array and the dtype name recorded for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path: str, tree, step: int = 0, extra: dict | None = None) -> None:
    leaves = [_to_numpy(x) for x in _flatten(tree)]
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    # stage in a sibling temp dir (same filesystem, so the final rename is the
    # single atomic commit point); a stable suffix keeps retries self-cleaning
    tmp = os.path.abspath(path).rstrip(os.sep) + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(leaves)})
    manifest = {"n_leaves": len(leaves), "treedef": json.dumps(_structure(tree)),
                "step": step, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # structure file for restore: we re-flatten the caller's template on load, so we
    # only need leaf order + dtype/shape validation data
    with open(os.path.join(tmp, "shapes.json"), "w") as f:
        json.dump([[list(a.shape), name] for a, name in leaves], f)
    target = os.path.abspath(path).rstrip(os.sep)
    if os.path.isdir(target):  # os.replace cannot clobber a non-empty dir
        old = target + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(target, old)
        os.replace(tmp, target)
        shutil.rmtree(old)
    else:
        os.replace(tmp, target)


def restore(path: str, template):
    """Restore into the structure of ``template`` (shape AND dtype validated).

    Torch leaves of the template come back as tensors on the template leaf's
    device, numpy leaves as arrays.  A dtype mismatch raises instead of
    silently casting: ``shapes.json`` records the dtype each leaf was saved
    with, and loading those bytes into a template of another dtype is state
    corruption, not a convenience.
    """
    data = np.load(os.path.join(path, "leaves.npz"))
    leaves = _flatten(template)
    if len(leaves) != len(data.files):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, template {len(leaves)}")
    with open(os.path.join(path, "shapes.json")) as f:
        saved = json.load(f)
    new_leaves = []
    for i, leaf in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} != template {tuple(leaf.shape)}")
        have = saved[i][1]
        if isinstance(leaf, torch.Tensor):
            want = str(leaf.dtype).removeprefix("torch.")
            if have != want:
                raise ValueError(
                    f"leaf {i}: checkpoint dtype {have} != template dtype {want}; "
                    "refusing to cast silently — convert explicitly if intended")
            if have == "bfloat16" and arr.dtype != _BF16_RECORD:
                raise ValueError(f"leaf {i}: a bfloat16 leaf stored as {arr.dtype}")
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if have == "bfloat16" else torch.from_numpy(arr))
            new_leaves.append(t.to(leaf.device))
        else:
            want = str(np.asarray(leaf).dtype)
            if have != want:
                raise ValueError(
                    f"leaf {i}: checkpoint dtype {have} != template dtype {want}; "
                    "refusing to cast silently — convert explicitly if intended")
            new_leaves.append(arr)
    return _unflatten(template, new_leaves)


def load_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]
