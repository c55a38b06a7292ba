"""Tree checkpointing in the JAX package's format: a ``.npz`` with
path-encoded keys plus a ``.json`` manifest (``step``, ``treedef``,
``keys``, a sha256 ``digest`` of the ``.npz`` and ``extra``).  Works for
model params, optimizer state and the FL server's state.

A tree is dicts, lists/tuples, dataclasses (``SelectionState``, the
scheme states, ``DynamicsState``) and None, with tensors, numpy arrays
or scalars as leaves.  The flattened keys are the JAX package's strings
for the same tree: dict keys (sorted, as JAX flattens them) and sequence
indices as themselves, a dataclass field as ``.name``, joined with
``/`` (``state/.clusters``), so either package restores the other's
snapshots by key.  A None leaf flattens to nothing.  bf16 is stored as
float32; on restore every leaf comes back in the dtype and on the device
of the tree it restores into.  ``treedef`` is this module's own
structure string: across packages the strings differ, and restore warns
and matches leaves by key, as the JAX package does on a drift.

Writes are crash-safe: the ``.npz`` and the manifest land in pid-scoped
temp files first and are moved into place with ``os.replace``.  A
truncated or bit-rotted ``.npz``, a digest mismatch or an unreadable
manifest raises :class:`CheckpointCorrupt`; a manifest without a digest
still restores.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
import zipfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


class CheckpointCorrupt(RuntimeError):
    """A snapshot on disk is unreadable or fails its integrity check
    (truncated write, bit rot, or a manifest/npz digest mismatch)."""


def _children(node) -> Iterator[Tuple[str, Any]]:
    """(key string, child) pairs of a container, in JAX's order."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield str(k), node[k]
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield str(i), v
    else:                                   # a dataclass
        for f in dataclasses.fields(node):
            yield "." + f.name, getattr(node, f.name)


def _is_container(node) -> bool:
    return (isinstance(node, (dict, list, tuple))
            or (dataclasses.is_dataclass(node)
                and not isinstance(node, type)))


def _leaves_with_paths(tree, prefix=()) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if not _is_container(tree):
        yield "/".join(prefix), tree
        return
    for k, v in _children(tree):
        yield from _leaves_with_paths(v, prefix + (k,))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:     # npz can't store bf16
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves_with_paths(tree):
        if key in flat:
            # two distinct leaves stringifying to one key would silently
            # drop the first on save and restore garbage into both
            raise ValueError(
                f"duplicate flattened checkpoint key {key!r}: the tree "
                "has two leaves whose paths stringify identically")
        flat[key] = _to_numpy(leaf)
    return flat


def treedef(tree) -> str:
    """The tree's structure as a string (leaves ``*``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(treedef(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    if _is_container(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{k[1:]}={treedef(v)}" for k, v in _children(tree)) + ")"
    return "*"


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(path: str, tree, step: int = 0, extra: Dict[str, Any] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    npz_path = path if path.endswith(".npz") else path + ".npz"
    # temp-write + os.replace so a crash mid-save never leaves a torn
    # snapshot under the real name (the tmp name is pid-scoped so two
    # processes checkpointing the same path can't collide mid-write)
    tmp_npz = npz_path + f".tmp{os.getpid()}"
    with open(tmp_npz, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp_npz, npz_path)
    manifest = {
        "step": step,
        "treedef": treedef(tree),
        "keys": list(flat.keys()),
        "digest": _digest(npz_path),
        "extra": extra or {},
    }
    json_path = path.removesuffix(".npz") + ".json"
    tmp_json = json_path + f".tmp{os.getpid()}"
    with open(tmp_json, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp_json, json_path)


def _like_leaf(arr: np.ndarray, like):
    """A stored array in the dtype (and, for a tensor, on the device) of
    the leaf it restores into."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            t = torch.from_numpy(np.asarray(arr, np.float32))
        else:
            np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
            t = torch.from_numpy(arr.astype(np_dtype))   # a C-order copy
        return t.to(device=like.device, dtype=like.dtype)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def _rebuild(like, data, prefix=()):
    if like is None:
        return None
    if not _is_container(like):
        return _like_leaf(data["/".join(prefix)], like)
    if isinstance(like, dict):
        return {k: _rebuild(v, data, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, data, prefix + (str(i),))
                          for i, v in enumerate(like))
    return dataclasses.replace(like, **{
        k[1:]: _rebuild(v, data, prefix + (k,))
        for k, v in _children(like)})


def restore(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays).  Returns ``(tree, step)``.

    Raises :class:`CheckpointCorrupt` when the manifest is unparseable,
    the .npz digest doesn't match the manifest's recorded digest, or the
    .npz itself fails to load."""
    base = path.removesuffix(".npz")
    try:
        with open(base + ".json") as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(
            f"checkpoint manifest {base + '.json'} is unreadable: {e}"
        ) from e
    stored_digest = manifest.get("digest")
    if stored_digest is not None and _digest(base + ".npz") != stored_digest:
        raise CheckpointCorrupt(
            f"checkpoint {base + '.npz'} fails its integrity check: "
            "content digest does not match the manifest (truncated or "
            "corrupted snapshot)")
    try:
        with np.load(base + ".npz") as data:
            stored = {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointCorrupt(
            f"checkpoint {base + '.npz'} is unreadable: {e}") from e
    flat_like = _flatten(like)
    assert set(flat_like) == set(stored), (
        f"checkpoint keys mismatch: {set(flat_like) ^ set(stored)}")
    stored_td = manifest.get("treedef")
    if stored_td is not None and stored_td != treedef(like):
        # the key SET matching while the structure string differs means
        # containers changed shape, or the snapshot came from the JAX
        # package — restoring by key still works, but the caller should
        # know the layouts drifted
        warnings.warn(
            "checkpoint treedef mismatch: stored structure differs from "
            f"the restore target ({stored_td!r} != {treedef(like)!r}); "
            "leaves are matched by flattened key", stacklevel=2)
    return _rebuild(like, stored), manifest["step"]
