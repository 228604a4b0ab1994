"""Carry-state checkpointing: resume a streaming demodulation mid-stream
(port of gpu_sdr_tpu/engine/checkpoint.py).

The reference has no in-stream checkpointing: the H5 file is the
checkpoint, and carried DSP state (phase indices, FIR tails, PFB spares)
is lost on stop (SURVEY.md section 5).  Here a chain's state is an
explicit tree, so it serializes losslessly: a stream can stop after
block k and resume at block k+1 bit-identically.

Format: an .npz of the tree's leaves plus a JSON descriptor of the
tree.  Nodes are ``tuple``, ``list``, ``dict`` (string keys) and
``parallel.mesh.Sharded``; leaves are ``torch.Tensor`` (any device) and
the Python scalars ``bool``, ``int`` and ``float``.  The states of the
host-fed demodulators, the fused chains, the replays and the sharded
chains are all such trees.  A sharded state of a mesh across processes
holds None for the shards of other ranks and is refused, as the JAX
package refuses one (its arrays are not fully addressable).
"""

from __future__ import annotations

import json
from typing import Any, List, Tuple

import numpy as np
import torch

from ..parallel.mesh import Sharded

_SCALARS = (("bool", bool), ("int", int), ("float", float))


def _flatten(tree: Any, leaves: List[Any]):
    """The descriptor of `tree` (JSON-able), its leaves appended."""
    if isinstance(tree, Sharded):
        return {"node": "sharded", "parts": _flatten(tree.parts, leaves)}
    if isinstance(tree, (tuple, list)):
        return {"node": type(tree).__name__,
                "items": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, dict):
        keys = list(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError("checkpoint: dict keys must be strings")
        return {"node": "dict", "keys": keys,
                "items": [_flatten(tree[k], leaves) for k in keys]}
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return {"leaf": "tensor", "dtype": str(tree.dtype),
                "shape": list(tree.shape)}
    if tree is None:
        # a shard of another process (parallel/mesh.Mesh.grid): the JAX
        # package cannot save such a state either (np.asarray of an array
        # that is not fully addressable raises)
        raise ValueError(
            "checkpoint: the state holds shards of other processes (a "
            "mesh across processes); a multi-process state is not saved, "
            "as in the JAX package, whose save_state needs every shard of "
            "its arrays in one process")
    for kind, typ in _SCALARS:          # bool first: it is an int too
        if isinstance(tree, typ):
            leaves.append(tree)
            return {"leaf": kind}
    raise TypeError(f"checkpoint: unsupported state leaf {type(tree)}")


def _unflatten(desc, leaves):
    """Rebuild the tree of `desc` from an iterator of leaves."""
    node = desc.get("node")
    if node == "sharded":
        return Sharded(_unflatten(desc["parts"], leaves))
    if node in ("tuple", "list"):
        items = [_unflatten(d, leaves) for d in desc["items"]]
        return tuple(items) if node == "tuple" else items
    if node == "dict":
        return {k: _unflatten(d, leaves)
                for k, d in zip(desc["keys"], desc["items"])}
    return next(leaves)


def _structure(desc):
    """The descriptor without leaf details: the tree's shape alone."""
    if "leaf" in desc:
        return "leaf"
    if desc["node"] == "sharded":
        return ("sharded", _structure(desc["parts"]))
    return (desc["node"], tuple(desc.get("keys", ())),
            tuple(_structure(d) for d in desc["items"]))


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(state: Any, path: str, block_index: int = 0) -> None:
    """Serialize a carry-state tree to `path` (.npz)."""
    leaves: List[Any] = []
    tree = _flatten(state, leaves)
    arrays = {}
    for i, v in enumerate(leaves):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().resolve_conj().resolve_neg().numpy()
        arrays[f"leaf_{i}"] = np.asarray(v)
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"n_leaves": len(leaves),
                    "block_index": int(block_index),
                    "tree": tree}).encode(), dtype=np.uint8)
    np.savez(_npz_path(path), **arrays)


def load_state(path: str, like: Any) -> Tuple[Any, int]:
    """Restore a carry-state tree saved by :func:`save_state`.

    `like` is a template state (from the chain's init_state()) giving
    the tree: each tensor goes back onto its template leaf's device (a
    state may mix devices: a mesh's shards, int64 phases kept on the
    CPU), each scalar comes back as a Python scalar of its kind.  A
    leaf count, tree, kind, shape or dtype that differs from the
    template's raises ValueError.  Returns (state, block_index)."""
    with np.load(_npz_path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        tmpl_leaves: List[Any] = []
        tmpl_tree = _flatten(like, tmpl_leaves)
        n = meta["n_leaves"]
        if n != len(tmpl_leaves):
            raise ValueError(
                f"checkpoint has {n} leaves, expected {len(tmpl_leaves)} "
                "— was it saved for a different measurement configuration?")
        if _structure(meta["tree"]) != _structure(tmpl_tree):
            raise ValueError("checkpoint tree differs from the template's "
                             "— was it saved for a different chain?")
        descs: List[dict] = []
        _leaf_descs(meta["tree"], descs)
        out = []
        for i, (tmpl, desc) in enumerate(zip(tmpl_leaves, descs)):
            out.append(_restore_leaf(i, data[f"leaf_{i}"], desc, tmpl))
    return _unflatten(tmpl_tree, iter(out)), int(meta["block_index"])


def _leaf_descs(desc, out: List[dict]) -> None:
    """The leaf descriptors of `desc`, in leaf order."""
    if "leaf" in desc:
        out.append(desc)
    elif desc["node"] == "sharded":
        _leaf_descs(desc["parts"], out)
    else:
        for d in desc["items"]:
            _leaf_descs(d, out)


def _restore_leaf(i: int, arr: np.ndarray, desc: dict, tmpl):
    if isinstance(tmpl, torch.Tensor):
        want = (str(tmpl.dtype), list(tmpl.shape))
        got = (desc.get("dtype"), list(arr.shape))
        if desc["leaf"] != "tensor" or got != want:
            raise ValueError(
                f"checkpoint leaf {i} mismatch: {desc['leaf']} "
                f"{got[1]}/{got[0]} vs tensor {want[1]}/{want[0]}")
        return torch.from_numpy(arr.copy()).to(tmpl.device)
    kind = next(k for k, typ in _SCALARS if isinstance(tmpl, typ))
    if desc["leaf"] != kind or arr.shape != ():
        raise ValueError(f"checkpoint leaf {i} mismatch: {desc['leaf']} "
                         f"{list(arr.shape)} vs {kind} scalar")
    return dict(_SCALARS)[kind](arr.item())
