"""Checkpoint/resume for long capture runs.

The reference has no checkpointing (SURVEY.md §5): its stream is
self-synchronizing and its output files append-only.  Here every stage's
state is an explicit nest of NamedTuples of tensors (the demod carried
state, the decoder tail, the fused receiver's ring), so checkpointing a long
run is one `save_state` per N blocks and resume replays nothing.

Plain `.npz` files, one array per leaf.  Leaves are taken depth first in
each NamedTuple's field order, which is the order in which the JAX package's
`runtime/checkpoint.py` flattens the same states (JAX flattens a NamedTuple
by its fields): a checkpoint written by either package loads into the
other's state of the same config.  The `__treedef__` entry describes the
structure for a reader; neither loader needs it.

A bfloat16 leaf (the fused receiver's narrow ring) is written widened to
float32, which is exact and which the JAX package's loader casts back to its
bfloat16 leaf (it cannot cast the 2-byte pattern numpy stores for its own
bfloat16 arrays); read into a bfloat16 leaf, float32 values narrow exactly,
and the JAX package's 2-byte patterns are taken as bfloat16 bits.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def _is_leaf(node) -> bool:
    return not isinstance(node, (tuple, list))


def _children(node):
    # Fields by name: `CF32` overrides indexing, so never `node[i]`.
    if hasattr(node, "_fields"):
        return [getattr(node, f) for f in node._fields]
    return list(node)


def _flatten(node, out: list) -> None:
    if node is None:
        return                      # JAX drops None leaves too
    if _is_leaf(node):
        out.append(node)
        return
    for child in _children(node):
        _flatten(child, out)


def _describe(node) -> str:
    if node is None:
        return "None"
    if _is_leaf(node):
        return "*"
    inner = ", ".join(_describe(c) for c in _children(node))
    return f"{type(node).__name__}({inner})"


def _rebuild(like, leaves):
    if like is None:
        return None
    if _is_leaf(like):
        return next(leaves)
    kids = [_rebuild(c, leaves) for c in _children(like)]
    return type(like)(*kids) if hasattr(like, "_fields") else type(like)(kids)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return np.asarray(leaf)


def save_state(path: str, state) -> None:
    """Save a nest of NamedTuples / tuples of tensors, arrays or scalars to
    `path` (.npz)."""
    leaves: list = []
    _flatten(state, leaves)
    arrays = {f"leaf_{i}": _to_numpy(v) for i, v in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(_describe(state)).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Load a state saved by `save_state` (of either package), shaped like
    `like`.

    `like` supplies the structure, and each tensor leaf its dtype and device
    (a freshly initialized state); leaf values come from the file.  Raises
    if the leaf counts or shapes differ.
    """
    data = np.load(path)
    leaves_like: list = []
    _flatten(like, leaves_like)
    n = len(leaves_like)
    if f"leaf_{n}" in data.files:
        raise ValueError("checkpoint has more leaves than the target state")
    new_leaves = []
    for i, leaf in enumerate(leaves_like):
        stored = data[f"leaf_{i}"]
        if isinstance(leaf, torch.Tensor):
            if tuple(stored.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {stored.shape} != {tuple(leaf.shape)}"
                )
            if leaf.dtype == torch.bfloat16 and stored.dtype.kind == "V":
                bits = torch.from_numpy(np.ascontiguousarray(stored).view(np.int16).copy())
                value = bits.view(torch.bfloat16)
            else:
                value = torch.from_numpy(np.array(stored, copy=True))
            new_leaves.append(value.to(device=leaf.device, dtype=leaf.dtype))
        else:
            new_leaves.append(np.asarray(stored, getattr(leaf, "dtype", None)))
    return _rebuild(like, iter(new_leaves))
