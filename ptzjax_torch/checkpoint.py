"""Checkpoint / resume for the online state and offline BA. Port of
``ptzjax/checkpoint.py``.

A tree of tensors (nested NamedTuples and tuples: ``SlamState``,
``BAProblem``, the LM carry) is saved to one ``.npz``: leaf ``i`` under
``leaf_i`` in JAX's leaf order (fields in order, depth first), the tree's
structure as the string ``str(jax.tree_util.tree_structure(tree))`` gives
(a JSON string under ``__treedef__``) and the state-layout version under
``__layout_version__``. Those are ``ptzjax``'s keys and formats, so a
checkpoint written by either package loads in the other. Host-side numpy;
no jax import.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

# State-layout version, as ptzjax's: bump whenever the MEANING of a state
# array changes without changing the tree's shape (the structure check
# cannot see such a change).
#   v1: interleaved (theta, phi) EKF state layout.
#   v2: blocked [cam6 | thetas | phis] layout (ekf.py).
STATE_LAYOUT_VERSION = 2


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _structure(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` depth first and return its
    structure in ``jax.tree_util.PyTreeDef``'s notation."""
    if _is_namedtuple(tree):
        kids = ", ".join(_structure(v, leaves) for v in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{kids}])"
    if isinstance(tree, tuple):
        kids = [_structure(v, leaves) for v in tree]
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    leaves.append(tree)
    return "*"


def tree_flatten(tree) -> tuple[list, str]:
    """(leaves in JAX's order, the structure string ``ptzjax`` writes for
    the same tree)."""
    leaves: list = []
    return leaves, f"PyTreeDef({_structure(tree, leaves)})"


def _unflatten(like, leaves):
    """``like``'s structure filled from the iterator ``leaves``."""
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, tuple):
        return tuple(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors (or arrays / scalars) to ``path`` (.npz)."""
    leaves, structure = tree_flatten(tree)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8)
    arrays["__layout_version__"] = np.asarray(STATE_LAYOUT_VERSION, dtype=np.int64)
    np.savez(path, **arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved by ``save_pytree`` (either package's).

    Args:
      like: a tree of the same structure (e.g. a freshly initialized
        state). Each loaded leaf goes to the device of ``like``'s leaf in
        its place (the CPU where that leaf is not a tensor).

    Raises:
      ValueError: on a state-layout version mismatch, a structure mismatch
        or a leaf-shape mismatch (a config or capacity change).
    """
    with np.load(path) as d:
        saved_ver = int(d["__layout_version__"]) if "__layout_version__" in d else 1
        if saved_ver != STATE_LAYOUT_VERSION:
            raise ValueError(
                f"checkpoint state-layout version {saved_ver} != current "
                f"{STATE_LAYOUT_VERSION} (the EKF state layout changed; this "
                "checkpoint cannot be loaded; re-run from the sequence start)"
            )
        saved = json.loads(bytes(d["__treedef__"].tobytes()).decode())
        leaves_like, want = tree_flatten(like)
        if saved != want:
            raise ValueError(f"checkpoint structure mismatch:\n saved: {saved}\n want:  {want}")
        arrays = [d[f"leaf_{i}"] for i in range(len(leaves_like))]
    for i, (a, b) in enumerate(zip(arrays, leaves_like)):
        if hasattr(b, "shape") and tuple(a.shape) != tuple(b.shape):
            raise ValueError(
                f"leaf {i} shape {a.shape} != expected {tuple(b.shape)} "
                "(capacity/config changed since checkpoint)"
            )
    leaves = (
        torch.from_numpy(a).to(b.device if isinstance(b, torch.Tensor) else "cpu")
        for a, b in zip(arrays, leaves_like)
    )
    return _unflatten(like, leaves)
