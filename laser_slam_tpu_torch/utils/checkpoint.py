"""Checkpoint / resume for estimator state (port of
``utils/checkpoint.py``).

Any tree of tensors or arrays (dicts, lists, NamedTuples; a SLAM
session, a particle cloud, a UKF state, an occupancy grid) round-trips
through one ``.npz`` file. The format is the JAX package's, key for key:
flattened key paths ``a/b/c`` → arrays, ``None`` leaves as the string
``__none__``, and a JSON entry ``__meta_json__`` for static metadata, so
a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

_META_KEY = "__meta_json__"
_NONE = "__none__"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif tree is None:
        out[prefix.rstrip("/")] = np.asarray(_NONE)
    elif isinstance(tree, torch.Tensor):
        # The one place a tensor leaves its device.
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Save a tree of tensors / arrays (dicts, lists, NamedTuples) to
    ``path`` (.npz), with optional JSON-serializable ``meta``."""
    flat = _flatten(tree)
    flat[_META_KEY] = np.asarray(json.dumps(meta or {}))
    np.savez_compressed(path, **flat)


def load_pytree(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Load a checkpoint: returns ``(flat_dict, meta)``. Keys are the
    flattened paths written by :func:`save_pytree` (``a/b/c``); values
    are numpy arrays (``None`` where a ``None`` leaf was saved)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data[_META_KEY]))
    flat = {}
    for k in data.files:
        if k == _META_KEY:
            continue
        v = data[k]
        flat[k] = None if v.shape == () and str(v) == _NONE else v
    return flat, meta
