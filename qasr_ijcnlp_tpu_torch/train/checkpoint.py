"""Reading the JAX package's checkpoints.

The reading half of ``qasr_ijcnlp_tpu/train/checkpoint.py``.  Its
``save_pytree`` writes an orbax directory at ``path``, or, where orbax
fails, a pickle of the tree with numpy leaves at ``path + ".pkl"``; the
metadata goes to ``path + ".meta.json"``.  The port reads the pickle with
numpy alone: a tree in the JAX package's layout (Linear weights ``(in,
out)``, blocks stacked on a leading layer axis), which ``models.convert``
maps onto the port's modules.  An orbax directory cannot be read here (the
card has no orbax): :func:`load_pytree` raises, naming the way out.
Unpickle only checkpoints from a trusted source.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Optional

import numpy as np


def _newest_format(path: str) -> str:
    """'orbax' or 'pkl': whichever copy of the checkpoint is newer, as the
    JAX package picks (a pickle from the fallback is never shadowed by an
    older orbax directory, and vice versa)."""
    has_dir = os.path.isdir(path)
    pkl = path + ".pkl"
    has_pkl = os.path.exists(pkl)
    if has_dir and has_pkl:
        return "orbax" if os.path.getmtime(path) >= os.path.getmtime(pkl) else "pkl"
    return "pkl" if has_pkl else "orbax"


def _cast_like(target, tree):
    """``tree``'s leaves cast to the dtypes of ``target``'s (same structure)."""
    if isinstance(target, dict):
        if set(target) != set(tree):
            raise ValueError(f"checkpoint keys {sorted(tree)} != {sorted(target)}")
        return {k: _cast_like(target[k], tree[k]) for k in target}
    if isinstance(target, (list, tuple)):
        if len(target) != len(tree):
            raise ValueError(f"checkpoint list of {len(tree)} != {len(target)}")
        return type(target)(_cast_like(t, r) for t, r in zip(target, tree))
    return np.asarray(tree).astype(np.asarray(target).dtype)


def load_pytree(path: str, target: Optional[Any] = None) -> Any:
    """The tree saved at ``path`` (numpy leaves); with ``target``, a tree
    of the same structure, each leaf cast to the target leaf's dtype."""
    if _newest_format(path) != "pkl":
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is an orbax checkpoint directory, which this package "
                f"cannot read (no orbax on the card); re-save it with the JAX "
                f"package as a numpy pickle ({path}.pkl)")
        raise FileNotFoundError(f"no checkpoint at {path}.pkl")
    with open(path + ".pkl", "rb") as f:
        restored = pickle.load(f)
    return restored if target is None else _cast_like(target, restored)


def load_metadata(path: str) -> Optional[dict]:
    """The checkpoint's ``.meta.json``, or None."""
    meta = path + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f)
    return None
