"""Checkpoints: the JAX package's numpy-pickle form, JSON histories,
best-metric tracking and the full train state.

Port of ``qasr_ijcnlp_tpu/train/checkpoint.py``.  Its ``save_pytree``
writes an orbax directory at ``path``, or, where orbax fails, a pickle of
the tree with numpy leaves at ``path + ".pkl"``; the metadata goes to
``path + ".meta.json"``.  The port writes and reads that pickle with numpy
alone (the card has no orbax): a tree in the JAX package's layout (Linear
weights ``(in, out)``, blocks stacked on a leading layer axis), which
``models.convert`` maps onto and from the port's modules, so the JAX
package's ``load_pytree`` reads the best-metric checkpoints the port's
trainers write.  An orbax directory cannot be read here: :func:`load_pytree`
raises, naming the way out.  Unpickle only checkpoints from a trusted
source.

The full train state (:func:`save_train_state`: parameters, both Adam
moments, the optimizer's count and the step) is written in the port's own
layout, by parameter name: optax orders its leaves its own way, and the
state is for resuming within the port.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch


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


def _np_tree(tree):
    """``tree`` with numpy leaves (tensors moved to the host in fp32 where
    they are floating, as ``models.convert`` writes them)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy().copy()
    return np.asarray(tree)


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    """Write ``tree`` (numpy or tensor leaves) as ``path + ".pkl"`` and the
    metadata as ``path + ".meta.json"``: the JAX package's pickle form."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pkl", "wb") as f:
        pickle.dump(_np_tree(tree), f)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


@dataclass
class BestTracker:
    """Keeps the best checkpoint per metric (lower- or higher-is-better)."""

    directory: str
    metrics: Dict[str, str]  # name -> "min" | "max"
    best: Dict[str, float] = field(default_factory=dict)
    # False: track and make the tree (a collective under a mesh) but write
    # nothing, on every rank of a mesh but its leader
    write: bool = True

    def seed_from_disk(self) -> Dict[str, float]:
        """Re-seed ``best`` from existing ``best_<metric>.meta.json`` files,
        so that a resumed run's first validation competes against the best
        from before the interruption."""
        for name in self.metrics:
            meta = load_metadata(os.path.join(self.directory, f"best_{name}"))
            if meta is not None and "value" in meta:
                try:
                    self.best[name] = float(meta["value"])
                except (TypeError, ValueError):
                    pass
        return dict(self.best)

    def update(self, values: Dict[str, float], tree: Any,
               metadata: Optional[dict] = None) -> Dict[str, bool]:
        """Check each tracked metric; save ``best_<metric>`` on improvement.
        ``tree`` is the checkpoint's content, or a callable that makes it
        (called only when a metric improved)."""
        improved = {}
        for name, mode in self.metrics.items():
            if name not in values:
                continue
            v = float(values[name])
            cur = self.best.get(name)
            better = cur is None or (v < cur if mode == "min" else v > cur)
            improved[name] = better
            if better:
                self.best[name] = v
                if callable(tree):
                    tree = tree()
                if self.write:
                    save_pytree(os.path.join(self.directory, f"best_{name}"), tree,
                                {**(metadata or {}), "metric": name, "value": v})
        return improved


class TrainingHistory:
    """Per-epoch metric log with JSON persistence."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.epochs: list = []
        self.config: dict = {}

    def log(self, **metrics) -> dict:
        entry = {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                 for k, v in metrics.items()}
        self.epochs.append(entry)
        if self.path:
            self.save(self.path)
        return entry

    def to_dict(self) -> dict:
        return {"config": self.config, "epochs": self.epochs}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @classmethod
    def load(cls, path: str) -> "TrainingHistory":
        h = cls(path)
        with open(path) as f:
            data = json.load(f)
        h.config = data.get("config", {})
        h.epochs = data.get("epochs", [])
        return h


def save_train_state(path: str, state, metadata: Optional[dict] = None) -> None:
    """Save a full ``train.step.TrainState``: every parameter and buffer of
    the model by name, both Adam moments by parameter name, the
    optimizer's count and the step.  Restoring it resumes the optimization
    exactly (:func:`restore_train_state`).

    A state on a mesh (``train.step.shard_state``) is saved whole: every
    rank of the mesh calls this, the sliced leaves are gathered, the
    mesh's leader writes the file (the format of a one-rank state) and the
    others wait for it at a barrier."""
    from .. import parallel
    from .step import as_module

    module = as_module(state.params)
    layout = parallel.param_layout(module)
    mesh = parallel.layout_mesh(module)
    whole = lambda name, t: (parallel.full_tensor(t.detach(), layout[name], mesh)
                             if name in layout else t)
    opt = state.opt_state
    tree = {
        "params": parallel.full_state_dict(module),
        "mu": {n: whole(n, t) for n, t in zip(opt["names"], opt["mu"])},
        "nu": {n: whole(n, t) for n, t in zip(opt["names"], opt["nu"])},
        "count": np.int32(int(opt["count"])),
        "step": np.int32(int(state.step)),
    }
    if mesh is None or mesh.is_leader:
        save_pytree(path, tree, metadata)
    if mesh is not None and mesh.size > 1:
        torch.distributed.barrier(group=mesh.group)


def restore_train_state(path: str, template, mesh=None, fsdp: bool = False):
    """The ``TrainState`` saved at ``path``, restored into ``template`` (a
    state of the same model and optimizer, e.g. a fresh
    ``train.init_state(params, tx)``): the parameters are copied into the
    template's modules in place, the moments and counts onto their
    device.  A whole template with ``mesh`` is then placed on it
    (``train.step.shard_state(state, mesh, fsdp)``); a template already on
    a mesh keeps its layout and takes this rank's slices.  A state saved on
    a mesh restores on one rank, and the other way round."""
    from .. import parallel
    from .step import TrainState, as_module, shard_state

    tree = load_pytree(path)
    module = as_module(template.params)
    layout = parallel.param_layout(module)
    lmesh = parallel.layout_mesh(module)
    if lmesh is not None and mesh is not None and lmesh.shape != mesh.shape:
        raise ValueError(f"restore_train_state: the template lies on a {lmesh.shape} mesh, "
                         f"not on the {mesh.shape} one asked for")
    own = lambda name, arr: (parallel.local_slice(torch.from_numpy(np.asarray(arr)),
                                                  layout[name], lmesh)
                             if name in layout else torch.from_numpy(np.asarray(arr)))
    module.load_state_dict({k: own(k, v) for k, v in tree["params"].items()}, strict=True)
    opt = template.opt_state
    if sorted(tree["mu"]) != sorted(opt["names"]):
        raise ValueError(f"{path}: the saved moments are for other parameters")
    moment = lambda name, like: own(like[0], tree[name][like[0]]).to(like[1].device,
                                                                      like[1].dtype)
    count = opt["count"]
    state = TrainState(template.params, {
        **opt,
        "mu": [moment("mu", nm) for nm in zip(opt["names"], opt["mu"])],
        "nu": [moment("nu", nm) for nm in zip(opt["names"], opt["nu"])],
        "count": torch.tensor(int(tree["count"]), dtype=count.dtype, device=count.device),
    }, torch.tensor(int(tree["step"]), dtype=template.step.dtype, device=template.step.device))
    if lmesh is None and mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp)
    return state


def save_whisper_pt(path: str, params, dims) -> None:
    """Export a ``Whisper`` module (or its state dict) in the official
    checkpoint format (``models.convert.save_torch_checkpoint``)."""
    from ..models.convert import save_torch_checkpoint

    save_torch_checkpoint(path, params, dims)
