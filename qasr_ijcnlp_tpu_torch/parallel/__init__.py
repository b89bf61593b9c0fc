"""Meshes, sharding rules and collectives, one process per rank.

Port of ``qasr_ijcnlp_tpu/parallel/__init__.py``.  The JAX package drives
every device from one process through a ``jax.sharding.Mesh`` and
``shard_map``; here every rank is a process of ``torch.distributed``.  A
rank runs the plain entry points on its own shard, and the collectives are
explicit calls on the process groups of the mesh's two axes:

* **data** — this rank's rows of the global batch (:func:`shard_batch`);
  every rank of a ``model`` group holds the same rows;
* **model** — tensor parallelism: each rank holds its head columns of the
  encoder blocks' Q/K/V and fc weights and its rows of the out and proj
  weights (:func:`shard_params`, the column/row-parallel split of
  :data:`_BLOCK_RULES`), and ``parallel.sharded``'s trunks add the two
  all-reduces per block; the sequence-, pipeline- and expert-parallel
  trunks use the same axis for time, layers or experts.

The sharding rules (:func:`param_specs`) are computed on the JAX package's
parameter layout (``models.convert.to_jax_params``: blocks stacked on a
leading layer axis, Linear weights (in, out)) and are plain tuples of axis
names or ``None``, so they compare one for one with the JAX package's
``PartitionSpec``s.

The collectives are built from ``all_reduce`` alone: an all-gather, an
all-to-all or a ring shift is an all-reduce of a zero-filled buffer in which
each rank fills its own slot, which is exact (every sum has one nonzero
term).  The gloo backend takes ``all_reduce`` of CUDA tensors, so several
ranks can share one card (NCCL refuses two ranks on one device), and the
same code runs on the CPU, under NCCL with a card per rank, and in the
tests.  A collective that fails raises; nothing falls back.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group of a multi-process run.

    A no-op when the group exists already, and when no argument is given
    and no launcher (``torchrun``: ``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``) describes one: a single-process run.  With no
    arguments under a launcher, the environment gives the cluster.  A
    cluster that was asked for and fails raises ``RuntimeError``: a silent
    fallback would run N independent jobs on duplicated data.  The backend
    defaults to gloo, which takes CUDA tensors in ``all_reduce`` and lets
    several ranks share one card; pass ``"nccl"`` with one card per rank."""
    if dist.is_initialized():
        return
    env = os.environ
    launched = all(k in env for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"))
    if init_method is None and world_size is None and rank is None:
        if not launched or int(env["WORLD_SIZE"]) <= 1:
            return
        init_method = "env://"
    try:
        dist.init_process_group(
            backend or "gloo", init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group failed for init_method={init_method!r} "
            f"world_size={world_size} rank={rank}: {e}") from e


def mesh_shape(n: int, model_parallel: int) -> Tuple[int, int]:
    """(data, model) extents of a mesh over ``n`` ranks.  ``model_parallel``
    is a request: below 1 it is 1, and where it does not divide ``n`` it is
    demoted to the largest divisor of ``n`` below it (worst case 1, pure
    data parallelism), the reference's rule: sharding degrades, never
    refuses."""
    mp = max(int(model_parallel), 1)
    if n % mp:
        mp = max(d for d in range(1, min(mp, n) + 1) if n % d == 0)
    return n // mp, mp


class Mesh:
    """A (data, model) grid of ranks with one process group per row and
    column.  ``ranks[d, m]`` is the global rank at data index d and model
    index m; the model axis is the fast one, as in the JAX mesh's device
    array.  ``shape`` is a dict like ``jax.sharding.Mesh.shape``.

    Building a mesh (and :meth:`fork`) calls ``dist.new_group`` for every
    row and column, which every rank of the default group must do in the
    same order: build meshes in the same order on every rank.  A rank
    outside the grid gets a mesh with ``member`` False, which it must not
    compute on."""

    def __init__(self, ranks: np.ndarray, rank: int):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        n_data, n_model = self.ranks.shape
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.size = int(self.ranks.size)
        self.rank = rank
        hit = np.argwhere(self.ranks == rank)
        self.member = bool(len(hit))
        self.coords = ({DATA_AXIS: int(hit[0][0]), MODEL_AXIS: int(hit[0][1])} if self.member
                       else {DATA_AXIS: -1, MODEL_AXIS: -1})
        self._groups: Dict[str, Any] = {}
        self.group = None
        if self.size > 1:
            self.group = dist.new_group(self.ranks.reshape(-1).tolist())
            for d in range(n_data):
                g = dist.new_group(self.ranks[d].tolist()) if n_model > 1 else None
                if d == self.coords[DATA_AXIS]:
                    self._groups[MODEL_AXIS] = g
            for m in range(n_model):
                g = dist.new_group(self.ranks[:, m].tolist()) if n_data > 1 else None
                if m == self.coords[MODEL_AXIS]:
                    self._groups[DATA_AXIS] = g

    def axis_group(self, axis: str):
        """This rank's process group along ``axis`` (None at extent 1)."""
        return self._groups.get(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    @property
    def leader(self) -> int:
        """The global rank at (0, 0), which takes a service's requests."""
        return int(self.ranks[0, 0])

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader

    def fork(self) -> "Mesh":
        """The same grid with process groups of its own, so a component
        whose collectives run on its own thread (a decode engine's worker)
        never interleaves with another's on a shared group.  A collective
        call on every rank, like the constructor."""
        return Mesh(self.ranks, self.rank)

    def __repr__(self):
        return f"Mesh(shape={self.shape}, rank={self.rank})"


def make_mesh(model_parallel: int = 1, group=None) -> Mesh:
    """A (data, model) mesh over the ranks of ``group`` (a process group or
    a list of global ranks; default: every rank of the process group; one
    rank where none is initialized), with ``model_parallel`` degraded by
    :func:`mesh_shape`.  Every rank of the default group calls it."""
    if not dist.is_initialized():
        return Mesh(np.zeros((1, 1), np.int64), 0)
    if group is None:
        ranks = list(range(dist.get_world_size()))
    elif isinstance(group, (list, tuple)):
        ranks = list(group)
    else:
        ranks = dist.get_process_group_ranks(group)
    n_data, n_model = mesh_shape(len(ranks), model_parallel)
    return Mesh(np.asarray(ranks).reshape(n_data, n_model), dist.get_rank())


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.shape.get(axis, 1)


# ---------------------------------------------------------------------------
# Collectives (all_reduce only; exact)
# ---------------------------------------------------------------------------


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
    if axis_size(mesh, axis) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.axis_group(axis))
    return y


def _slots(x: torch.Tensor, mesh: Mesh, axis: str, slot=None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in its slot along ``axis``."""
    n = mesh.shape[axis]
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[mesh.index(axis) if slot is None else slot] = x
    dist.all_reduce(buf, group=mesh.axis_group(axis))
    return buf


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    if axis_size(mesh, axis) == 1:
        return x
    return torch.cat(_slots(x, mesh, axis).unbind(0), dim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` (S, ...) in S blocks, block j sent to rank j of ``axis``; the
    result's block j is what rank j sent here (``jax.lax.all_to_all(x,
    axis, 0, 0, tiled=True)`` on the leading dim)."""
    S = axis_size(mesh, axis)
    if S == 1:
        return x
    if x.shape[0] != S:
        raise ValueError(f"all_to_all: expected {S} blocks, got {x.shape[0]}")
    return _slots(x, mesh, axis)[:, mesh.index(axis)]


def shift_next(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ring shift i -> i + 1 along ``axis``: the ``x`` of the previous
    rank (``jax.lax.ppermute`` with pairs (i, (i + 1) % S))."""
    S = axis_size(mesh, axis)
    if S == 1:
        return x
    return _slots(x, mesh, axis)[(mesh.index(axis) - 1) % S]


def gather_objects(obj, mesh: Optional[Mesh], axis: str) -> List[Any]:
    """Every rank's picklable ``obj`` along ``axis``, in rank order."""
    if axis_size(mesh, axis) == 1:
        return [obj]
    out: List[Any] = [None] * mesh.shape[axis]
    dist.all_gather_object(out, obj, group=mesh.axis_group(axis))
    return out


def broadcast_object(obj, mesh: Mesh):
    """The leader's picklable ``obj`` on every rank of the mesh."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.leader, group=mesh.group)
    return box[0]


# ---------------------------------------------------------------------------
# Sharding rules for the parameter tree (JAX layout, models.convert)
# ---------------------------------------------------------------------------

# Block-local rules: path suffix -> spec of the stacked (L, ...) block leaf.
# Linear weights are (in, out): column-parallel layers shard the output dim,
# row-parallel ones the input dim, so a block needs one all-reduce after the
# attention and one after the MLP.  MoE expert leaves (L, E, ...) shard on E.
_BLOCK_RULES = {
    ("attn", "query", "w"): (None, None, MODEL_AXIS),
    ("attn", "query", "b"): (None, MODEL_AXIS),
    ("attn", "key", "w"): (None, None, MODEL_AXIS),
    ("attn", "value", "w"): (None, None, MODEL_AXIS),
    ("attn", "value", "b"): (None, MODEL_AXIS),
    ("attn", "out", "w"): (None, MODEL_AXIS, None),
    ("cross_attn", "query", "w"): (None, None, MODEL_AXIS),
    ("cross_attn", "query", "b"): (None, MODEL_AXIS),
    ("cross_attn", "key", "w"): (None, None, MODEL_AXIS),
    ("cross_attn", "value", "w"): (None, None, MODEL_AXIS),
    ("cross_attn", "value", "b"): (None, MODEL_AXIS),
    ("cross_attn", "out", "w"): (None, MODEL_AXIS, None),
    ("mlp", "fc", "w"): (None, None, MODEL_AXIS),
    ("mlp", "fc", "b"): (None, MODEL_AXIS),
    ("mlp", "proj", "w"): (None, MODEL_AXIS, None),
    ("mlp", "experts", "fc", "w"): (None, MODEL_AXIS, None, None),
    ("mlp", "experts", "fc", "b"): (None, MODEL_AXIS, None),
    ("mlp", "experts", "proj", "w"): (None, MODEL_AXIS, None, None),
    ("mlp", "experts", "proj", "b"): (None, MODEL_AXIS, None),
}


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _fsdp_augment(spec: tuple, shape, mesh, min_size: int) -> tuple:
    """Add a ``data`` shard to the largest still-replicated dim of a weight
    leaf of at least ``min_size`` elements whose size the data extent
    divides (ZeRO-3); small leaves and a mesh without data ranks keep the
    spec."""
    n_data = mesh.shape[DATA_AXIS]
    if n_data <= 1 or not shape:
        return spec
    if int(np.prod(shape)) < min_size:
        return spec
    full = list(spec) + [None] * (len(shape) - len(spec))
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if full[d] is None and shape[d] % n_data == 0:
            full[d] = DATA_AXIS
            return tuple(full)
    return spec


def param_specs(params: Dict[str, Any], mesh=None, fsdp: bool = False,
                fsdp_min_size: int = 65536) -> Dict[str, Any]:
    """The spec tree of a parameter tree in the JAX layout (any leaves with
    a ``shape``): per leaf a tuple of axis names or None.

    With ``mesh``, a sharded dim whose size the axis extent does not divide
    is demoted to replicated (the 51865-token vocabulary at model-parallel
    2): sharding never changes a result or refuses a model.  ``fsdp=True``
    also shards every large leaf along ``data`` (:func:`_fsdp_augment`);
    the training half of the port's parallelism uses it."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True requires a mesh (the data extent determines the "
                         "shard layout)")

    def fit(spec, shape):
        if mesh is None:
            return spec
        return tuple(None if a is not None and shape[d] % mesh.shape[a] else a
                     for d, a in enumerate(spec))

    def spec(keys, leaf):
        s = ()
        if "blocks" in keys:
            rule = _BLOCK_RULES.get(keys[keys.index("blocks") + 1:])
            if rule is not None:
                s = fit(rule, leaf.shape)
        elif keys[-1] == "tok_emb":
            s = fit((MODEL_AXIS, None), leaf.shape)
        if fsdp:
            s = _fsdp_augment(s, leaf.shape, mesh, fsdp_min_size)
        return s

    return _map_tree(spec, params)


def encoder_block_specs(blocks) -> Any:
    """The specs of a stacked block tree alone (paths relative to it:
    ``("attn", "query", "w")``, ...), undemoted."""
    return _map_tree(lambda keys, leaf: _BLOCK_RULES.get(keys, ()), blocks)


def batch_spec(ndim: int) -> tuple:
    """The leading (batch) dim along data, the rest replicated."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


class _Shape:
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


# The encoder block's leaves that have a rule: port name suffix -> the JAX
# path, and whether the port stores the leaf transposed (nn.Linear (out,
# in) against JAX's (in, out); an expert stack (E, out, in) against (E, in,
# out)).
def _block_leaf(name: str):
    parts = name.split(".")
    if parts[0] == "attn" and len(parts) == 3:
        return ("attn", parts[1], {"weight": "w", "bias": "b"}[parts[2]])
    if parts[:1] == ["mlp"] and parts[1] in ("0", "2") and len(parts) == 3:
        return ("mlp", {"0": "fc", "2": "proj"}[parts[1]],
                {"weight": "w", "bias": "b"}[parts[2]])
    if parts[:2] == ["mlp", "experts"] and len(parts) == 4:
        return ("mlp", "experts", parts[2], {"weight": "w", "bias": "b"}[parts[3]])
    return None


def _jax_shape(keys, shape, n_layer):
    """The JAX leaf's stacked shape of a port tensor of ``shape``."""
    if keys[-1] == "w":
        shape = shape[:-2] + (shape[-1], shape[-2])
    return (n_layer,) + tuple(shape)


def _torch_dim(keys, jax_dim: int, ndim: int) -> int:
    """The port tensor's dim of a JAX leaf's dim (the layer axis dropped)."""
    d = jax_dim - 1
    if keys[-1] == "w" and d >= ndim - 2:
        d = (2 * ndim - 3) - d  # the last two dims are transposed
    return d


def _sharded_leaves(encoder, mesh):
    """(block index, port name, torch dim, JAX path) of every encoder block
    leaf that ``param_specs`` shards along ``model`` on ``mesh``."""
    blocks = encoder.blocks
    leaves = {}
    for name, p in blocks[0].named_parameters():
        keys = _block_leaf(name)
        if keys is not None:
            tree = leaves
            for k in keys[:-1]:
                tree = tree.setdefault(k, {})
            tree[keys[-1]] = _Shape(_jax_shape(keys, tuple(p.shape), len(blocks)))
    specs = param_specs({"encoder": {"blocks": leaves}}, mesh)["encoder"]["blocks"]
    out = []
    for name, p in blocks[0].named_parameters():
        keys = _block_leaf(name)
        if keys is None:
            continue
        spec = specs
        for k in keys:
            spec = spec[k]
        if MODEL_AXIS in spec:
            out.append((name, _torch_dim(keys, spec.index(MODEL_AXIS), p.dim())))
    return out


def _set_param(module, name: str, value: torch.Tensor):
    *path, leaf = name.split(".")
    for part in path:
        module = module[int(part)] if part.isdigit() else getattr(module, part)
    old = getattr(module, leaf)
    setattr(module, leaf, torch.nn.Parameter(value, requires_grad=old.requires_grad))
    if isinstance(module, torch.nn.Linear):
        module.out_features, module.in_features = module.weight.shape


def shard_params(module, mesh: Mesh):
    """Keep, in place, this rank's slices of the encoder blocks' leaves
    that :func:`param_specs` shards along ``model``; returns ``module`` (a
    ``Whisper``, or an encoder).  Under tensor parallelism the blocks'
    query/key/value/fc become nn.Linear(D, D / tp) (this rank's head and
    hidden columns) and out/proj nn.Linear(D / tp, D) with the bias whole on
    every rank (the trunk adds it once, after the all-reduce); an MoE
    block's expert stacks keep E / tp experts.  The layer shapes follow the
    spec tree.

    The decoder stays whole on every rank: the port's decode loop runs per
    data rank, so its specs (which the JAX package hands to GSPMD) place
    nothing here.  A mesh without a model axis changes nothing."""
    encoder = getattr(module, "encoder", module)
    tp = axis_size(mesh, MODEL_AXIS)
    if tp == 1 or is_head_sharded(encoder):
        return module
    m = mesh.index(MODEL_AXIS)
    cut = _sharded_leaves(encoder, mesh)
    with torch.no_grad():
        for name, dim in cut:
            for bp in encoder.blocks:
                p = dict(bp.named_parameters())[name]
                n = p.shape[dim] // tp
                # a copy: a view would keep the whole weight's storage alive,
                # and rank 0's slice would start at the whole weight's address
                _set_param(bp, name, p.narrow(dim, m * n, n).clone(
                    memory_format=torch.contiguous_format))
    # (model extent, this rank's index, the (name, dim) of every cut leaf)
    encoder.shard_layout = (tp, m, tuple(cut))
    return module


def is_head_sharded(encoder) -> bool:
    """Whether ``shard_params`` sliced ``encoder``'s blocks."""
    return getattr(encoder, "shard_layout", None) is not None


def gathered_encoder(encoder, mesh: Mesh):
    """A copy of a sliced encoder with its blocks' leaves whole again (an
    all-gather along ``model`` per cut leaf): what GSPMD gathers around a
    trunk whose weights are replicated, for the sequence- and
    pipeline-parallel trunks on a model sharded for tensor parallelism."""
    import copy

    if not is_head_sharded(encoder):
        return encoder
    whole = copy.deepcopy(encoder)
    with torch.no_grad():
        for name, dim in encoder.shard_layout[2]:
            for bp in whole.blocks:
                p = dict(bp.named_parameters())[name]
                _set_param(bp, name, all_gather(p.detach(), mesh, MODEL_AXIS, dim))
    whole.shard_layout = None
    return whole


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows of the global ``batch`` (a tensor, or a tuple or
    list of them) along ``data``: data index d of n takes rows
    [d B / n, (d + 1) B / n).  B must divide (:func:`pad_batch_to_mesh`
    pads).  A caller whose loader already strides the data by the data
    rank (``data.loader.DataLoader(process_index=, process_count=)``)
    holds its rows and does not call this."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return batch
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh) for x in batch)
    B = batch.shape[0]
    if B % n:
        raise ValueError(f"shard_batch: {B} rows do not split over {n} data ranks; pad "
                         "with pad_batch_to_mesh")
    d = mesh.index(DATA_AXIS)
    return batch[d * (B // n):(d + 1) * (B // n)]


def round_up_to_mesh(n: int, mesh) -> int:
    """``n`` rounded up to a multiple of the mesh's data extent: the one
    rounding rule every data-parallel surface shares (serving, the
    evaluation CLI, :func:`pad_batch_to_mesh`)."""
    n_data = mesh.shape[DATA_AXIS]
    return -(-n // n_data) * n_data


def pad_batch_to_mesh(batch, mesh):
    """Pad the leading dim of ``batch`` (a tensor, or a tuple or list of
    them) up to a multiple of the data extent by repeating the last row;
    returns (padded, real_count).  Callers slice their per-row results back
    to ``real_count``."""

    def pad(x):
        b = x.shape[0]
        target = round_up_to_mesh(b, mesh)
        if target == b:
            return x
        return torch.cat([x, x[-1:].expand(target - b, *x.shape[1:])], 0)

    if isinstance(batch, (tuple, list)):
        return type(batch)(pad(x) for x in batch), batch[0].shape[0]
    return pad(batch), batch.shape[0]


def rank_device(device) -> torch.device:
    """This rank's device for ``device``: on the card, card LOCAL_RANK
    (modulo the cards present, so several ranks may share one); else as
    given."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    index = int(os.environ.get("LOCAL_RANK", 0)) % max(torch.cuda.device_count(), 1)
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def map_rows(fn, batch, mesh: Optional[Mesh]):
    """``fn`` over the rows of the global ``batch`` (a tensor, or a tuple of
    tensors with one leading batch dim), data-parallel: the batch is padded
    to the data extent, each data rank applies ``fn`` to its rows, and the
    per-row results (one tensor) are all-gathered along ``data`` and cut
    back to the real rows.  Every rank of the mesh calls it with the same
    batch and gets the same result, the one ``fn`` gives the whole batch."""
    if axis_size(mesh, DATA_AXIS) == 1:
        return fn(*batch) if isinstance(batch, tuple) else fn(batch)
    padded, real = pad_batch_to_mesh(batch, mesh)
    local = shard_batch(padded, mesh)
    out = fn(*local) if isinstance(local, tuple) else fn(local)
    return all_gather(out, mesh, DATA_AXIS, 0)[:real]


from . import sharded  # noqa: E402,F401  (the sharded trunks)
