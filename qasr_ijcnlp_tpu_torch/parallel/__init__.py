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
tests.  A collective that fails raises; nothing falls back.  Each is an
``autograd.Function`` with its transpose, so the sharded paths train.

FSDP (ZeRO-3) slices every large leaf along ``data`` (:func:`fsdp_shard`,
the leaves of ``param_specs(fsdp=True)``) and gathers a module's slices
where it is used (:func:`fsdp_view`), into a fresh view whose backward
reduce-scatters the gradients.
"""

from __future__ import annotations

import contextlib
import os
import threading
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

    def __deepcopy__(self, memo):
        # process groups cannot be copied: a copy of a sharded module keeps
        # the mesh it was sliced for
        return self

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


_ACTIVE = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Within the block, :func:`current_mesh` is ``mesh``: the mesh that the
    loss functions built without one run on (JAX's ``with mesh:``).
    ``train.step.make_sharded_train_step`` sets it around each step."""
    stack = _ACTIVE.__dict__.setdefault("meshes", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh() -> Optional[Mesh]:
    """The innermost :func:`use_mesh` mesh of this thread, or None."""
    stack = getattr(_ACTIVE, "meshes", None)
    return stack[-1] if stack else None


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.shape.get(axis, 1)


# ---------------------------------------------------------------------------
# Collectives (all_reduce only; exact), each with its transpose
# ---------------------------------------------------------------------------
#
# Every rank of a ``model`` group computes the same loss, and each data
# rank's loss carries the global value (``train.loss``), so a collective's
# backward is its transpose under one rule: a cotangent that arrives at a
# value every rank holds alike is whole on each rank, and one that arrives at
# a value a rank uses for its own share of the work (its heads, time rows,
# stage or experts) is that rank's part and must be summed.
# ``dist.all_reduce`` on a clone has no autograd record (PyTorch only warns
# and takes it for the identity), so each collective here is an
# ``autograd.Function``.


def _group(mesh: Mesh, axis: Optional[str]):
    return mesh.group if axis is None else mesh.axis_group(axis)


def _extent(mesh: Optional[Mesh], axis: Optional[str]) -> int:
    if mesh is None:
        return 1
    return mesh.size if axis is None else axis_size(mesh, axis)


def all_reduce_flat(tensors, mesh: Mesh, axis: Optional[str]) -> List[torch.Tensor]:
    """Each tensor summed over ``axis`` (None: the whole mesh), as new
    tensors: one ``all_reduce`` of a flat buffer per dtype (no autograd
    record)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=_group(mesh, axis))
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


class _Psum(torch.autograd.Function):
    """Partial sums -> their sum on every rank.  The sum is a value every
    rank holds alike, so each part's cotangent is the sum's, unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=_group(mesh, axis))
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Gather(torch.autograd.Function):
    """Tensors ``xs`` gathered along ``axis``: tensor i concatenated over the
    ranks along ``dims[i]``, or passed unchanged where ``dims[i]`` is None;
    one all-reduce of zero-filled slot buffers.  With ``reduce`` the
    backward sums every cotangent over ``axis`` (one flat all-reduce) and
    keeps this rank's slot of each gathered one (a reduce-scatter): the
    results serve each rank's own share of the work.  Without it a gathered
    tensor's cotangent is cut to this rank's slot, unsummed: the results
    serve every rank alike."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, reduce, *xs):
        n, k = _extent(mesh, axis), mesh.index(axis)
        ctx.mesh, ctx.axis, ctx.dims, ctx.reduce = mesh, axis, dims, reduce
        ctx.sizes = [None if d is None else x.shape[d] for x, d in zip(xs, dims)]
        slots = []
        for x, d in zip(xs, dims):
            if d is not None:
                buf = x.new_zeros((n,) + tuple(x.shape))
                buf[k] = x
                slots.append(buf)
        whole = iter(all_reduce_flat(slots, mesh, axis) if slots else ())
        return tuple(x.view_as(x) if d is None else torch.cat(next(whole).unbind(0), d)
                     for x, d in zip(xs, dims))

    @staticmethod
    def backward(ctx, *grads):
        if ctx.reduce:
            grads = all_reduce_flat(grads, ctx.mesh, ctx.axis)
        k = ctx.mesh.index(ctx.axis)
        return (None, None, None, None, *(
            g if d is None else g.narrow(d, k * s, s)
            for g, d, s in zip(grads, ctx.dims, ctx.sizes)))


def _exchange(x, mesh: Mesh, axis: str, shift: Optional[int]) -> torch.Tensor:
    n, k = mesh.shape[axis], mesh.index(axis)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[k] = x
    dist.all_reduce(buf, group=mesh.axis_group(axis))
    if shift is None:
        return buf[:, k].clone()
    return buf[(k - shift) % n].clone()


class _Exchange(torch.autograd.Function):
    """``all_to_all`` (``shift`` None) or the ring shift by ``shift`` along
    ``axis``; the backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _exchange(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, grad):
        back = None if ctx.shift is None else -ctx.shift
        return _exchange(grad.contiguous(), ctx.mesh, ctx.axis, back), None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (None: every rank of the
    mesh), a new tensor.  The backward passes the cotangent on unchanged:
    partial sums become a value every rank holds alike (the row-parallel
    out-projection and MLP, the pipeline's last stage, the load-balance
    loss, the data ranks' shares of the loss)."""
    if _extent(mesh, axis) == 1:
        return x
    return _Psum.apply(x, mesh, axis)


def to_model_region(mesh: Optional[Mesh], *xs: torch.Tensor, axis: str = MODEL_AXIS):
    """``xs`` unchanged, as a tuple, entering a region where each rank of
    ``axis`` uses them for its own share of the work (a column-parallel
    branch, a time shard, a pipeline stage): the backward sums their
    cotangents over ``axis``, in one all-reduce."""
    if _extent(mesh, axis) == 1:
        return xs
    return _Gather.apply(mesh, axis, (None,) * len(xs), True, *xs)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
               grad: str = "reduce_scatter") -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``).  ``grad``: where each
    rank uses the result for its own share of the work (the sequence
    shards' keys and values, an FSDP weight), ``"reduce_scatter"`` sums the
    cotangent over the ranks and keeps this rank's slot; where every rank
    uses it alike (a trunk's output), ``"slice"`` keeps this rank's slot."""
    if axis_size(mesh, axis) == 1:
        return x
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"all_gather: grad must be 'reduce_scatter' or 'slice', got {grad!r}")
    return _Gather.apply(mesh, axis, (dim,), grad == "reduce_scatter", x)[0]


def gather_leaves(tensors, dims, mesh: Mesh, axis: str, region: bool = False) -> list:
    """``tensors`` gathered along ``axis`` where ``dims[i]`` names a dim, in
    one all-reduce each way; the backward reduce-scatters their gradients.
    With ``region`` the others enter a region (:func:`to_model_region`),
    else they pass untouched and stay out of the collectives."""
    tensors = list(tensors)
    if axis_size(mesh, axis) == 1:
        return tensors
    pick = [i for i, d in enumerate(dims) if region or d is not None]
    if pick:
        outs = _Gather.apply(mesh, axis, tuple(dims[i] for i in pick), True,
                             *(tensors[i] for i in pick))
        for i, o in zip(pick, outs):
            tensors[i] = o
    return tensors


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` (S, ...) in S blocks, block j sent to rank j of ``axis``; the
    result's block j is what rank j sent here (``jax.lax.all_to_all(x,
    axis, 0, 0, tiled=True)`` on the leading dim).  Its own transpose."""
    S = axis_size(mesh, axis)
    if S == 1:
        return x
    if x.shape[0] != S:
        raise ValueError(f"all_to_all: expected {S} blocks, got {x.shape[0]}")
    return _Exchange.apply(x, mesh, axis, None)


def shift_next(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ring shift i -> i + 1 along ``axis``: the ``x`` of the previous
    rank (``jax.lax.ppermute`` with pairs (i, (i + 1) % S)); the backward
    shifts the cotangent to the previous rank."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Exchange.apply(x, mesh, axis, 1)


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
    also shards every large leaf along ``data`` (:func:`_fsdp_augment`),
    which :func:`fsdp_shard` slices."""
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


# The port's parameter names -> the JAX tree's paths: a block leaf's path
# relative to its stack, and whether the port stores the leaf transposed
# (nn.Linear (out, in) against JAX's (in, out); an expert stack (E, out, in)
# against (E, in, out); the router (E, D) against (D, E)).
_LIN = {"weight": "w", "bias": "b"}
_LN = {"weight": "g", "bias": "b"}


def _block_leaf(name: str):
    """The JAX path of a block leaf (``attn.query.weight`` ->
    ``("attn", "query", "w")``), or None."""
    parts = name.split(".")
    if parts[0] in ("attn", "cross_attn") and len(parts) == 3:
        return (parts[0], parts[1], _LIN[parts[2]])
    if parts[0] in ("attn_ln", "cross_attn_ln", "mlp_ln") and len(parts) == 2:
        return (parts[0], _LN[parts[1]])
    if parts[:1] == ["mlp"] and parts[1] in ("0", "2") and len(parts) == 3:
        return ("mlp", {"0": "fc", "2": "proj"}[parts[1]], _LIN[parts[2]])
    if parts[:2] == ["mlp", "router"] and len(parts) == 3:
        return ("mlp", "router", "w")
    if parts[:2] == ["mlp", "experts"] and len(parts) == 4:
        return ("mlp", "experts", parts[2], _LIN[parts[3]])
    return None


def _jax_leaf(name: str):
    """(JAX path, layer index or None) of a parameter of a ``Whisper`` (or
    MoE) module by its name, or None for a leaf the JAX tree names
    otherwise (a quantum stem's)."""
    parts = name.split(".")
    side, rest = parts[0], parts[1:]
    if side not in ("encoder", "decoder") or not rest:
        return None
    if rest[0] == "blocks" and len(rest) > 2:
        keys = _block_leaf(".".join(rest[2:]))
        return None if keys is None else ((side, "blocks") + keys, int(rest[1]))
    joined = ".".join(rest)
    top = {"conv1.weight": ("conv1", "w"), "conv1.bias": ("conv1", "b"),
           "conv2.weight": ("conv2", "w"), "conv2.bias": ("conv2", "b"),
           "positional_embedding": ("pos",) if side == "encoder" else ("pos_emb",),
           "ln_post.weight": ("ln_post", "g"), "ln_post.bias": ("ln_post", "b"),
           "token_embedding.weight": ("tok_emb",),
           "ln.weight": ("ln", "g"), "ln.bias": ("ln", "b")}.get(joined)
    return None if top is None else ((side,) + top, None)


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


def _owner(module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = module[int(part)] if part.isdigit() else getattr(module, part)
    return module, leaf


def _set_param(module, name: str, value: torch.Tensor, features: bool = True):
    module, leaf = _owner(module, name)
    old = getattr(module, leaf)
    setattr(module, leaf, torch.nn.Parameter(value, requires_grad=old.requires_grad))
    if features and isinstance(module, torch.nn.Linear):
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
    encoder.shard_mesh = mesh
    return module


def is_head_sharded(encoder) -> bool:
    """Whether ``shard_params`` sliced ``encoder``'s blocks."""
    return getattr(encoder, "shard_layout", None) is not None


# ---------------------------------------------------------------------------
# FSDP: leaves sliced along ``data``, gathered per use
# ---------------------------------------------------------------------------


def fsdp_shard(module, mesh: Mesh, min_size: int = 65536):
    """Keep, in place, this rank's ``data`` slice of every leaf of a
    ``Whisper`` (or MoE) module that ``param_specs(fsdp=True)`` slices along
    ``data`` (ZeRO-3: the decoder and the token embedding too); returns
    ``module``.  Call it after :func:`shard_params`: a leaf that is also cut
    along ``model`` keeps the ``data`` slice of its ``model`` slice (the
    specs are JAX's, computed on the whole shapes).  Each module that owns
    a sliced leaf records it in ``fsdp_slices`` ({leaf: dim}) beside the
    mesh (``fsdp_mesh``); :func:`fsdp_view` gathers them where the module is
    used.  A leaf whose ``data`` slice JAX puts on the blocks' layer axis
    (a stack whose other dims the data extent does not divide) stays whole:
    the port keeps a layer's tensors together."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return module
    d = mesh.index(DATA_AXIS)
    named = dict(module.named_parameters())
    whole = _whole_shapes(module, mesh)
    tree, where = {}, {}
    n_layers: Dict[tuple, int] = {}
    for name in named:
        hit = _jax_leaf(name)
        if hit is not None:
            keys, layer = hit
            where[name] = hit
            if layer is not None:
                n_layers[keys] = max(n_layers.get(keys, 0), layer + 1)
    for name, (keys, layer) in where.items():
        shape = whole[name]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _Shape(shape if layer is None
                                else _jax_shape(keys, shape, n_layers[keys]))
    specs = param_specs(tree, mesh, fsdp=True, fsdp_min_size=min_size)
    with torch.no_grad():
        for name, (keys, layer) in where.items():
            spec = specs
            for k in keys:
                spec = spec[k]
            if DATA_AXIS not in spec:
                continue
            jd = spec.index(DATA_AXIS)
            p = named[name]
            if layer is None:
                dim = jd
            elif jd == 0:
                continue  # the layer axis (see above)
            else:
                dim = _torch_dim(keys, jd, p.dim())
            size = p.shape[dim] // n
            owner, leaf = _owner(module, name)
            _set_param(module, name, p.narrow(dim, d * size, size).clone(
                memory_format=torch.contiguous_format), features=False)
            owner.__dict__.setdefault("fsdp_slices", {})[leaf] = dim
            owner.__dict__["fsdp_mesh"] = mesh
    return module


def _whole_shapes(module, mesh: Mesh) -> Dict[str, tuple]:
    """Every parameter's shape before :func:`shard_params` cut it along
    ``model``."""
    shapes = {n: list(p.shape) for n, p in module.named_parameters()}
    for name, (dim, _) in param_layout(module).items():
        if dim is not None:
            shapes[name][dim] *= axis_size(mesh, MODEL_AXIS)
    return {n: tuple(s) for n, s in shapes.items()}


def param_layout(module) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """{name: (model dim, data dim)} of every parameter that
    :func:`shard_params` or :func:`fsdp_shard` sliced (the dims of the
    port's tensor; None where the leaf is whole along that axis)."""
    out: Dict[str, list] = {}
    for prefix, m in module.named_modules():
        pre = f"{prefix}." if prefix else ""
        lay = getattr(m, "shard_layout", None)
        if lay is not None:
            for i in range(len(m.blocks)):
                for leaf, dim in lay[2]:
                    out.setdefault(f"{pre}blocks.{i}.{leaf}", [None, None])[0] = dim
        for leaf, dim in m.__dict__.get("fsdp_slices", {}).items():
            out.setdefault(pre + leaf, [None, None])[1] = dim
    return {k: tuple(v) for k, v in out.items()}


def layout_mesh(module) -> Optional[Mesh]:
    """The mesh that :func:`shard_params` or :func:`fsdp_shard` sliced
    ``module`` for, or None for a whole module."""
    for m in module.modules():
        mesh = m.__dict__.get("fsdp_mesh") or (m.__dict__.get("shard_mesh")
                                               if is_head_sharded(m) else None)
        if mesh is not None:
            return mesh
    return None


def local_slice(t: torch.Tensor, layout, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor ``t`` under ``layout`` ((model
    dim, data dim), as :func:`param_layout` gives), a new tensor."""
    for dim, axis in zip(layout, (MODEL_AXIS, DATA_AXIS)):
        if dim is not None:
            n = axis_size(mesh, axis)
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(axis) * size, size)
    return t.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def full_tensor(t: torch.Tensor, layout, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of this rank's slice ``t`` under ``layout`` (a
    collective on every rank of the mesh, every rank the same result)."""
    model_dim, data_dim = layout
    if data_dim is not None:
        t = all_gather(t, mesh, DATA_AXIS, data_dim)
    if model_dim is not None:
        t = all_gather(t, mesh, MODEL_AXIS, model_dim)
    return t


def full_state_dict(module) -> Dict[str, torch.Tensor]:
    """``module``'s state dict with every sliced leaf whole (a collective
    on every rank of its mesh); the whole leaves are the module's own
    tensors, not copies."""
    layout, mesh = param_layout(module), layout_mesh(module)
    return {k: full_tensor(v, layout[k], mesh) if k in layout else v
            for k, v in module.state_dict().items()}


def _walk(module, prefix: str = "", skip=()):
    """(name prefix, module) of ``module`` and its descendants, leaving out
    the children of ``module`` named in ``skip``."""
    yield prefix, module
    for name, child in module._modules.items():
        if child is not None and not (not prefix and name in skip):
            yield from _walk(child, f"{prefix}{name}.", ())


def _view(module, new: Dict[str, torch.Tensor]):
    """A shallow copy of ``module`` whose parameters named in ``new``
    (dotted, relative to it) are the given tensors; the modules on their
    paths are copied, every other child is shared.  A copy carries no
    kernel weight pack (``ops.encoder_block._kept`` keys a pack on its
    tensors' addresses and versions, and a gathered weight lies in a fresh
    buffer that may reuse a freed one's address at version 0) and no FSDP
    record."""
    import copy

    if not new:
        return module
    v = copy.copy(module)
    state = v.__dict__
    for key in ("_encoder_packs", "fsdp_slices", "fsdp_mesh", "shard_mesh"):
        state.pop(key, None)
    state["_parameters"] = dict(module._parameters)
    state["_modules"] = dict(module._modules)
    children: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in new.items():
        head, _, rest = name.partition(".")
        if rest:
            children.setdefault(head, {})[rest] = t
        else:
            state["_parameters"][head] = t
    for head, sub in children.items():
        state["_modules"][head] = _view(module._modules[head], sub)
    return v


def _data_sliced(module, skip=()):
    """(names, tensors, dims, mesh) of the ``data``-sliced leaves of
    ``module`` and its descendants outside ``skip``."""
    names, tensors, dims, mesh = [], [], [], None
    for prefix, m in _walk(module, "", skip):
        slices = m.__dict__.get("fsdp_slices")
        if slices:
            mesh = m.__dict__["fsdp_mesh"]
            for leaf, dim in slices.items():
                names.append(prefix + leaf)
                tensors.append(m._parameters[leaf])
                dims.append(dim)
    return names, tensors, dims, mesh


def fsdp_view(module, skip=()):
    """``module`` with its ``data``-sliced leaves (:func:`fsdp_shard`)
    gathered, for one use: a fresh view (:func:`_view`) whose gathers
    reduce-scatter the gradients in the backward, or ``module`` itself
    where nothing is sliced.  ``skip`` names children left as they are
    (the blocks, which each gather at their own use).  Every rank of the
    mesh's data axis must make the same calls."""
    if not isinstance(module, torch.nn.Module):
        return module  # a traced program's namespace of weights
    names, tensors, dims, mesh = _data_sliced(module, skip)
    if not names:
        return module
    return _view(module, dict(zip(names, gather_leaves(tensors, dims, mesh, DATA_AXIS))))


def gathered_encoder(encoder, mesh: Mesh):
    """The encoder with its blocks' leaves whole, for the sequence-,
    pipeline- and expert-parallel trunks, which run whole weights on a
    model sliced for tensor parallelism (what GSPMD gathers around a trunk
    whose weights are replicated).

    Under grad: a view whose blocks' ``data`` slices (FSDP) and ``model``
    slices are all-gathered from the live leaves, the other block leaves
    entering the trunk's region (:func:`to_model_region`): each rank uses
    them on its own time rows, stage or experts, so the backward sums
    their gradients over ``model`` and reduce-scatters the gathered ones,
    as the transpose of JAX's ``shard_map`` does.  Without grad, where
    nothing is ``data``-sliced: a copy with its cut leaves gathered."""
    import copy

    names, tensors, dims, _ = _data_sliced(encoder.blocks)
    if torch.is_grad_enabled() or names:
        leaves = dict(encoder.blocks.named_parameters())
        leaves.update(zip(names, gather_leaves(tensors, dims, mesh, DATA_AXIS)))
        cut = dict(encoder.shard_layout[2]) if is_head_sharded(encoder) else {}
        keys = list(leaves)
        region = torch.is_grad_enabled()
        dims_m = [cut.get(k.split(".", 1)[1]) for k in keys]
        whole = gather_leaves([leaves[k] for k in keys], dims_m, mesh, MODEL_AXIS, region)
        view = _view(encoder, {f"blocks.{k}": t for k, t in zip(keys, whole)})
        view.__dict__["shard_layout"] = None
        return view
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
