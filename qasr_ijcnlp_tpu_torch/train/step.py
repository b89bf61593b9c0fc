"""The training step: AdamW with global-norm clipping, freeze masks and a
non-finite guard, one optimizer update a call.

Port of ``qasr_ijcnlp_tpu/train/step.py`` (optax ``adamw`` chained after
``clip_by_global_norm``, frozen parameters under ``multi_transform`` with
``set_to_zero``).  The optimizer is written out here with the optax update
rule, in its order of operations:

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  k = count + 1
    p += -lr(count) * ((mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps) + wd p)

``torch.optim.AdamW`` computes the same update, but the points below need
the optimizer's state in the step's own hands:

* **Clipping**: the gradient is scaled by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_``
  divides by ``norm + 1e-6``).
* **The freeze mask** is a set of parameter names (``models.quantum.
  trainable_mask``).  A frozen parameter gets no gradient, no moment, no
  weight decay and no write: it stays bit-identical.  The clip's norm
  covers the trainable parameters only, as under ``multi_transform``.
* **The non-finite guard**: a batch whose loss or gradient norm is not
  finite leaves the parameters, both moments and the optimizer's count
  unchanged, so the schedule does not advance; ``TrainState.step`` still
  counts the batch.  The guard selects on the device (no host sync).
* **Accumulation**: :func:`make_accum_train_step` sums the gradients of
  ``accum`` micro-batches and divides by their total count of valid
  targets, so ``accum=k`` at batch B equals one step at batch B.

The reported ``grad_norm`` is the norm over the trainable parameters: the
JAX package's covers the frozen ones too, whose gradients the port does
not compute (a frozen trunk only passes gradients through).

Parameters live in the caller's modules and are updated in place; the
caller sets ``requires_grad`` to match the mask (the trainers in
``train.loops`` do, and restore the flags afterwards).

**Under a mesh** (one process per rank): :func:`shard_state` keeps this
rank's slices of the parameters and moments, and
:func:`make_sharded_train_step` runs the step on this data rank's rows with
the mesh active (``parallel.use_mesh``), so the loss functions built
without a mesh route through it, as JAX's ``with mesh:`` does.  Every
rank's loss carries the global value (``train.loss``); the gradients of
the leaves whole along ``data`` are summed over the data ranks in flat
buckets (an FSDP leaf's gather already reduce-scattered its own), the
clip's norm sums each sliced leaf's squares over the axes it is sliced
along and counts a replicated leaf once, and the non-finite guard decides
from the global loss and norm, so every rank skips together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Set, Union

import torch
from torch import nn

from .. import parallel
from ..models import whisper as model
from ..models.dims import ModelDimensions
from .loss import shifted_token_loss, shifted_token_loss_sum


class TrainState(NamedTuple):
    """``params``: the model's module (or a dict of modules), updated in
    place; ``opt_state``: the optimizer's moments and count
    (:meth:`AdamW.init`); ``step``: the batches taken, an int32 scalar on
    the parameters' device."""
    params: Union[nn.Module, Dict[str, nn.Module]]
    opt_state: Dict
    step: torch.Tensor


def as_module(params) -> nn.Module:
    """A module over ``params``: itself, or a dict of modules as an
    ``nn.ModuleDict`` (names ``encoder.…``, ``head.…``)."""
    return params if isinstance(params, nn.Module) else nn.ModuleDict(params)


@dataclass
class AdamW:
    """optax ``adamw`` after ``clip_by_global_norm`` over the parameters in
    ``trainable_mask`` (all when None); see the module docstring."""
    learning_rate: Union[float, Callable]
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    clip_norm: Optional[float] = 1.0
    trainable_mask: Optional[Set[str]] = None

    def trainable(self, params) -> List[tuple]:
        """(name, parameter) of each trainable parameter, in module order."""
        named = as_module(params).named_parameters()
        mask = self.trainable_mask
        return [(n, p) for n, p in named if mask is None or n in mask]

    def init(self, params) -> Dict:
        """Zero moments for the trainable parameters and a zero count."""
        named = self.trainable(params)
        if not named:
            raise ValueError("no trainable parameter")
        dev = named[0][1].device
        return {"names": [n for n, _ in named],
                "mu": [torch.zeros_like(p, memory_format=torch.preserve_format)
                       for _, p in named],
                "nu": [torch.zeros_like(p, memory_format=torch.preserve_format)
                       for _, p in named],
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def lr(self, count) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.as_tensor(self.learning_rate, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def apply(self, grads, opt_state: Dict, params: List[torch.Tensor],
              ok: Optional[torch.Tensor], norm: Optional[torch.Tensor] = None) -> Dict:
        """One update of ``params`` and of the moments, in place (the
        gradients are consumed); where ``ok`` (a device bool) is False,
        nothing changes.  ``norm``: the gradients' global norm, if the
        caller has it.  Runs over chunks of ``_CHUNK`` elements, so its
        temporaries stay small beside the moments."""
        g = list(grads)
        count = opt_state["count"]
        k = count + 1
        kf = k.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, device=kf.device), kf)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, device=kf.device), kf)
        neg_lr = -self.lr(count)
        if self.clip_norm is not None:
            # optax: g / norm * max_norm where norm >= max_norm; dividing and
            # multiplying by 1 elsewhere keeps g exact
            norm = global_norm(g) if norm is None else norm
            keep = norm < self.clip_norm
            div, mul = torch.where(keep, 1.0, norm), torch.where(keep, 1.0, float(self.clip_norm))
        for idx in _chunks(params):
            gi, pi = [g[i] for i in idx], [params[i] for i in idx]
            mi, ni = [opt_state["mu"][i] for i in idx], [opt_state["nu"][i] for i in idx]
            if self.clip_norm is not None:
                torch._foreach_div_(gi, div)
                torch._foreach_mul_(gi, mul)
            mu = torch._foreach_add(torch._foreach_mul(gi, 1 - self.b1),
                                    torch._foreach_mul(mi, self.b1))
            torch._foreach_mul_(gi, gi)
            torch._foreach_mul_(gi, 1 - self.b2)
            nu = torch._foreach_add(gi, torch._foreach_mul(ni, self.b2))
            u = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(u)
            torch._foreach_add_(u, self.eps)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), u)
            if self.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul(pi, self.weight_decay))
            torch._foreach_mul_(u, neg_lr)
            new_p = torch._foreach_add(pi, u)
            for old, new in zip(pi + mi + ni, new_p + mu + nu):
                old.copy_(new if ok is None else torch.where(ok, new, old))
        return {**opt_state, "count": k if ok is None else torch.where(ok, k, count)}


# Elements per chunk of the optimizer's update (64 MB in f32).
_CHUNK = 1 << 24


def _chunks(tensors):
    """Index lists of consecutive tensors, each list about ``_CHUNK``
    elements (a larger tensor alone)."""
    out, cur, n = [], [], 0
    for i, t in enumerate(tensors):
        if cur and n + t.numel() > _CHUNK:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += t.numel()
    return out + [cur] if cur else out


def make_optimizer(learning_rate, weight_decay: float = 0.01, b1: float = 0.9,
                   b2: float = 0.98, eps: float = 1e-6, clip_norm: Optional[float] = 1.0,
                   trainable_mask: Optional[Set[str]] = None) -> AdamW:
    """AdamW chained after global-norm clipping; ``trainable_mask`` (a set
    of parameter names) freezes every other parameter.  ``learning_rate``
    is a float or a schedule of the optimizer's count."""
    return AdamW(learning_rate, weight_decay, b1, b2, eps, clip_norm,
                 None if trainable_mask is None else set(trainable_mask))


def init_state(params, tx: AdamW) -> TrainState:
    opt_state = tx.init(params)
    return TrainState(params, opt_state,
                      torch.zeros((), dtype=torch.int32, device=opt_state["count"].device))


def shard_state(state: TrainState, mesh, fsdp: bool = False,
                fsdp_min_size: int = 65536) -> TrainState:
    """Place a state on the mesh: the parameters keep this rank's slices
    (``parallel.shard_params`` along ``model``, then with ``fsdp``
    ``parallel.fsdp_shard`` along ``data``: ZeRO-3, the decoder and the
    token embedding included), both Adam moments the slices of their
    parameters, and the count and the step stay whole.  As in the JAX
    package, the unsharded input is consumed: its modules are sliced in
    place and the returned state shares them."""
    module = as_module(state.params)
    parallel.shard_params(module, mesh)
    if fsdp:
        parallel.fsdp_shard(module, mesh, fsdp_min_size)
    layout = parallel.param_layout(module)
    named = dict(module.named_parameters())
    opt = state.opt_state

    def cut(name, t):
        lay = layout.get(name)
        if lay is None or t.shape == named[name].shape:
            return t
        return parallel.local_slice(t, lay, mesh)

    return TrainState(state.params, {
        **opt,
        "mu": [cut(n, t) for n, t in zip(opt["names"], opt["mu"])],
        "nu": [cut(n, t) for n, t in zip(opt["names"], opt["nu"])],
    }, state.step)


def make_sharded_train_step(loss_fn: Optional[Callable], tx: AdamW, mesh,
                            step_fn: Optional[Callable] = None) -> Callable:
    """(state, *batch) -> (state, metrics) on the mesh: every rank calls it
    with the same global batch (``parallel.shard_batch`` keeps this data
    rank's rows of each tensor; other arguments pass as they are) and a
    state from :func:`shard_state`.  ``step_fn`` replaces the default
    :func:`make_train_step` body (e.g. a :func:`make_accum_train_step`)."""
    inner = step_fn or make_train_step(loss_fn, tx)

    def run(state: TrainState, *batch):
        batch = tuple(parallel.shard_batch(b, mesh) if isinstance(b, torch.Tensor) else b
                      for b in batch)
        with parallel.use_mesh(mesh):
            return inner(state, *batch)

    return run


def _active_mesh():
    mesh = parallel.current_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def reduce_gradients(grads, layout, mesh) -> List[torch.Tensor]:
    """The gradients summed over the data ranks, in flat buckets of about
    ``_CHUNK`` elements; a leaf sliced along ``data`` (an FSDP leaf, whose
    gathers reduce-scattered it already) passes as it is.  ``layout``: each
    gradient's (model dim, data dim)."""
    grads = list(grads)
    if parallel.axis_size(mesh, parallel.DATA_AXIS) == 1:
        return grads
    todo = [i for i, lay in enumerate(layout) if lay[1] is None]
    for idx in _chunks([grads[i] for i in todo]):
        picked = [todo[j] for j in idx]
        summed = parallel.all_reduce_flat([grads[i] for i in picked], mesh, parallel.DATA_AXIS)
        for i, g in zip(picked, summed):
            grads[i] = g
    return grads


def sharded_global_norm(grads, layout, mesh) -> torch.Tensor:
    """optax's ``global_norm`` of the whole leaves from this rank's
    slices: each leaf's squares summed over the axes it is sliced along, a
    replicated one counted once (one all-reduce over the mesh, every rank
    the same result)."""
    d0 = mesh.index(parallel.DATA_AXIS) == 0
    m0 = mesh.index(parallel.MODEL_AXIS) == 0
    total = None
    for g, (mdim, ddim) in zip(grads, layout):
        # a leaf whole along an axis holds the same gradient on each of its
        # ranks: only the axis's first rank adds it
        if (mdim is None and not m0) or (ddim is None and not d0):
            continue
        sq = torch.sum(g.float() * g.float())
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    total = total.clone()
    torch.distributed.all_reduce(total, group=mesh.group)
    return torch.sqrt(total)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all ``tensors`` (optax
    ``global_norm``), in fp32."""
    # sums of squares, not torch.linalg.vector_norm: on the CPU the norm
    # kernels accumulate serially in fp32 (3e-5 off at 6.6M elements)
    return torch.sqrt(torch.sum(torch.stack([torch.sum(t.float() * t.float())
                                             for t in tensors])))


def _forward(dims, compute_dtype, mesh):
    dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype

    def logits(params, mel, tokens):
        m = mesh if mesh is not None else parallel.current_mesh()
        # -100 pads are placeholders, masked in the loss
        return model.forward(params, mel, tokens.clamp_min(0).long(), dims, dt, mesh=m), m

    return logits


def whisper_loss_fn(dims: ModelDimensions, compute_dtype="float32", mesh=None) -> Callable:
    """(module, mel, tokens) -> scalar next-token CE (ignore -100).  With
    ``mesh`` (else the active one, ``parallel.use_mesh``) the forward routes
    through it (``models.whisper.forward``), the rows are this data rank's
    and the mean is over the global batch (``train.loss``)."""
    logits = _forward(dims, compute_dtype, mesh)

    def loss_fn(params, mel, tokens):
        out, m = logits(params, mel, tokens)
        return shifted_token_loss(out, tokens, mesh=m)

    return loss_fn


def whisper_sum_loss_fn(dims: ModelDimensions, compute_dtype="float32", mesh=None) -> Callable:
    """(module, mel, tokens) -> (CE sum, valid count) of this rank's rows,
    the accumulation form of :func:`whisper_loss_fn`."""
    logits = _forward(dims, compute_dtype, mesh)
    return lambda params, mel, tokens: shifted_token_loss_sum(logits(params, mel, tokens)[0],
                                                              tokens)


def _trainable_tensors(tx: AdamW, params) -> List[torch.Tensor]:
    ps = [p for _, p in tx.trainable(params)]
    if not all(p.requires_grad for p in ps):
        raise ValueError("a trainable parameter has requires_grad False; set the flags "
                         "from the mask first (models.quantum.trainable_mask(..., "
                         "set_requires_grad=True))")
    return ps


def _finish(state: TrainState, tx: AdamW, ps, grads, loss, skip_nonfinite: bool):
    mesh = _active_mesh()
    if mesh is None:
        gnorm = global_norm(grads)
    else:
        layout = parallel.param_layout(as_module(state.params))
        lay = [layout.get(n, (None, None)) for n, _ in tx.trainable(state.params)]
        grads = reduce_gradients(grads, lay, mesh)
        gnorm = sharded_global_norm(grads, lay, mesh)
    ok = (torch.isfinite(loss) & torch.isfinite(gnorm)) if skip_nonfinite else None
    opt_state = tx.apply(grads, state.opt_state, ps, ok, gnorm)
    skipped = (~ok).to(torch.int32) if skip_nonfinite else torch.zeros_like(state.step)
    return (TrainState(state.params, opt_state, state.step + 1),
            {"loss": loss.detach(), "grad_norm": gnorm, "skipped": skipped})


def make_train_step(loss_fn: Callable, tx: AdamW, skip_nonfinite: bool = True) -> Callable:
    """(state, *batch) -> (state, metrics {loss, grad_norm, skipped}) with the
    parameters updated in place.  ``loss_fn(params, *batch)`` returns a
    scalar; batch tensors lie on the parameters' device."""

    def train_step(state: TrainState, *batch):
        ps = _trainable_tensors(tx, state.params)
        loss = loss_fn(state.params, *batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True, materialize_grads=True)
        return _finish(state, tx, ps, grads, loss.detach(), skip_nonfinite)

    return train_step


def make_accum_train_step(sum_loss_fn: Callable, tx: AdamW, accum: int,
                          skip_nonfinite: bool = True) -> Callable:
    """One optimizer update a call over ``accum`` micro-batches (each
    batch tensor's leading dim must divide by ``accum``): the gradients of
    the summed losses added up and divided by the total valid count, which
    gives the full-batch mean gradient exactly.  Each micro-batch's graph
    is freed before the next one runs.  Under a mesh (as the ``step_fn``
    of :func:`make_sharded_train_step`) the micro-batches are this data
    rank's rows and the count and the sum are the data ranks' total."""

    def train_step(state: TrainState, *batch):
        if any(x.shape[0] % accum for x in batch):
            raise ValueError(f"batch of {batch[0].shape[0]} does not split into {accum} "
                             f"micro-batches")
        ps = _trainable_tensors(tx, state.params)
        micro = [x.reshape(accum, x.shape[0] // accum, *x.shape[1:]) for x in batch]
        gsum, ssum, csum = None, 0.0, 0.0
        for i in range(accum):
            s, c = sum_loss_fn(state.params, *(m[i] for m in micro))
            g = torch.autograd.grad(s, ps, allow_unused=True, materialize_grads=True)
            gsum = list(g) if gsum is None else torch._foreach_add(gsum, g)
            ssum, csum = ssum + s.detach(), csum + c.detach()
        mesh = _active_mesh()
        if mesh is not None:  # the counts and sums of every data rank
            csum = parallel.psum(csum, mesh, parallel.DATA_AXIS)
            ssum = parallel.psum(ssum, mesh, parallel.DATA_AXIS)
        csum = torch.clamp(csum, min=1.0)
        grads = torch._foreach_div(gsum, csum)
        return _finish(state, tx, ps, grads, ssum / csum, skip_nonfinite)

    return train_step
