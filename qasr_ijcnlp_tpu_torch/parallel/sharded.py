"""The tensor-, sequence-, pipeline- and expert-parallel encoder trunks.

Port of ``qasr_ijcnlp_tpu/parallel/sharded.py``.  The JAX trunks run inside
one ``shard_map`` over the (data, model) mesh; here each rank calls its
trunk on its own data rows (the input and the output are this data rank's
(B_l, T, D), the same on every rank of its model group), and the
collectives of ``parallel`` stand where ``psum``, ``all_gather``,
``ppermute`` and ``all_to_all`` stand in the JAX bodies:

* :func:`tp_trunk` — heads and MLP columns over ``model``.  Each rank runs
  the attention kernel K4 head-sharded (its own (D, D / tp) Q/K/V columns:
  ``ops.encoder_block.fused_attention_ln``, output (B, Tp, D / tp)); the
  out-projection and the MLP's second product are row-parallel (plain
  ``torch.matmul``, as the JAX trunk leaves them to XLA), each followed by
  one all-reduce over ``model`` and then its whole bias, added once;
* :func:`sp_trunk` — time over ``model``, weights whole; K and V
  all-gathered every layer;
* :func:`pp_trunk` — layers over ``model`` (GPipe, ``n_micro``
  microbatches, a ring shift a step, the last stage's result broadcast by a
  masked all-reduce);
* :func:`ep_trunk` — MoE experts over ``model`` with time sharded as in
  SP, two all-to-alls a layer, the load-balance loss averaged over every
  rank.

The ``batch`` the gates take is this rank's local batch (its rows are
whole by construction), so the JAX gates' "batch divisible by the data
axis" clause has no counterpart.

Under grad the trunks' collectives are their transposes (``parallel``):
every rank of a model group holds the same loss, so a whole weight or
input that a rank uses for its own heads, time rows, stage or experts
enters through ``to_model_region`` (its gradient summed over ``model``),
as JAX's ``shard_map`` transposes do.  Every rank builds the same graph,
so that the backward's collectives meet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import gelu, head_scale, layer_norm, linear, round_up
from types import SimpleNamespace as _NS

from . import (
    DATA_AXIS, MODEL_AXIS, Mesh, all_gather, all_to_all, axis_size, fsdp_view,
    gathered_encoder, is_head_sharded, psum, shift_next, to_model_region,
)


def mesh_axis_sizes(mesh: Mesh):
    """(data extent, model extent)."""
    return axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)


def _key_mask(n: int, t_real: int, device) -> torch.Tensor:
    keep = torch.arange(n, device=device) < t_real
    return torch.zeros(n, device=device).masked_fill(~keep, float("-inf"))


def _split(z, n_head: int):
    B, T, D = z.shape
    return z.reshape(B, T, n_head, D // n_head).transpose(1, 2)


def _attend_rows(xc, bp, n_head: int, key_mask, mesh: Optional[Mesh] = None):
    """Pre-LN self-attention of the block ``bp`` on ``xc``'s rows, plain
    PyTorch (the JAX bodies' einsums): with ``mesh`` the rows are this
    rank's time shard and K and V are all-gathered along ``model``."""
    dt = xc.dtype
    scale = head_scale(xc.shape[-1] // n_head, dt)
    h = layer_norm(xc, bp.attn_ln)
    q = linear(h, bp.attn.query) * scale
    k = linear(h, bp.attn.key) * scale
    v = linear(h, bp.attn.value)
    if mesh is not None:
        k = all_gather(k, mesh, MODEL_AXIS, 1)
        v = all_gather(v, mesh, MODEL_AXIS, 1)
    logits = (_split(q, n_head) @ _split(k, n_head).transpose(-1, -2)).float()
    if key_mask is not None:
        logits = logits + key_mask
    wgt = torch.softmax(logits, dim=-1).to(dt)
    att = (wgt @ _split(v, n_head)).transpose(1, 2).reshape(xc.shape)
    return xc + linear(att, bp.attn.out)


def _dense_layer(xc, bp, n_head: int, key_mask, mesh: Optional[Mesh] = None):
    xc = _attend_rows(xc, bp, n_head, key_mask, mesh)
    return xc + linear(gelu(linear(layer_norm(xc, bp.mlp_ln), bp.mlp[0])), bp.mlp[2])


def _remat(fn, *args):
    from ..models import whisper as w

    return w._maybe_remat(fn, *args)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def tp_trunk_applicable(dims, mesh: Mesh, batch: int) -> bool:
    """A model axis > 1 that divides the heads and the MLP width."""
    _, tp = mesh_axis_sizes(mesh)
    return (tp > 1 and dims.n_audio_head % tp == 0
            and (4 * dims.n_audio_state) % tp == 0 and batch >= 1)


def tp_uses_kernel(dims, mesh: Mesh, t_real: int) -> bool:
    """Whether :func:`tp_trunk` runs K4 head-sharded: kernels on, a padded
    length of at least 512 and the attention gate on this rank's heads.
    The JAX trunk admits f32 only off the TPU; the port runs off the TPU,
    so it admits f32 and bf16 alike."""
    from ..models import whisper as w
    from ..ops.encoder_block import attn_applicable

    _, tp = mesh_axis_sizes(mesh)
    Tp = round_up(t_real, 128)
    D, H = dims.n_audio_state, dims.n_audio_head
    return (w._kernels_on() and Tp >= 512
            and attn_applicable(H // tp, D, Tp, d_head=D // H))


def tp_trunk(encoder, x, dims, t_real: int, mesh: Mesh):
    """Head-sharded encoder trunk: this data rank's (B_l, T or Tp, D) ->
    (B_l, T, D).  ``encoder`` must hold this rank's slices
    (``parallel.shard_params``).  Keys past ``t_real`` are always masked,
    also when ``x`` arrives padded."""
    from ..ops import encoder_block as eb

    _, tp = mesh_axis_sizes(mesh)
    if not is_head_sharded(encoder) or encoder.shard_layout[0] != tp:
        raise ValueError("tp_trunk: the encoder's blocks are not sharded for this mesh; "
                         "shard the model first (parallel.shard_params, "
                         "WhisperModel.shard)")
    T = t_real
    Tp = round_up(T, 128)
    nh = dims.n_audio_head // tp
    use_kernel = tp_uses_kernel(dims, mesh, T)
    if use_kernel and x.shape[1] != Tp:
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - x.shape[1]))
    attend = eb.fused_attention_ln if use_kernel else eb._plain_attn_ln

    def layer(xc, bp):
        bp = fsdp_view(bp)
        dt = xc.dtype
        # the column-parallel entries: each rank's heads and hidden columns
        # give their part of the input's (and attn_ln's) gradient
        xin, g, b = to_model_region(mesh, xc, bp.attn_ln.weight, bp.attn_ln.bias)
        ao = attend(xin, _NS(weight=g, bias=b), bp.attn, nh, T)
        part = ao @ bp.attn.out.weight.to(dt).t()
        xc = xc + (psum(part, mesh, MODEL_AXIS) + bp.attn.out.bias.to(dt))
        h, = to_model_region(mesh, layer_norm(xc, bp.mlp_ln))
        t = gelu(linear(h, bp.mlp[0]))
        part = t @ bp.mlp[2].weight.to(dt).t()
        return xc + (psum(part, mesh, MODEL_AXIS) + bp.mlp[2].bias.to(dt))

    for bp in encoder.blocks:
        x = _remat(layer, x, bp)
    return layer_norm(x[:, :T], encoder.ln_post)


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------


def sp_trunk_applicable(dims, mesh: Mesh, batch: int, t_real: int) -> bool:
    """A model axis > 1 that divides the padded time length (the fallback
    when the heads do not divide it, e.g. tiny's 6 heads on 4 ranks)."""
    _, tp = mesh_axis_sizes(mesh)
    return tp > 1 and round_up(t_real, 128) % tp == 0 and batch >= 1


def _time_shard(x, mesh: Mesh, Tp: int):
    S = axis_size(mesh, MODEL_AXIS)
    if x.shape[1] != Tp:
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - x.shape[1]))
    s, T_l = mesh.index(MODEL_AXIS), Tp // S
    return x[:, s * T_l:(s + 1) * T_l]


def sp_trunk(encoder, x, dims, t_real: int, mesh: Mesh):
    """Sequence-parallel trunk: this data rank's (B_l, T or Tp, D) ->
    (B_l, T, D).  Each model rank takes its Tp / S rows of time, computes
    LN + QKV on them, all-gathers K and V (the two collectives of a
    layer), attends for its queries and runs its rows' MLP; the output is
    all-gathered back along time."""
    encoder = gathered_encoder(encoder, mesh)
    T = t_real
    Tp = round_up(T, 128)
    x, = to_model_region(mesh, x)
    xx = _time_shard(x, mesh, Tp)
    key_mask = _key_mask(Tp, T, x.device)
    for bp in encoder.blocks:
        xx = _remat(_dense_layer, xx, bp, dims.n_audio_head, key_mask, mesh)
    out = all_gather(xx, mesh, MODEL_AXIS, 1, grad="slice")
    return layer_norm(out[:, :T], encoder.ln_post)


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------


def pp_trunk_applicable(dims, mesh: Mesh, batch: int, n_micro: int = 4) -> bool:
    """A model axis > 1 that divides the layers (equal stages) and a local
    batch that splits into ``n_micro`` microbatches."""
    _, pp = mesh_axis_sizes(mesh)
    return pp > 1 and dims.n_audio_layer % pp == 0 and batch % n_micro == 0


def pp_trunk(encoder, x, dims, t_real: int, mesh: Mesh, n_micro: int = 4):
    """Pipeline-parallel trunk (GPipe): stage s runs layers [s L / S,
    (s + 1) L / S) on one microbatch a step and shifts its output to stage
    s + 1; after M + S - 1 steps the last stage holds every microbatch,
    and a masked all-reduce gives them to every stage.  As in the JAX
    body, every stage computes on every step (the bubble steps' inputs are
    discarded)."""
    encoder = gathered_encoder(encoder, mesh)
    _, S = mesh_axis_sizes(mesh)
    s = mesh.index(MODEL_AXIS)
    per = dims.n_audio_layer // S
    blocks = list(encoder.blocks)[s * per:(s + 1) * per]
    T = t_real
    key_mask = None if x.shape[1] == T else _key_mask(x.shape[1], T, x.device)
    B_l, T_l, D = x.shape
    M = n_micro
    x, = to_model_region(mesh, x)

    def stage(mb):
        for bp in blocks:
            mb = _remat(_dense_layer, mb, bp, dims.n_audio_head, key_mask)
        return mb

    # Every stage builds the same graph, so that the collectives of the
    # backward meet on every rank: stage 0 takes the microbatch and the
    # others the shifted activation by weights of 1 and 0, and only the last
    # stage's finished microbatches count, by a weight of 1.
    first, last = float(s == 0), float(s == S - 1)
    micro = x.reshape(M, B_l // M, T_l, D)
    buf = torch.zeros_like(micro[0])  # the activation from stage s - 1
    outs = []  # finished microbatches (the last stage's count)
    for step in range(M + S - 1):
        out = stage(micro[min(step, M - 1)] * first + buf * (1.0 - first))
        if step >= S - 1:
            outs.append(out)
        if step < M + S - 2:
            buf = shift_next(out, mesh, MODEL_AXIS)
    outs = psum(torch.stack(outs) * last, mesh, MODEL_AXIS)
    out = layer_norm(outs.reshape(B_l, T_l, D), encoder.ln_post)
    return out[:, :T] if T_l != T else out


# ---------------------------------------------------------------------------
# Expert parallelism (models/moe.py)
# ---------------------------------------------------------------------------


def ep_trunk_applicable(dims, moe, mesh: Mesh, batch: int, t_real: int) -> bool:
    """A model axis > 1 that divides the experts and the padded time
    length."""
    _, ep = mesh_axis_sizes(mesh)
    return (ep > 1 and moe.n_experts % ep == 0 and round_up(t_real, 128) % ep == 0
            and batch >= 1)


def ep_trunk(encoder, x, dims, moe, t_real: int, mesh: Mesh):
    """Expert-parallel MoE trunk: this data rank's (B_l, T or Tp, D) ->
    ((B_l, T, D), aux).  Time is sharded over ``model`` as in
    :func:`sp_trunk`; each MoE layer routes its rank's tokens (top-1, a
    capacity per (rank, expert) from the local token count, the GShard
    grouping; rows past ``t_real`` never routed), exchanges the (S, E / S,
    C, D) dispatch blocks with one all-to-all, runs its E / S experts on
    the S C tokens each received and returns the results with a second
    all-to-all.  ``aux`` is the mean of the layers' load-balance losses,
    averaged over every rank."""
    from ..models import moe as moe_mod

    encoder = gathered_encoder(encoder, mesh)
    dp, S = mesh_axis_sizes(mesh)
    T = t_real
    Tp = round_up(T, 128)
    E = moe.n_experts
    E_l = E // S
    e0 = mesh.index(MODEL_AXIS) * E_l
    x, = to_model_region(mesh, x)
    xx = _time_shard(x, mesh, Tp)
    B_l, T_l, D = xx.shape
    key_mask = _key_mask(Tp, T, x.device)
    row = mesh.index(MODEL_AXIS) * T_l + torch.arange(T_l, device=x.device)
    valid = (row < T)[None, :].expand(B_l, T_l).reshape(-1)
    N = B_l * T_l
    C = moe.capacity(N)

    def layer(xc, bp):
        dt = xc.dtype
        xc = _attend_rows(xc, bp, dims.n_audio_head, key_mask, mesh)
        h = layer_norm(xc, bp.mlp_ln).reshape(N, D)
        dispatch, combine, aux = moe_mod.route(h, bp.mlp.router.weight, moe, C, valid=valid)
        buf = torch.einsum("nec,nd->ecd", dispatch.to(dt), h)
        recv = all_to_all(buf.reshape(S, E_l, C, D), mesh, MODEL_AXIS)
        rbuf = recv.transpose(0, 1).reshape(E_l, S * C, D)
        y = moe_mod._expert_ffn(rbuf, moe_mod.expert_slice(bp.mlp.experts, e0, E_l), dt)
        back = all_to_all(y.reshape(E_l, S, C, D).transpose(0, 1).contiguous(), mesh,
                          MODEL_AXIS)
        out = torch.einsum("nec,ecd->nd", combine.to(dt), back.reshape(E, C, D))
        return xc + out.reshape(B_l, T_l, D), aux

    auxes = []
    for bp in encoder.blocks:
        xx, aux = _remat(layer, xx, bp)
        auxes.append(aux)
    aux = psum(torch.stack(auxes).mean(), mesh, None) / (dp * S)
    out = all_gather(xx, mesh, MODEL_AXIS, 1, grad="slice")
    return layer_norm(out[:, :T], encoder.ln_post), aux
