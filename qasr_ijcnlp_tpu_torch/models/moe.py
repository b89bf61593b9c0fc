"""Mixture-of-experts encoder variant (top-1 switch routing).

Port of ``qasr_ijcnlp_tpu/models/moe.py``: each encoder block's dense MLP
becomes ``n_experts`` MLPs and a linear router.  Every token goes to its
argmax expert, scaled by the router probability, within a fixed capacity a
expert (overflow tokens keep only the residual); a load-balance loss
(``n_experts * sum(f_e * P_e)``) keeps the routing even.  Routing is the
GShard algebra of two one-hot tensors (``dispatch``: token -> (expert,
slot); ``combine`` = dispatch times the gate), so every shape is fixed.
The expert-parallel trunk (``parallel.sharded.ep_trunk``) runs the same
algebra with the experts over the mesh's ``model`` axis.

The modules keep the state-dict names of the dense model except for the
MLP: ``encoder.blocks.{i}.mlp.router.weight`` (E, D) and
``mlp.experts.{fc,proj}.{weight,bias}``, stacked per expert in the
nn.Linear layout ((E, F, D) and (E, F) for fc, (E, D, F) and (E, D) for
proj).  ``models.convert`` maps them to the JAX package's tree
(``mlp.router.w``, ``mlp.experts.{fc,proj}.{w,b}`` stacked (L, E, ...)).
The decoder is the dense one.  The encoder's forward is
:func:`moe_encoder_apply`; :func:`moe_whisper_loss_fn` is the loss, which
``train.step.make_sharded_train_step`` trains expert-parallel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gelu, layer_norm, round_up
from ..parallel import fsdp_view
from . import whisper as w
from .dims import ModelDimensions


@dataclass(frozen=True)
class MoEConfig:
    """MoE hyperparameters.  The capacity of an expert is ``ceil(cf *
    n_tokens / n_experts)`` rounded up to a multiple of 8, at least 8;
    under expert parallelism it applies per (rank, expert)."""

    n_experts: int
    capacity_factor: float = 1.25
    d_ff: Optional[int] = None  # default 4 * d_model
    aux_weight: float = 1e-2

    def ff(self, d_model: int) -> int:
        return self.d_ff if self.d_ff is not None else 4 * d_model

    def capacity(self, n_tokens: int) -> int:
        c = math.ceil(self.capacity_factor * n_tokens / self.n_experts)
        return max(8, -(-c // 8) * 8)


class ExpertLinear(nn.Module):
    """E stacked nn.Linear(d_in, d_out): weight (E, d_out, d_in), bias
    (E, d_out)."""

    def __init__(self, n_experts: int, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_experts, d_out, d_in))
        self.bias = nn.Parameter(torch.empty(n_experts, d_out))
        self.reset_parameters()

    def reset_parameters(self):
        """U(+-1/sqrt(d_in)) per expert, as nn.Linear's default and the JAX
        package's init."""
        bound = 1.0 / math.sqrt(self.weight.shape[-1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound)
            self.bias.uniform_(-bound, bound)


class ExpertMLPs(nn.Module):
    def __init__(self, n_experts: int, d: int, d_ff: int):
        super().__init__()
        self.fc = ExpertLinear(n_experts, d, d_ff)
        self.proj = ExpertLinear(n_experts, d_ff, d)


class MoEMLP(nn.Module):
    def __init__(self, d: int, moe: MoEConfig):
        super().__init__()
        self.router = nn.Linear(d, moe.n_experts, bias=False)
        self.experts = ExpertMLPs(moe.n_experts, d, moe.ff(d))


class MoEAudioEncoder(w.AudioEncoder):
    """The audio encoder with an MoE MLP in every block."""

    def __init__(self, dims: ModelDimensions, moe: MoEConfig):
        super().__init__(dims.n_mels, dims.n_audio_ctx, dims.n_audio_state,
                         dims.n_audio_head, dims.n_audio_layer)
        for bp in self.blocks:
            bp.mlp = MoEMLP(dims.n_audio_state, moe)


class MoEWhisper(w.Whisper):
    def __init__(self, dims: ModelDimensions, moe: MoEConfig):
        super().__init__(dims)
        self.moe = moe
        self.encoder = MoEAudioEncoder(dims, moe)


def _init_moe_mlp(generator: torch.Generator, d: int, moe: MoEConfig) -> Dict[str, torch.Tensor]:
    """The router and the expert stacks, U(+-1/sqrt(fan_in)) per expert,
    the JAX package's distributions, in the port's layout."""
    Fd, E = moe.ff(d), moe.n_experts
    bf, bp = 1.0 / math.sqrt(d), 1.0 / math.sqrt(Fd)
    u = lambda shape, b: (torch.rand(shape, generator=generator) * 2 - 1) * b
    return {
        "router.weight": u((E, d), bf),
        "experts.fc.weight": u((E, Fd, d), bf),
        "experts.fc.bias": u((E, Fd), bf),
        "experts.proj.weight": u((E, d, Fd), bp),
        "experts.proj.bias": u((E, d), bp),
    }


def init_moe_whisper_params(generator: torch.Generator, dims: ModelDimensions,
                            moe: MoEConfig) -> Dict[str, torch.Tensor]:
    """A state dict of :class:`MoEWhisper`: the dense model's
    (``whisper.init_params``) with each encoder block's MLP replaced.  The
    port's own bits: weights from the JAX package come through
    ``models.convert.from_jax_params``."""
    sd = w.init_params(generator, dims)
    for i in range(dims.n_audio_layer):
        pre = f"encoder.blocks.{i}.mlp."
        for k in [k for k in sd if k.startswith(pre)]:
            del sd[k]
        sd.update({pre + k: v for k, v in
                   _init_moe_mlp(generator, dims.n_audio_state, moe).items()})
    return sd


def moe_whisper_from_state_dict(state_dict, dims: ModelDimensions, moe: MoEConfig,
                                device="cuda") -> MoEWhisper:
    """An :class:`MoEWhisper` on ``device`` (the card unless the caller
    asks for the CPU)."""
    with torch.device("meta"):
        module = MoEWhisper(dims, moe)
    module.load_state_dict(state_dict, strict=True, assign=True)
    return module.to(device).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def route(t, router_w, moe: MoEConfig, capacity: int, valid=None):
    """Top-1 switch routing of tokens ``t`` (N, D) by the router weight
    (E, D): ``(dispatch (N, E, C) 0/1, combine (N, E, C) f32, aux)``.

    A token takes the next free slot of its expert's queue (arrival
    order); a token past the capacity gets an all-zero row (dropped: only
    the residual passes).  ``valid`` (N,) masks padding rows out of the
    routing: they take no slot and do not count in ``aux``."""
    E = moe.n_experts
    logits = t.float() @ router_w.float().t()
    probs = torch.softmax(logits, dim=-1)
    gate = probs.max(-1).values
    onehot = F.one_hot(probs.argmax(-1), E).to(torch.int32)
    if valid is not None:
        onehot = onehot * valid.to(torch.int32)[:, None]
        gate = gate * valid.to(gate.dtype)
    pos = torch.cumsum(onehot, 0) * onehot - 1  # queue position, -1 off-expert
    slot = pos.max(-1).values
    in_slot = (slot[:, None] == torch.arange(capacity, device=t.device)).float()
    dispatch = in_slot[:, None, :] * onehot.float()[:, :, None]
    combine = dispatch * gate[:, None, None]
    n_valid = (valid.float().sum() if valid is not None
               else torch.tensor(float(t.shape[0]), device=t.device))
    frac = onehot.sum(0).float() / n_valid.clamp_min(1.0)
    if valid is not None:
        probs = probs * valid.float()[:, None]
    pmean = probs.sum(0) / n_valid.clamp_min(1.0)
    return dispatch, combine, E * (frac * pmean).sum()


def expert_slice(experts: ExpertMLPs, e0: int, n: int):
    """Experts [e0, e0 + n) of a whole stack."""
    from types import SimpleNamespace as NS

    cut = lambda lin: NS(weight=lin.weight[e0:e0 + n], bias=lin.bias[e0:e0 + n])
    return NS(fc=cut(experts.fc), proj=cut(experts.proj))


def _expert_ffn(buf, experts, dt):
    """Each expert's MLP over its rows of a (E, C, D) dispatch buffer."""
    h = torch.einsum("ecd,efd->ecf", buf, experts.fc.weight.to(dt))
    h = gelu(h + experts.fc.bias.to(dt)[:, None, :])
    y = torch.einsum("ecf,edf->ecd", h, experts.proj.weight.to(dt))
    return y + experts.proj.bias.to(dt)[:, None, :]


def moe_mlp(mp: MoEMLP, x, moe: MoEConfig, valid=None):
    """The MoE MLP on one rank: (B, T, D) -> ((B, T, D), aux)."""
    B, T, D = x.shape
    dt = x.dtype
    t = x.reshape(B * T, D)
    C = moe.capacity(B * T)
    dispatch, combine, aux = route(t, mp.router.weight, moe, C,
                                   valid=None if valid is None else valid.reshape(B * T))
    buf = torch.einsum("nec,nd->ecd", dispatch.to(dt), t)
    y = _expert_ffn(buf, mp.experts, dt)
    out = torch.einsum("nec,ecd->nd", combine.to(dt), y)
    return out.reshape(B, T, D), aux


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def moe_trunk(encoder: MoEAudioEncoder, x, dims: ModelDimensions, moe: MoEConfig,
              t_real: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE blocks + ``ln_post`` on an embedded (B, T, D) input ->
    (out, the layers' mean aux).  Attention is the dense model's
    (``whisper._self_attn``: the attention kernels on the card); rows past
    ``t_real`` are masked out of attention and routing."""
    n_head = dims.n_audio_head
    T = t_real if t_real is not None else x.shape[1]
    valid = (None if x.shape[1] == T else
             (torch.arange(x.shape[1], device=x.device) < T)[None].expand(x.shape[0], -1))

    def layer(xc, bp):
        bp = fsdp_view(bp)
        xc = xc + w._self_attn(bp.attn, layer_norm(xc, bp.attn_ln), n_head, t_real=T)
        y, aux = moe_mlp(bp.mlp, layer_norm(xc, bp.mlp_ln), moe, valid=valid)
        return xc + y, aux

    auxes = []
    for bp in encoder.blocks:
        x, aux = w._maybe_remat(layer, x, bp)
        auxes.append(aux)
    return layer_norm(x[:, :T], encoder.ln_post), torch.stack(auxes).mean()


def moe_encoder_apply(encoder: MoEAudioEncoder, mel, dims: ModelDimensions, moe: MoEConfig,
                      compute_dtype=torch.float32, mesh=None):
    """MoE encoder forward: (B, n_mels, 2 n_audio_ctx) -> ((B, n_audio_ctx,
    D), aux).  The stem is the dense encoder's (the stem kernel on the
    card), cut to n_audio_ctx rows; with a ``mesh`` whose model axis the
    experts and the padded time divide, the trunk is expert-parallel
    (``parallel.sharded.ep_trunk``; the input is this data rank's rows),
    else the single-rank trunk."""
    from ..ops.conv_stem import _plain_stem, fused_conv_stem

    T = dims.n_audio_ctx
    if mel.shape[-1] != 2 * T:
        raise ValueError(f"expected {2 * T} mel frames, got {mel.shape[-1]}")
    encoder = fsdp_view(encoder, skip=("blocks",))
    stem = fused_conv_stem if w._kernels_on() else _plain_stem
    x = stem(encoder, mel, round_up(T, 128), compute_dtype)[:, :T]
    if mesh is not None:
        from ..parallel import sharded

        if sharded.ep_trunk_applicable(dims, moe, mesh, x.shape[0], T):
            return sharded.ep_trunk(encoder, x, dims, moe, T, mesh)
        from ..parallel import DATA_AXIS, axis_size, psum

        x, aux = moe_trunk(encoder, x, dims, moe)
        # the mean of the data ranks' own losses, as the EP trunk's
        return x, psum(aux, mesh, DATA_AXIS) / axis_size(mesh, DATA_AXIS)
    return moe_trunk(encoder, x, dims, moe)


def moe_whisper_loss_fn(dims: ModelDimensions, moe: MoEConfig, compute_dtype="float32",
                        mesh=None):
    """(module, mel, tokens) -> token cross-entropy + aux_weight * aux, the
    dense decoder over the MoE encoder's output."""
    from ..train.loss import shifted_token_loss

    dt = compute_dtype if isinstance(compute_dtype, torch.dtype) else getattr(torch,
                                                                              compute_dtype)

    def loss_fn(module, mel, tokens):
        from ..parallel import current_mesh

        m = mesh if mesh is not None else current_mesh()
        xa, aux = moe_encoder_apply(module.encoder, mel, dims, moe, dt, mesh=m)
        logits = w.decoder_apply(module.decoder, tokens.clamp_min(0), xa, dims, dt)
        return shifted_token_loss(logits, tokens, mesh=m) + moe.aux_weight * aux

    return loss_fn
