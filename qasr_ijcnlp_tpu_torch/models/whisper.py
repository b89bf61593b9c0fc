"""Whisper encoder/decoder in PyTorch.

Port of ``qasr_ijcnlp_tpu/models/whisper.py``.  The modules carry the
reference (OpenAI) state-dict names (``encoder.blocks.{i}.attn.query.weight``,
``decoder.token_embedding.weight``, ...) so official checkpoints load with
``load_state_dict``; the forward passes are plain functions over those
modules, mirroring the JAX functions name for name.

Mixed precision is a policy, as in the reference: activations in the compute
dtype (bfloat16 on CUDA when ``fp16``), LayerNorm, softmax and logits in
fp32.  Attention uses the 4th-root scaling on q and k, with the factor
rounded to the compute dtype first, as JAX rounds it (``scaled_heads``).

The encoder takes the reference's kernel dispatch (its flash-enabled form):
the conv stem kernel emits the trunk input at the tile-padded length
Tp = round_up(n_audio_ctx, 128) (1536 for 1500 frames).  Up to D = 1024
(tiny to medium) every block then runs as the attention + finish kernels
(``_trunk_uses_fused_blocks``); otherwise (large-v3, and head geometries
the fused block does not take) the block is plain PyTorch around the
attention kernel of ``attention``: K8 where the heads pack, K7 where they
do not.  Keys
>= n_audio_ctx are masked throughout, and the padded rows are sliced off
before ``ln_post``.  On CPU tensors the same ops run their plain versions.
The decoder is plain PyTorch (``torch.matmul``), as the JAX package left it
to XLA, except for two kernels of the decode loop: the int8 cross
attention (K9, ``ops/decode_attn.py``) behind an int8 cross cache, and the
opt-in fused single-token step (K10, ``ops/decoder_step.py``) that the
greedy loop takes in place of :func:`decoder_step`.

Two switches, as in the JAX package: :func:`set_flash_attention` (None,
the default: the encoder's kernels on the card and their plain versions on
the CPU; False: the plain versions on the card too, an explicit request,
never a fallback) and :func:`set_remat` (each encoder and decoder block
under ``torch.utils.checkpoint`` when autograd records it: its activations
are recomputed in the backward, kernels included).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops import gelu, head_scale, layer_norm, linear, round_up
from ..ops.conv_stem import _plain_stem, fused_conv_stem
from ..ops.decode_attn import LANE, int8_cross_attention, quantize_kv
from ..ops.encoder_block import (
    _plain_attn_ln, _plain_finish, fused_block_applicable, fused_encoder_block,
)
from ..ops.flash import (
    _plain_attention, _plain_attention_packed, flash_attention, flash_attention_packed,
    packed_applicable,
)
from .dims import ModelDimensions

# None: the encoder's kernels wherever a tensor lies on the card (the
# default); False: their plain versions on the card as well (kernels off,
# as the JAX package's ``set_flash_attention(False)``); True: as None (a
# CPU tensor has no kernel).
_USE_FLASH: Optional[bool] = None
# Recompute each transformer block in the backward (JAX's ``set_remat``).
_USE_REMAT = False


def set_flash_attention(enabled: Optional[bool]) -> None:
    """The encoder's kernels (the stem K2/K3, the fused block K4 + K5/K6,
    the attention kernels K7/K8): None or True on the card, False plain."""
    global _USE_FLASH
    _USE_FLASH = enabled


def _kernels_on() -> bool:
    return _USE_FLASH is not False


def set_remat(enabled: bool) -> None:
    """Rematerialize each encoder and decoder block in the backward
    (``torch.utils.checkpoint``, non-reentrant): less device memory, one
    more forward of every block."""
    global _USE_REMAT
    _USE_REMAT = bool(enabled)


def _maybe_remat(fn, *args):
    """``fn(*args)``, checkpointed where remat is on and autograd records."""
    if _USE_REMAT and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    """Sinusoidal position embeddings (reference model.py sinusoids)."""
    if channels % 2:
        raise ValueError("channels must be even")
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate(
        [np.sin(scaled_time), np.cos(scaled_time)], axis=1
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules (parameter containers with the reference names)
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state)
        self.cross_attn = MultiHeadAttention(n_state, n_head) if cross_attention else None
        self.cross_attn_ln = nn.LayerNorm(n_state) if cross_attention else None
        n_mlp = n_state * 4
        self.mlp = nn.Sequential(
            nn.Linear(n_state, n_mlp), nn.GELU(), nn.Linear(n_mlp, n_state)
        )
        self.mlp_ln = nn.LayerNorm(n_state)


class AudioEncoder(nn.Module):
    def __init__(self, n_mels: int, n_ctx: int, n_state: int, n_head: int,
                 n_layer: int):
        super().__init__()
        self.conv1 = nn.Conv1d(n_mels, n_state, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(n_state, n_state, kernel_size=3, stride=2, padding=1)
        # A parameter (the reference registers a buffer): the JAX package
        # keeps the table among its parameters, so its token trainer updates it.
        self.positional_embedding = nn.Parameter(torch.from_numpy(sinusoids(n_ctx, n_state)))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(n_state, n_head) for _ in range(n_layer)
        )
        self.ln_post = nn.LayerNorm(n_state)


class TextDecoder(nn.Module):
    def __init__(self, n_vocab: int, n_ctx: int, n_state: int, n_head: int,
                 n_layer: int):
        super().__init__()
        self.token_embedding = nn.Embedding(n_vocab, n_state)
        self.positional_embedding = nn.Parameter(torch.empty(n_ctx, n_state))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(n_state, n_head, cross_attention=True)
            for _ in range(n_layer)
        )
        self.ln = nn.LayerNorm(n_state)


class Whisper(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(
            dims.n_mels, dims.n_audio_ctx, dims.n_audio_state, dims.n_audio_head,
            dims.n_audio_layer,
        )
        self.decoder = TextDecoder(
            dims.n_vocab, dims.n_text_ctx, dims.n_text_state, dims.n_text_head,
            dims.n_text_layer,
        )


# ---------------------------------------------------------------------------
# Initialization (the JAX package's distributions, torch.Generator bits)
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, dims: ModelDimensions) -> Dict[str, torch.Tensor]:
    """Random-init state dict with the JAX package's distributions: nn.Linear
    and Conv1d U(+-1/sqrt(fan_in)) for weights and biases, unit LayerNorms,
    token embeddings N(0, 0.02), decoder positions N(0, 0.01), sinusoidal
    encoder positions.  Generated on the CPU, so a seed gives the same
    weights on every device."""
    sd: Dict[str, torch.Tensor] = {}

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    def lin(prefix, d_in, d_out, bias=True):
        bound = 1.0 / math.sqrt(d_in)
        sd[f"{prefix}.weight"] = uniform((d_out, d_in), bound)
        if bias:
            sd[f"{prefix}.bias"] = uniform((d_out,), bound)

    def ln(prefix, d):
        sd[f"{prefix}.weight"] = torch.ones(d)
        sd[f"{prefix}.bias"] = torch.zeros(d)

    def block(prefix, d, cross):
        attns = ("attn", "cross_attn") if cross else ("attn",)
        for a in attns:
            lin(f"{prefix}.{a}.query", d, d)
            lin(f"{prefix}.{a}.key", d, d, bias=False)
            lin(f"{prefix}.{a}.value", d, d)
            lin(f"{prefix}.{a}.out", d, d)
            ln(f"{prefix}.{a}_ln", d)
        lin(f"{prefix}.mlp.0", d, 4 * d)
        lin(f"{prefix}.mlp.2", 4 * d, d)
        ln(f"{prefix}.mlp_ln", d)

    d = dims.n_audio_state
    for name, c_in in (("conv1", dims.n_mels), ("conv2", d)):
        bound = 1.0 / math.sqrt(c_in * 3)
        sd[f"encoder.{name}.weight"] = uniform((d, c_in, 3), bound)
        sd[f"encoder.{name}.bias"] = uniform((d,), bound)
    sd["encoder.positional_embedding"] = torch.from_numpy(
        sinusoids(dims.n_audio_ctx, d)
    )
    for i in range(dims.n_audio_layer):
        block(f"encoder.blocks.{i}", d, cross=False)
    ln("encoder.ln_post", d)

    dt_ = dims.n_text_state
    sd["decoder.token_embedding.weight"] = (
        torch.randn((dims.n_vocab, dt_), generator=generator) * 0.02
    )
    sd["decoder.positional_embedding"] = (
        torch.randn((dims.n_text_ctx, dt_), generator=generator) * 0.01
    )
    for i in range(dims.n_text_layer):
        block(f"decoder.blocks.{i}", dt_, cross=True)
    ln("decoder.ln", dt_)
    return sd


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _split_heads(x, n_head: int):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def scaled_heads(x, n_head: int):
    """(B, T, D) -> (B, H, T, dh) heads times dh^-0.25 rounded to x's dtype,
    equal bit for bit to JAX's ``_split_heads(x, n_head) * scale``."""
    return _split_heads(x, n_head) * head_scale(x.shape[-1] // n_head, x.dtype)


def _merge_heads(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attend(qh, kh, vh, mask=None):
    """softmax(qh kh^T + mask) vh on pre-split, pre-scaled heads; the logits
    and the softmax in fp32."""
    logits = (qh @ kh.transpose(-1, -2)).float()
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(qh.dtype)
    return _merge_heads(w @ vh)


def attention(q, k, v, n_head: int, mask=None, t_real: Optional[int] = None):
    """Multi-head attention with 4th-root scaling; softmax in fp32.

    q: (B, Tq, D), k/v: (B, Tk, D); ``mask`` additive, broadcastable to
    (B, H, Tq, Tk); keys >= ``t_real`` never receive weight.

    Long unmasked queries (the encoder's) take the reference's flash path:
    the packed attention kernel (K8) where the heads pack into its 128-lane
    groups, else the 4D kernel (K7) on the split, scaled heads (strided
    views, no copy; the heads merge again by a free reshape), in the
    reference's order: split, scale, attend, merge.  The reference feeds K7
    an unpadded trunk; the port's trunk is padded, so K7 masks the keys >=
    ``t_real`` (its TPU body's own mask), which gives the same rows.  Short
    queries (decoder prompts and steps) stay plain.  Every head width up to
    ``ops.MAX_HEAD_WIDTH`` runs on the card; on CPU tensors both kernels run
    their plain versions."""
    if mask is None and q.shape[1] >= 512:
        tr = t_real if t_real is not None else k.shape[1]
        on = _kernels_on()
        if packed_applicable(n_head, q.shape[-1]):
            scale = head_scale(q.shape[-1] // n_head, q.dtype)
            packed = flash_attention_packed if on else _plain_attention_packed
            return packed(q * scale, k * scale, v, n_head, min(tr, k.shape[1]))
        attend = flash_attention if on else _plain_attention
        return _merge_heads(attend(scaled_heads(q, n_head), scaled_heads(k, n_head),
                                   _split_heads(v, n_head), min(tr, k.shape[1])))
    if t_real is not None and t_real != k.shape[1]:
        keep = torch.arange(k.shape[1], device=k.device) < t_real
        pad = torch.zeros(k.shape[1], device=k.device).masked_fill(~keep, float("-inf"))
        mask = pad if mask is None else mask + pad
    return _attend(scaled_heads(q, n_head), scaled_heads(k, n_head),
                   _split_heads(v, n_head), mask)


def _self_attn(a, x, n_head: int, mask=None, t_real: Optional[int] = None):
    q, k, v = linear(x, a.query), linear(x, a.key), linear(x, a.value)
    return linear(attention(q, k, v, n_head, mask, t_real), a.out)


def _mlp(mlp, x):
    return linear(gelu(linear(x, mlp[0])), mlp[2])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def dispatch_encoder_apply(encoder, mel, dims: ModelDimensions, compute_dtype=torch.float32,
                           mesh=None):
    """The one quantum-vs-classical encoder dispatch, which every encoder
    call of the port takes (decode, the draft, the decode engine,
    ``embed_audio``, ``forward``).  The variant comes from the encoder
    module itself (a ``qconv1`` stem), so a caller can never pair quantum
    weights with the classical stem.  ``mesh``: see :func:`transformer_trunk`."""
    if hasattr(encoder, "qconv1"):
        from .quantum import quantum_encoder_apply

        return quantum_encoder_apply(encoder, mel, dims, compute_dtype, mesh=mesh)
    return encoder_apply(encoder, mel, dims, compute_dtype, mesh=mesh)


def encoder_apply(encoder: AudioEncoder, mel, dims: ModelDimensions,
                  compute_dtype=torch.float32, mesh=None):
    """Audio encoder forward: (B, n_mels, 2 n_audio_ctx) -> (B, n_audio_ctx, D).
    With ``mesh`` the stem still runs whole on each rank (its rows are this
    data rank's) and the trunk takes the mesh (:func:`transformer_trunk`)."""
    T = dims.n_audio_ctx
    if mel.shape[-1] != 2 * T:
        raise ValueError(f"expected {2 * T} mel frames, got {mel.shape[-1]}")
    # The reference runs its stem kernels where ``ops.conv_stem.
    # stem_applicable`` holds (K2 up to D = 512, K3 up to 1024) and XLA's
    # convolutions otherwise (large-v3).  The port has no plain stem on the
    # card's path, so every size runs the same stem kernel, which takes any
    # D and n_mels and emits the trunk input already padded to Tp.
    from ..parallel import fsdp_view

    encoder = fsdp_view(encoder, skip=("blocks",))
    stem = fused_conv_stem if _kernels_on() else _plain_stem
    x = stem(encoder, mel, round_up(T, 128), compute_dtype)
    return transformer_trunk(encoder, x, dims, t_real=T, mesh=mesh)


def _trunk_uses_fused_blocks(dims: ModelDimensions, t_pad: Optional[int] = None) -> bool:
    """The reference's choice between the fused block kernels and the
    unfused block, in the form it takes off the TPU (fused in f32 and bf16
    alike).  ``t_pad`` is the padded length the kernels will see.  Large
    (D = 1280) stays unfused: the reference measured its fused block no
    faster than the packed-attention path there."""
    if t_pad is None:
        t_pad = round_up(dims.n_audio_ctx, 128)
    return (
        t_pad >= 512
        and dims.n_audio_state <= 1024
        and fused_block_applicable(dims.n_audio_head, dims.n_audio_state, t_pad)
    )


def transformer_trunk(encoder: AudioEncoder, x, dims: ModelDimensions,
                      t_real: Optional[int] = None, mesh=None):
    """Encoder blocks + ``ln_post`` on an embedded (B, T, D) input.  Pass
    ``t_real`` when ``x`` arrives padded already.  The stack runs at the
    tile-padded length where a kernel consumes the padding: padded rows mix
    with real ones only as attention keys, where they are masked, and are
    sliced off at the end.

    With a ``mesh`` (``parallel.Mesh``) whose model axis is > 1, ``x`` is
    this data rank's rows and the trunk is sharded over ``model``, in the
    reference's order: the head-sharded trunk (K4 head-sharded on each rank,
    ``parallel.sharded.tp_trunk``; the encoder must hold this rank's slices,
    ``parallel.shard_params``), else time (``sp_trunk``) where the heads do
    not divide, else layers (``pp_trunk``); where none applies, the
    single-rank trunk on the whole weights."""
    n_head = dims.n_audio_head
    T = t_real if t_real is not None else x.shape[1]
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        from ..parallel import gathered_encoder, sharded

        B = x.shape[0]
        if sharded.tp_trunk_applicable(dims, mesh, B):
            return sharded.tp_trunk(encoder, x, dims, T, mesh)
        if sharded.sp_trunk_applicable(dims, mesh, B, T):
            return sharded.sp_trunk(encoder, x, dims, T, mesh)
        if sharded.pp_trunk_applicable(dims, mesh, B):
            return sharded.pp_trunk(encoder, x, dims, T, mesh)
        encoder = gathered_encoder(encoder, mesh)
    Tp = round_up(T, 128)
    fused = _trunk_uses_fused_blocks(dims, Tp)
    if x.shape[1] != Tp:
        x = F.pad(x, (0, 0, 0, Tp - x.shape[1]))
    block = (_unfused_block if not fused else fused_encoder_block if _kernels_on()
             else _plain_fused_block)
    for bp in encoder.blocks:
        x = _maybe_remat(_gathered(block), x, bp, n_head, T)
    return layer_norm(x[:, :T], encoder.ln_post)


def _gathered(block):
    """``block`` on a view of its module with the FSDP slices gathered
    (``parallel.fsdp_view``), inside the remat region: under remat each
    block's gather is made again in the backward, so only one layer's whole
    weights live at a time."""
    from ..parallel import fsdp_view

    return lambda x, bp, *args: block(x, fsdp_view(bp), *args)


def _unfused_block(x, bp, n_head: int, t_real: int):
    x = x + _self_attn(bp.attn, layer_norm(x, bp.attn_ln), n_head, t_real=t_real)
    return x + _mlp(bp.mlp, layer_norm(x, bp.mlp_ln))


def _plain_fused_block(x, bp, n_head: int, t_real: int):
    """The fused block's plain versions (kernels off)."""
    return _plain_finish(x, _plain_attn_ln(x, bp.attn_ln, bp.attn, n_head, t_real), bp)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _causal_mask(T: int, device):
    keep = torch.arange(T, device=device)[:, None] >= torch.arange(T, device=device)[None, :]
    return torch.zeros(T, T, device=device).masked_fill(~keep, float("-inf"))


def decoder_apply(decoder: TextDecoder, tokens, xa, dims: ModelDimensions,
                  compute_dtype=torch.float32):
    """Teacher-forced decoder: tokens (B, T), xa (B, Ta, D) -> fp32 logits
    (B, T, vocab)."""
    from ..parallel import fsdp_view

    decoder = fsdp_view(decoder, skip=("blocks",))
    T = tokens.shape[1]
    n_head = dims.n_text_head
    x = decoder.token_embedding.weight[tokens] + decoder.positional_embedding[:T]
    x = x.to(compute_dtype)
    xa = xa.to(compute_dtype)
    causal = _causal_mask(T, x.device)
    for bp in decoder.blocks:
        x = _maybe_remat(_gathered(_decoder_block), x, bp, xa, n_head, causal)
    x = layer_norm(x, decoder.ln)
    return (x @ decoder.token_embedding.weight.to(x.dtype).t()).float()


def _decoder_block(x, bp, xa, n_head: int, causal):
    """One teacher-forced decoder block."""
    x = x + _self_attn(bp.attn, layer_norm(x, bp.attn_ln), n_head, causal)
    q = linear(layer_norm(x, bp.cross_attn_ln), bp.cross_attn.query)
    k = linear(xa, bp.cross_attn.key)
    v = linear(xa, bp.cross_attn.value)
    x = x + linear(attention(q, k, v, n_head), bp.cross_attn.out)
    return x + _mlp(bp.mlp, layer_norm(x, bp.mlp_ln))


def decoder_apply_with_cross_qk(decoder: TextDecoder, tokens, xa, dims: ModelDimensions,
                                compute_dtype=torch.float32):
    """Teacher-forced decoder that also returns the raw (pre-softmax,
    4th-root-scaled) cross-attention logits of every layer: (fp32 logits
    (B, T, vocab), qk (L, B, H, T, Ta) fp32), the word-timing alignment's
    input.  Plain ``torch.matmul``, as the JAX function is plain XLA.

    K is projected afresh from ``xa`` and q and k are each scaled by
    dh^-0.25 here; the decode cache's cross K (stored already scaled) is
    not used."""
    T = tokens.shape[1]
    n_head = dims.n_text_head
    x = decoder.token_embedding.weight[tokens] + decoder.positional_embedding[:T]
    x = x.to(compute_dtype)
    xa = xa.to(compute_dtype)
    causal = _causal_mask(T, x.device)
    qks = []
    for bp in decoder.blocks:
        x = x + _self_attn(bp.attn, layer_norm(x, bp.attn_ln), n_head, causal)
        q = linear(layer_norm(x, bp.cross_attn_ln), bp.cross_attn.query)
        k = linear(xa, bp.cross_attn.key)
        v = linear(xa, bp.cross_attn.value)
        qk = (scaled_heads(q, n_head) @ scaled_heads(k, n_head).transpose(-1, -2)).float()
        w = torch.softmax(qk, dim=-1).to(x.dtype)
        x = x + linear(_merge_heads(w @ _split_heads(v, n_head)), bp.cross_attn.out)
        x = x + _mlp(bp.mlp, layer_norm(x, bp.mlp_ln))
        qks.append(qk)
    x = layer_norm(x, decoder.ln)
    logits = (x @ decoder.token_embedding.weight.to(x.dtype).t()).float()
    return logits, torch.stack(qks)


def forward(module: Whisper, mel, tokens, dims: ModelDimensions,
            compute_dtype=torch.float32, mesh=None):
    """Full forward (reference Whisper.forward): mel (B, n_mels, 3000) and
    tokens (B, T) -> fp32 logits (B, T, vocab).  ``mesh`` routes the encoder
    through the sharded trunks (:func:`transformer_trunk`); the rows are
    this data rank's.  A module with FSDP slices (``parallel.fsdp_shard``)
    gathers each block's leaves where the block runs, under grad with a
    reduce-scatter of their gradients."""
    xa = dispatch_encoder_apply(module.encoder, mel, dims, compute_dtype, mesh=mesh)
    return decoder_apply(module.decoder, tokens, xa, dims, compute_dtype)


def init_kv_cache(
    dims: ModelDimensions, batch: int, dtype=torch.float32, device="cuda",
    cross_batch: Optional[int] = None, ctx: Optional[int] = None,
    cross_int8: bool = False,
) -> Dict:
    """KV cache for incremental decoding: one buffer per layer.

    Self K/V are (B, H, ctx, Dh) with ``ctx`` bounded by the caller to the
    reachable length; ``decoder_step`` writes them in place (the JAX cache is
    immutable and returned anew).  Cross K/V are filled once per audio by
    :func:`precompute_cross_kv`, stored head-split and the key pre-scaled, so
    no decode step re-lays them out.  ``idx`` is the write offset: a host int
    (or a 0-d device tensor, see :func:`decoder_step`).

    ``cross_int8`` stores the cross K/V instead as int8 codes (B, H, Tp, Dh)
    with fp32 scales (B, H, Tp), Tp = round_up(n_audio_ctx, 128), the layout
    of the int8 attention kernel (``ops/decode_attn.py``).

    ``cross_batch`` (default ``batch``) is the number of audio rows: beam
    and best-of decode ``batch = cross_batch * G`` hypothesis rows,
    group-major (row i G + g), against a cross cache stored once per audio.
    """
    Bc = batch if cross_batch is None else cross_batch
    if Bc < 1 or batch % Bc:
        raise ValueError(f"{batch} hypothesis rows do not split into groups over "
                         f"{Bc} audio rows")
    L, H = dims.n_text_layer, dims.n_text_head
    Dh = dims.n_text_state // H
    T = min(ctx or dims.n_text_ctx, dims.n_text_ctx)
    z = lambda: torch.zeros(batch, H, T, Dh, dtype=dtype, device=device)
    cache = {
        "self_k": [z() for _ in range(L)],
        "self_v": [z() for _ in range(L)],
        "idx": 0,
    }
    if cross_int8:
        Tp = round_up(dims.n_audio_ctx, LANE)
        codes = lambda: torch.zeros(Bc, H, Tp, Dh, dtype=torch.int8, device=device)
        scales = lambda: torch.zeros(Bc, H, Tp, device=device)
        cache.update({
            "cross_k8": [codes() for _ in range(L)],
            "cross_sk": [scales() for _ in range(L)],
            "cross_v8": [codes() for _ in range(L)],
            "cross_sv": [scales() for _ in range(L)],
        })
    else:
        cache.update({"cross_k": [None] * L, "cross_v": [None] * L})
    return cache


def precompute_cross_kv(decoder: TextDecoder, xa, cache: Dict,
                        n_head: Optional[int] = None, in_place: bool = False) -> Dict:
    """Project the encoder output to every layer's cross K/V once.

    With an int8 cache the projections are quantized here, once per audio:
    the fp32 projections of the fp32 encoder output, unscaled, as the
    reference quantizes them.  ``decoder`` must then hold fp32 cross
    weights (the model's own decoder, not ``decoder_for(bfloat16)``).

    ``in_place`` copies each layer's projections into the cache's own
    cross buffers, which must be allocated, and keeps their addresses (the
    greedy loop's CUDA graph reads them); otherwise they are new tensors."""
    H = n_head if n_head is not None else cache["self_k"][0].shape[1]

    def put(out, name, l, value):
        if in_place:
            out[name][l].copy_(value)
        else:
            out[name].append(value.contiguous())

    if "cross_k8" in cache:
        names = ("cross_k8", "cross_sk", "cross_v8", "cross_sv")
        out = {**cache, **{n: list(cache[n]) if in_place else [] for n in names}}
        xa = xa.float()
        for l, bp in enumerate(decoder.blocks):
            ca = bp.cross_attn
            if ca.key.weight.dtype != torch.float32:
                raise ValueError(
                    "int8 cross K/V quantize the fp32 projections: pass a decoder "
                    f"with fp32 weights, not {ca.key.weight.dtype}")
            for name, lin in (("k", ca.key), ("v", ca.value)):
                codes, scales = quantize_kv(linear(xa, lin), H)
                put(out, f"cross_{name}8", l, codes)
                put(out, f"cross_s{name}", l, scales)
        return out
    dtype = cache["self_k"][0].dtype
    xa = xa.to(dtype)
    out = {**cache, **{n: list(cache[n]) if in_place else [] for n in ("cross_k", "cross_v")}}
    for l, bp in enumerate(decoder.blocks):
        put(out, "cross_k", l, scaled_heads(linear(xa, bp.cross_attn.key), H))
        put(out, "cross_v", l, _split_heads(linear(xa, bp.cross_attn.value), H))
    return out


def _write_self_kv(buf, new, offset):
    """Write ``new`` (B, H, T_new, Dh) into the self cache ``buf`` (B, H,
    Tmax, Dh) in place at ``offset``: a host int (every row at one
    position), a 0-d device tensor (every row at one position the host
    does not read, written by one ``index_copy_`` on the time axis), or a
    (B,) tensor of per-row starts already clamped to [0, Tmax - T_new],
    written by one scatter on the time axis."""
    if isinstance(offset, int):
        buf[:, :, offset:offset + new.shape[2]] = new
        return
    if offset.dim() == 0:  # a one-token step indexes by a view: no launch
        T_new = new.shape[2]
        at = offset.view(1) if T_new == 1 else offset + torch.arange(T_new, device=buf.device)
        buf.index_copy_(2, at, new)
        return
    B, H, T_new, Dh = new.shape
    t = offset[:, None] + torch.arange(T_new, device=buf.device)
    buf.scatter_(2, t[:, None, :, None].expand(B, H, T_new, Dh), new.to(buf.dtype))


def decoder_layer(bp: ResidualAttentionBlock, x, cache: Dict, l: int, offset,
                  mask, n_head: int, t_real_cross: int):
    """Layer ``l`` of :func:`decoder_step` on x (B, T_new, D) at cache
    position ``offset`` (a host int, a 0-d device tensor, or a (B,)
    tensor of per-row write starts), writing its self K/V into the cache
    in place (the JAX step returns a new buffer); ``mask`` (T_new, ctx), or
    (B, 1, T_new, ctx) per row, is additive.  A cross cache of B rows
    serves x's B G rows in groups of G, group-major
    (beam, best-of): K9 takes the groups itself; on the fp cache each
    audio's G T queries attend as one (B, H, G T, dh) block, the JAX
    package's ``_grouped_cross_attention``, so the cache is read once per
    audio and never repeated (G = 1 is the ungrouped step)."""
    scale = head_scale(x.shape[-1] // n_head, cache["self_k"][l].dtype)
    xn = layer_norm(x, bp.attn_ln)
    q = linear(xn, bp.attn.query)
    _write_self_kv(cache["self_k"][l], _split_heads(linear(xn, bp.attn.key), n_head), offset)
    _write_self_kv(cache["self_v"][l], _split_heads(linear(xn, bp.attn.value), n_head),
                   offset)
    a = _attend(scaled_heads(q, n_head), cache["self_k"][l] * scale, cache["self_v"][l], mask)
    x = x + linear(a, bp.attn.out)
    qc = linear(layer_norm(x, bp.cross_attn_ln), bp.cross_attn.query)
    if "cross_k8" in cache:
        ca = int8_cross_attention(
            qc, cache["cross_k8"][l], cache["cross_sk"][l], cache["cross_v8"][l],
            cache["cross_sv"][l], n_head, t_real_cross,
        ).to(x.dtype)
    else:
        B = cache["cross_k"][l].shape[0]
        ca = _attend(scaled_heads(qc.reshape(B, -1, qc.shape[-1]), n_head),
                     cache["cross_k"][l], cache["cross_v"][l]).reshape(x.shape)
    x = x + linear(ca, bp.cross_attn.out)
    return x + _mlp(bp.mlp, layer_norm(x, bp.mlp_ln))


def decoder_step(
    decoder: TextDecoder, tokens, cache: Dict, dims: ModelDimensions,
    compute_dtype=torch.float32, offsets=None,
) -> Tuple[torch.Tensor, Dict]:
    """Incremental decoder forward over ``tokens`` (B, T_new) at cache
    position ``cache['idx']``: (fp32 logits (B, T_new, vocab), updated cache).

    The first call may pass the whole prompt; later calls one token.  An
    int8 cross cache (``init_kv_cache(cross_int8=True)``) runs the int8
    attention kernel (K9), whose fp32 output is cast to the compute dtype.
    A cross cache of B / G rows serves ``tokens``' B rows in groups of G.

    ``offsets`` (B,) int gives each row its own position (speculative
    decode, the decode engine): row b's queries sit at offsets[b] + t, read
    their positional embedding at min(offsets[b] + t, n_text_ctx - 1), see
    the keys at positions <= their own (a per-row causal mask), and write
    their K/V at offsets[b] clamped to [0, Tmax - T_new], as JAX's
    ``dynamic_update_slice`` clamps its start, so the slab always fits.  A
    row rewinds by passing a smaller offset: keys past its position are
    masked and overwritten before any query sees them.  With ``offsets``
    ``cache['idx']`` is neither read nor advanced.  The batch loops keep
    the host-int position: on the card the per-row form with equal
    offsets costs 8-20% more a greedy step (``chip_smoke.py``
    ``loop_forms_ab``).

    ``cache['idx']`` may also be a 0-d device tensor (the greedy loop's
    CUDA graph, ``decode/loop.py``): every row at that position, the host
    int's values bit for bit, without a host read: the self K/V are
    written by one ``index_copy_`` a layer and the positional row is read
    by ``index_select``; the returned ``idx`` is a new tensor."""
    B, T_new = tokens.shape
    H = dims.n_text_head
    Tmax = cache["self_k"][0].shape[2]
    dev = tokens.device
    k_pos = torch.arange(Tmax, device=dev)
    if offsets is None:
        offset = cache["idx"]
        on_device = isinstance(offset, torch.Tensor)
        if not on_device:
            offset = int(offset)
            if offset + T_new > Tmax:
                raise ValueError(f"kv cache of {Tmax} positions is full")
        q_pos = offset + torch.arange(T_new, device=dev)
        mask = torch.zeros(T_new, Tmax, device=dev).masked_fill(
            k_pos[None, :] > q_pos[:, None], float("-inf"))
        if on_device:
            pos = decoder.positional_embedding.index_select(0, q_pos)
        else:
            pos = decoder.positional_embedding[offset:offset + T_new]
        write_at = offset
    else:
        if T_new > Tmax:
            raise ValueError(f"a slab of {T_new} does not fit a cache of {Tmax} positions")
        offsets = torch.as_tensor(offsets, device=dev).long()
        q_pos = offsets[:, None] + torch.arange(T_new, device=dev)  # (B, T_new)
        pos = decoder.positional_embedding[q_pos.clamp_max(dims.n_text_ctx - 1)]
        mask = torch.zeros(B, 1, T_new, Tmax, device=dev).masked_fill(
            (k_pos[None, None, :] > q_pos[:, :, None])[:, None], float("-inf"))
        write_at = offsets.clamp(0, Tmax - T_new)
    x = (decoder.token_embedding.weight[tokens] + pos).to(compute_dtype)
    for l, bp in enumerate(decoder.blocks):
        x = decoder_layer(bp, x, cache, l, write_at, mask, H, dims.n_audio_ctx)
    x = layer_norm(x, decoder.ln)
    logits = (x @ decoder.token_embedding.weight.to(x.dtype).t()).float()
    if offsets is not None:
        return logits, {**cache}
    return logits, {**cache, "idx": offset + T_new}


def is_multilingual(dims: ModelDimensions) -> bool:
    return dims.n_vocab >= 51865


def num_languages(dims: ModelDimensions) -> int:
    return dims.n_vocab - 51765 - int(is_multilingual(dims))
