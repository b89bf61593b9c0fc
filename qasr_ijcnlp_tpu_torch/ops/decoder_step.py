"""Fused decoder-layer step (K10): one kernel launch per decoder layer per
token.  Opt-in, default off, as in the reference.

Replaces ``qasr_ijcnlp_tpu/ops/decoder_step.py`` ``_kernel``: a decoder
layer's single-token step, LN -> q/k/v -> self-attention over the cache
with the fresh k/v -> out-proj -> cross LN -> q -> cross-attention ->
out-proj -> LN -> MLP (exact-erf GELU), for B rows at once.  Numerics
follow the reference kernel: LN and softmax in fp32; every product takes
its inputs in the compute dtype and sums in fp32; each product's output is
rounded to the compute dtype where the reference rounds it (q after its
scale, each residual branch, the GELU output, the attention outputs); the
softmax denominator sums the unrounded p and PV takes p rounded to the
compute dtype.  The reference kernel used an Abramowitz-Stegun erf; the
port uses exact ``erff``.

Caches: the kernel reads the port's own cache layout, so ``to_fused_cache``
converts nothing.  Self K/V are (B, H, ctx, 64) and unscaled: the self q is
scaled by Dh^-0.5, as in the reference.  The cross K is stored pre-scaled
by Dh^-0.25 rounded to the compute dtype (``models.whisper.
precompute_cross_kv``), so the cross q is scaled by Dh^-0.25 (not the
reference's Dh^-0.5 against an unscaled K); the two differ by the rounding
of K's scale, inside the parity tolerances of the reference's own test.
The kernel writes the fresh k/v into the self cache at ``idx`` in place
and attends over positions 0..idx.

On the H100 (``csrc/decoder_step.cu``) it is one cooperative launch with a
grid-wide barrier between the eight phases: LN + q/k/v; self-attention;
out-proj; cross LN + q; cross-attention; out-proj; LN + fc + GELU; proj.
It is bound by the bytes it streams, the cross K/V above all (73.7 MB of
its 85 MB at tiny, B = 16, f32).  Both attentions split over (row, head,
chunk) items (:func:`attention_split`, which the wrapper passes the
kernel), the chunks' softmax partials merged in fp32 in the next phase's
input; the cross K/V reach shared memory by bulk copies in a ring of
stages, issued by a producer warpgroup; the products run in units of 8 or
16 rows x a slab of columns that read each weight element once per row
tile.  (A literal copy of the TPU grid, batch tiles of 8 rows, would put 2
blocks on 132 SMs at B = 16.)

A layer's weights are packed once per decoder and compute dtype
(:func:`layer_packs`) into one tensor in the compute dtype and one fp32
tensor of LayerNorm parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _kernels
from . import layer_norm, round_up

BT = 8    # batch rows per tile: the batch must be a multiple of it
DH = 64   # head width
CHUNK_BYTES = 32768  # an attention item's K rows, at most: a ring stage holds its K and V

# Default OFF, as in the reference: it ships as an opt-in path.  None = OFF.
_ENABLED: Optional[bool] = None

launches = 0


def set_fused_decoder_step(enabled: Optional[bool]) -> None:
    global _ENABLED
    _ENABLED = enabled


def fused_step_enabled() -> bool:
    if _ENABLED is None:
        return False
    return bool(_ENABLED)


def fused_step_applicable(n_head: int, d_model: int, batch: int,
                          groups: int = 1) -> bool:
    """The reference's gate, clause for clause: tiny and base widths with
    64-wide heads, batch tiles of 8 rows, no beam groups."""
    return (
        d_model in (384, 512)
        and d_model % n_head == 0
        and d_model // n_head == 64
        and batch % BT == 0
        and groups == 1
    )


def fused_cache_applicable(cache: Dict, dims, batch: int) -> bool:
    """True for a filled fp cross cache of ``batch`` rows (an int8 cache has
    no ``cross_k``, so int8 wins over fused) at a geometry the kernel takes."""
    cross = cache.get("cross_k")
    return (
        cross is not None
        and cross[0] is not None
        and cross[0].shape[0] == batch
        and fused_step_applicable(dims.n_text_head, dims.n_text_state, batch)
    )


def attention_split(t_vis: int, elem: int = 4) -> Tuple[int, int]:
    """(C, S): the kernel's split of ``t_vis`` visible positions into S
    chunks of C, item s taking [s C, min(t_vis, (s + 1) C)), for a compute
    dtype of ``elem`` bytes.  C is the least multiple of 16 that holds
    t_vis, up to the ``CHUNK_BYTES`` of K rows a ring stage takes (128
    positions in f32, 256 in bf16), so no chunk is empty: 12 chunks of 128
    over 1,500 audio positions in f32 (6 of 256 in bf16), one of 80 over 67
    self positions."""
    C = min(CHUNK_BYTES // (DH * elem), round_up(t_vis, 16))
    return C, -(-t_vis // C)


def _work_floats(B: int, D: int, n_head: int, self_chunks: int, cross_chunks: int) -> int:
    """fp32 scratch of one launch: q, cross q, the two residual streams and
    the MLP's hidden rows (8 B D), then each attention item's (acc[64], m,
    l)."""
    return B * 8 * D + B * n_head * (self_chunks + cross_chunks) * (DH + 2)


def to_fused_cache(cache: Dict, dims) -> Dict:
    """The cache in the kernel's layout, which is the port's own: returned
    as it is (the reference converts to its T-on-lanes layout here)."""
    return cache


# ---------------------------------------------------------------------------
# Packed weights
# ---------------------------------------------------------------------------


def _offsets(D: int, F_: int) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """name -> (offset, shape) in a layer's packed tensor (nn.Linear (out,
    in) layout, the q/k/v weights stacked, k's bias a row of zeros)."""
    layout = [("wqkv", (3 * D, D)), ("wo", (D, D)), ("wcq", (D, D)), ("wco", (D, D)),
              ("wf", (F_, D)), ("wp", (D, F_)), ("bqkv", (3 * D,)), ("bo", (D,)),
              ("bcq", (D,)), ("bco", (D,)), ("bf", (F_,)), ("bp", (D,))]
    out, off = {}, 0
    for name, shape in layout:
        out[name] = (off, shape)
        off += math.prod(shape)
    out["_total"] = (off, ())
    return out


LN_NAMES = ("attn_ln", "cross_attn_ln", "mlp_ln")


def pack_layer(block, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block -> (its weights and biases in ``dtype``, packed as
    ``_offsets`` says; its three LayerNorms' (weight, bias) in fp32)."""
    a, c, m = block.attn, block.cross_attn, block.mlp
    parts = [a.query.weight, a.key.weight, a.value.weight, a.out.weight,
             c.query.weight, c.out.weight, m[0].weight, m[2].weight,
             a.query.bias, torch.zeros_like(a.query.bias), a.value.bias, a.out.bias,
             c.query.bias, c.out.bias, m[0].bias, m[2].bias]
    packed = torch.cat([p.reshape(-1).to(dtype) for p in parts])
    ln = torch.cat([p.float().reshape(-1) for name in LN_NAMES
                    for p in (getattr(block, name).weight, getattr(block, name).bias)])
    return packed, ln


def layer_packs(decoder, dtype) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every layer's packs for ``dtype``, built at first use and kept on the
    decoder, so a step never re-packs a weight.  They are tied to the
    decoder's first weight tensor: a deep copy (``WhisperModel.
    decoder_for``) packs its own."""
    owner = decoder.blocks[0].attn.query.weight
    kept = decoder.__dict__.get("_fused_packs")
    if kept is None or kept[0] is not owner:
        kept = decoder.__dict__["_fused_packs"] = (owner, {})
    packs = kept[1]
    if dtype not in packs:
        packs[dtype] = [pack_layer(bp, dtype) for bp in decoder.blocks]
    return packs[dtype]


def _unpack(packed: torch.Tensor, ln: torch.Tensor, D: int) -> Dict[str, torch.Tensor]:
    F_ = 4 * D
    views = {name: packed[off:off + math.prod(shape)].view(shape)
             for name, (off, shape) in _offsets(D, F_).items() if name != "_total"}
    for i, name in enumerate(("g1", "b1", "gc", "bc", "g2", "b2")):
        views[name] = ln[i * D:(i + 1) * D]
    return views


# ---------------------------------------------------------------------------
# One layer: plain version and kernel
# ---------------------------------------------------------------------------


def _ln(x, g, b, dt):
    """fp32 LayerNorm -> rounded to ``dt`` (as fp32 values)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + 1e-5) * g + b).to(dt).float()


def _attend_one_token(q, k, v, dt):
    """q (B, H, 64) fp32 holding compute-dtype values; k/v (B, H, T, 64) of
    the visible positions -> (B, H, 64) rounded to ``dt``: fp32 softmax, the
    denominator over the unrounded p, PV over p rounded to ``dt``."""
    logits = torch.einsum("bhd,bhtd->bht", q, k.float())
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)
    out = torch.einsum("bht,bhtd->bhd", p.to(dt).float(), v.float())
    return (out / s).to(dt).float()


def fused_decoder_layer_step_plain(x, packed, ln, self_k, self_v, cross_k, cross_v,
                                   idx: int, n_head: int):
    """Plain PyTorch version of the kernel: one decoder layer's step for one
    token per row.  x (B, D) in the compute dtype; self K/V (B, H, ctx, 64),
    written at ``idx`` in place; cross K/V (B, H, Ta, 64), K pre-scaled by
    Dh^-0.25 -> (B, D) in x's dtype."""
    B, D = x.shape
    dt = x.dtype
    H = n_head
    w = {k: v.float() for k, v in _unpack(packed, ln, D).items()}
    r = lambda t: t.to(dt).float()
    heads = lambda t: t.reshape(B, H, DH)
    xf = x.float()

    h = _ln(x, w["g1"], w["b1"], dt)
    qkv = h @ w["wqkv"].t() + w["bqkv"]
    q = r(qkv[:, :D] * float(DH) ** -0.5)
    self_k[:, :, idx] = heads(qkv[:, D:2 * D]).to(self_k.dtype)
    self_v[:, :, idx] = heads(qkv[:, 2 * D:]).to(self_v.dtype)
    a = _attend_one_token(heads(q), self_k[:, :, :idx + 1], self_v[:, :, :idx + 1], dt)
    xmid = r(xf + r(a.reshape(B, D) @ w["wo"].t() + w["bo"]))

    hc = _ln(xmid, w["gc"], w["bc"], dt)
    qc = r((hc @ w["wcq"].t() + w["bcq"]) * float(DH) ** -0.25)
    ca = _attend_one_token(heads(qc), cross_k, cross_v, dt)
    x2 = r(xmid + r(ca.reshape(B, D) @ w["wco"].t() + w["bco"]))

    h2 = _ln(x2, w["g2"], w["b2"], dt)
    t = r(F.gelu(h2 @ w["wf"].t() + w["bf"]))
    return (x2 + r(t @ w["wp"].t() + w["bp"])).to(dt)


def fused_decoder_layer_step(x, packed, ln, self_k, self_v, cross_k, cross_v,
                             idx: int, n_head: int):
    """One decoder layer's single-token step, fused; see
    :func:`fused_decoder_layer_step_plain` for the arguments.  On CUDA
    tensors it is one kernel launch (K10)."""
    if not x.is_cuda:
        return fused_decoder_layer_step_plain(x, packed, ln, self_k, self_v, cross_k,
                                              cross_v, idx, n_head)
    global launches
    dt = x.dtype
    if x.dim() != 2 or dt not in _kernels.DTYPE_CODES:
        raise ValueError(f"fused_decoder_layer_step: expected (B, D) float32/bfloat16 "
                         f"x, got {tuple(x.shape)} {dt}")
    B, D = x.shape
    H = n_head
    ctx, Ta = self_k.shape[2], cross_k.shape[2]
    if not fused_step_applicable(H, D, B):
        raise ValueError(f"fused_decoder_layer_step: B={B}, D={D}, {H} heads is not "
                         f"a geometry of the kernel (fused_step_applicable)")
    if (self_k.shape != (B, H, ctx, DH) or self_v.shape != self_k.shape
            or cross_k.shape != (B, H, Ta, DH) or cross_v.shape != cross_k.shape):
        raise ValueError(f"fused_decoder_layer_step: caches {tuple(self_k.shape)}, "
                         f"{tuple(cross_k.shape)} do not fit x {tuple(x.shape)}")
    if packed.numel() != _offsets(D, 4 * D)["_total"][0] or ln.numel() != 6 * D:
        raise ValueError("fused_decoder_layer_step: packed weights do not fit D")
    if not 0 <= idx < ctx:
        raise ValueError(f"fused_decoder_layer_step: idx={idx} outside the cache "
                         f"of {ctx} positions")
    x = x.contiguous()
    out = torch.empty_like(x)
    cs, ss = attention_split(idx + 1, x.element_size())
    cx, sx = attention_split(Ta, x.element_size())
    work = torch.empty(_work_floats(B, D, H, ss, sx), dtype=torch.float32, device=x.device)
    _kernels.check_cuda("fused_decoder_layer_step", x, packed, self_k, self_v, cross_k,
                        cross_v, out, dtype=dt)
    _kernels.check_cuda("fused_decoder_layer_step", x, ln, work)
    if ln.dtype != torch.float32:
        raise ValueError("fused_decoder_layer_step: LayerNorm parameters must be fp32")
    if any(t.data_ptr() % 16 for t in (x, packed, self_k, self_v, cross_k, cross_v)):
        raise ValueError("fused_decoder_layer_step: x, weights and caches must be "
                         "16-byte aligned")
    _kernels.library().call(
        "qasr_decoder_layer_step", x.device, _kernels.DTYPE_CODES[dt],
        x.data_ptr(), packed.data_ptr(), ln.data_ptr(), self_k.data_ptr(),
        self_v.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(), out.data_ptr(),
        work.data_ptr(), B, D, H, ctx, Ta, idx, cs, ss, cx, sx, x.device.index or 0,
    )
    launches += 1
    return out


# ---------------------------------------------------------------------------
# Whole step: drop-in for models.whisper.decoder_step with one token per row
# ---------------------------------------------------------------------------


def fused_decoder_step(decoder, tokens, cache: Dict, dims,
                       compute_dtype=torch.float32):
    """Single-token incremental decoder step over the fused layer kernel,
    with ``models.whisper.decoder_step``'s contract for T_new = 1 and the
    cache's scalar ``idx``: (fp32 logits (B, 1, vocab), updated cache)."""
    B, t_new = tokens.shape
    if t_new != 1:
        raise ValueError(f"fused_decoder_step takes one token per row, got {t_new}")
    idx = int(cache["idx"])
    if idx >= cache["self_k"][0].shape[2]:
        raise ValueError(f"kv cache of {cache['self_k'][0].shape[2]} positions is full")
    pos = decoder.positional_embedding[idx]
    x = (decoder.token_embedding.weight[tokens[:, 0]] + pos).to(compute_dtype)
    for l, (packed, ln) in enumerate(layer_packs(decoder, compute_dtype)):
        x = fused_decoder_layer_step(
            x, packed, ln, cache["self_k"][l], cache["self_v"][l],
            cache["cross_k"][l], cache["cross_v"][l], idx, dims.n_text_head,
        )
    x = layer_norm(x, decoder.ln)
    logits = (x @ decoder.token_embedding.weight.to(x.dtype).t()).float()
    return logits[:, None, :], {**cache, "idx": idx + 1}
