"""Fused encoder transformer block: attention half (K4) and finish half
(K5 at D <= 512, K6 at D > 512).

Replaces, in ``qasr_ijcnlp_tpu/ops/encoder_block.py``, ``_attn_kernel``
(fp32 LN -> Q/K/V projections, q and k scaled by dh^-0.25 -> masked softmax
attention), ``_finish_kernel`` and ``_finish_kernel_ftiled`` (x + attn Wo +
bo -> LN -> fc -> exact GELU -> proj -> residual).  All work on the model's
own row-major (B, Tp, D) tensor; keys at positions >= ``t_real`` are masked
and query rows past it compute values the caller slices away.

The TPU needed a second finish kernel above D = 512 only because the
(D, 4D) MLP weights no longer fit VMEM: K6 streams them in FT-column blocks
and carries the proj sum in fp32 across the blocks.  ``qasr_finish`` already
sums proj over all of F in fp32 and rounds once, at the same points, and its
GEMM tile does not depend on D, so the same kernel is K6's counterpart at
D = 768 and 1024.  It stores the GELU intermediate t (B, Tp, 4D) in device
memory (201 MB in f32 at medium, B = 8); keeping t on chip is later work.

On the H100 (``csrc/encoder_block.cu``) the attention is an online-softmax
kernel per (64-query tile, head, batch item) that never writes the (T, T)
logits and skips key tiles past ``t_real``, at any head width up to
``MAX_HEAD_WIDTH`` (the JAX gate sends heads of 64 and 128 here, and the
kernel runs both); the projections and the MLP are
SIMT fp32-accumulating GEMMs with fused epilogues.  Both halves are bound by
FMA throughput on the CUDA cores until the GEMMs move to wgmma.

Weights are read in the nn.Linear layout (out, in) of the port's modules and
cast to the activation dtype per call, as the reference casts its fp32
parameters per op; LN and softmax stay fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from . import gelu, head_scale, kernel_head_width, layer_norm, linear

attn_launches = 0
finish_launches = 0


def fused_block_applicable(n_head: int, d_model: int, t_pad: int,
                           mlp_width: Optional[int] = None) -> bool:
    """The reference's gate for the fused block (``fused_block_applicable``
    with its ``attn_applicable``), so the encoder dispatch decides as the
    reference's does.  Its clauses are the TPU kernels' tiles: heads of 128
    lanes or pairs of 64, a padded length in 512-row tiles, and above
    D = 512 an MLP width in the F-tiled finish's column blocks (1024 up to
    D = 1024, else 512)."""
    F = 4 * d_model if mlp_width is None else mlp_width
    d_head = d_model // n_head if d_model % n_head == 0 else 0
    return (
        d_model <= 1280
        and d_model % 128 == 0
        and (d_head == 128 or (d_head == 64 and n_head % 2 == 0))
        and t_pad % 512 == 0
        and (d_model <= 512 or F % (1024 if d_model <= 1024 else 512) == 0)
    )


def _plain_attn_ln(x, ln, attn, n_head: int, t_real: int):
    """Plain PyTorch LN + QKV + masked softmax attention (before the
    out-projection): (B, Tp, D) -> (B, Tp, D)."""
    B, Tp, D = x.shape
    dt = x.dtype
    dh = D // n_head
    scale = head_scale(dh, dt)
    h = layer_norm(x, ln)
    q = linear(h, attn.query) * scale
    k = linear(h, attn.key) * scale
    v = linear(h, attn.value)
    split = lambda z: z.reshape(B, Tp, n_head, dh).transpose(1, 2)
    logits = (split(q) @ split(k).transpose(-1, -2)).float()
    if t_real != Tp:
        keep = torch.arange(Tp, device=x.device) < t_real
        logits = logits.masked_fill(~keep, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(dt)
    return (w @ split(v)).transpose(1, 2).reshape(B, Tp, D)


def _plain_finish(x, attn_out, block):
    """Plain PyTorch out-projection + residual, LN + MLP + residual."""
    r = x + linear(attn_out, block.attn.out)
    t = gelu(linear(layer_norm(r, block.mlp_ln), block.mlp[0]))
    return r + linear(t, block.mlp[2])


def _check_block_input(name, x, n_head, t_real):
    if x.dim() != 3 or x.dtype not in _kernels.DTYPE_CODES:
        raise ValueError(f"{name}: expected (B, Tp, D) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    kernel_head_width(name, x.shape[-1], n_head)
    if not 1 <= t_real <= x.shape[1]:
        raise ValueError(f"{name}: t_real={t_real} outside [1, {x.shape[1]}]")


def fused_attention_ln(x, ln, attn, n_head: int, t_real: int):
    """LN + QKV projection + softmax(QK^T)V over ``n_head`` heads, stopping
    before the output projection: (B, Tp, D) -> (B, Tp, D).

    ``ln`` is the block's ``attn_ln`` (nn.LayerNorm) and ``attn`` its
    attention module (``query``/``key``/``value`` nn.Linear)."""
    if not x.is_cuda:
        return _plain_attn_ln(x, ln, attn, n_head, t_real)
    global attn_launches
    _check_block_input("fused_attention_ln", x, n_head, t_real)
    B, Tp, D = x.shape
    dt = x.dtype
    wqkv = torch.cat(
        [attn.query.weight, attn.key.weight, attn.value.weight]
    ).to(dt).contiguous()
    bqkv = torch.cat(
        [attn.query.bias, torch.zeros_like(attn.query.bias), attn.value.bias]
    ).to(dt).contiguous()
    g = ln.weight.float().contiguous()
    b = ln.bias.float().contiguous()
    h = torch.empty_like(x)
    qkv = x.new_empty(B, Tp, 3 * D)
    out = torch.empty_like(x)
    _kernels.check_cuda("fused_attention_ln", x, wqkv, bqkv, h, qkv, out, dtype=dt)
    _kernels.check_cuda("fused_attention_ln", x, g, b)
    _kernels.library().call(
        "qasr_attention", x.device, _kernels.DTYPE_CODES[dt],
        x.data_ptr(), g.data_ptr(), b.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), head_scale(D // n_head, dt), h.data_ptr(), qkv.data_ptr(),
        out.data_ptr(), B, Tp, D, n_head, t_real,
    )
    attn_launches += 1
    return out


def fused_block_finish(x, attn_out, block):
    """x + attn_out Wo + bo, then LN + fc + exact GELU + proj + residual:
    (B, Tp, D) -> (B, Tp, D)."""
    if not x.is_cuda:
        return _plain_finish(x, attn_out, block)
    global finish_launches
    dt = x.dtype
    if x.dim() != 3 or dt not in _kernels.DTYPE_CODES or attn_out.shape != x.shape:
        raise ValueError("fused_block_finish: expected matching (B, Tp, D) "
                         "float32/bfloat16 inputs")
    B, Tp, D = x.shape
    M = B * Tp
    fc, proj, wo = block.mlp[0], block.mlp[2], block.attn.out
    F = fc.weight.shape[0]
    w = lambda p: p.to(dt).contiguous()
    ws = [w(wo.weight), w(wo.bias), w(fc.weight), w(fc.bias), w(proj.weight),
          w(proj.bias)]
    g = block.mlp_ln.weight.float().contiguous()
    b = block.mlp_ln.bias.float().contiguous()
    attn_out = attn_out.contiguous()
    r = torch.empty_like(x)
    h = torch.empty_like(x)
    t = x.new_empty(B, Tp, F)
    out = torch.empty_like(x)
    _kernels.check_cuda("fused_block_finish", x, attn_out, *ws, r, h, t, out,
                        dtype=dt)
    _kernels.check_cuda("fused_block_finish", x, g, b)
    _kernels.library().call(
        "qasr_finish", x.device, _kernels.DTYPE_CODES[dt],
        x.data_ptr(), attn_out.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
        g.data_ptr(), b.data_ptr(), ws[2].data_ptr(), ws[3].data_ptr(),
        ws[4].data_ptr(), ws[5].data_ptr(), r.data_ptr(), h.data_ptr(),
        t.data_ptr(), out.data_ptr(), M, D, F,
    )
    finish_launches += 1
    return out


def fused_encoder_block(x, block, n_head: int, t_real: int):
    """One whole encoder block: (B, Tp, D) -> (B, Tp, D).  ``block`` is the
    port's ResidualAttentionBlock (reference state-dict names)."""
    attn_out = fused_attention_ln(x, block.attn_ln, block.attn, n_head, t_real)
    return fused_block_finish(x, attn_out, block)
