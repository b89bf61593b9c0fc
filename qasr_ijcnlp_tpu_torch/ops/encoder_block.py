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
memory (201 MB in f32 at medium, B = 8; twice that as 3xTF32's hi/lo
slabs): at D = 1024 a 64-row fp32 proj accumulator over all D columns is
256 KB, over a warpgroup's registers, and splitting proj's columns would
recompute the fc product once per split.

On the H100 (``csrc/encoder_block.cu``) every product runs on the tensor
cores: the four projections on one wgmma + TMA GEMM with the reference's
rounding points fused into its epilogues (``csrc/gemm_tc.cuh``), and the
attention on the core K7 and K8 share (``csrc/attention_tc.cuh``), with
K4's rounded-p denominator, heads of 64 and 128 (the JAX gate's).  f32 runs
as 3xTF32 (hi/lo operand slabs, three products); the kernels take D and
the MLP width in multiples of ``GEMM_TILE``.

Weights are read in the nn.Linear layout (out, in) of the port's modules,
cast to the activation dtype (the reference casts its fp32 parameters per
op; casting once gives the same values) and, in f32, split into TF32 hi/lo
slabs, once per module and dtype (``attention_pack``, ``finish_pack``): 12
D^2 values a layer, 100 MB at medium in f32.  LN and softmax stay fp32.
"""

from __future__ import annotations

from types import SimpleNamespace as _NS
from typing import Optional

import torch

from .. import _kernels
from . import (
    gelu, head_scale, kernel_head_width, layer_norm, linear, plain_vjp, recording_ops, wants_grad,
)

attn_launches = 0
finish_launches = 0
gemm_launches = 0  # block_gemm alone (tests and timing), not the block's
# The GEMM's tile edge (csrc/gemm_tc.cuh): D and the MLP width must be
# multiples of it, as on every width the fused-block gate admits.
GEMM_TILE = 128


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
    dh = kernel_head_width(name, x.shape[-1], n_head)
    if x.shape[-1] % GEMM_TILE or dh not in (64, 128):
        raise ValueError(f"{name}: the kernel takes D a multiple of {GEMM_TILE} in heads "
                         f"of 64 or 128 (the fused-block gate's), got D={x.shape[-1]} "
                         f"in {n_head} heads")
    if not 1 <= t_real <= x.shape[1]:
        raise ValueError(f"{name}: t_real={t_real} outside [1, {x.shape[1]}]")


def _check_aligned(name, *tensors):
    """The kernels load pairs and TMA boxes: every base 16-byte aligned."""
    if any(t.data_ptr() % 16 for t in tensors if t is not None):
        raise ValueError(f"{name}: expected 16-byte aligned tensors")


def tf32(x):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds (finite values)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def gemm_operand(w, dtype):
    """A GEMM operand (rows, K) as the kernel reads it: in bfloat16 one
    slab (1, rows, K); in float32 the two slabs of 3xTF32, hi = tf32(w) and
    lo = tf32(w - hi), (2, rows, K).  hi + lo is w to within 2^-22 of |w|
    (lo keeps 11 of the residual's 13 bits)."""
    if dtype == torch.bfloat16:
        return w.to(dtype).unsqueeze(0).contiguous()
    w = w.float()
    hi = tf32(w)
    return torch.stack([hi, tf32(w - hi)])


def _version(t) -> int:
    """``t``'s in-place version counter (0 for an inference tensor, which
    keeps none and cannot be changed outside inference mode)."""
    return 0 if t.is_inference() else t._version


def _kept(module, owners, dtype, build):
    """``build()``'s pack for ``module`` in ``dtype``, made at first use (with
    no autograd record) and kept on the module; made anew once any of
    ``owners``, the tensors it packs, lies in another storage or dtype (a
    deep copy, a reloaded or a recast module) or was changed in place (an
    optimizer step)."""
    tag = tuple((t.data_ptr(), t.dtype, _version(t)) for t in owners)
    kept = module.__dict__.get("_encoder_packs")
    if kept is None or kept[0] != tag:
        kept = module.__dict__["_encoder_packs"] = (tag, {})
    if dtype not in kept[1]:
        with torch.no_grad():
            kept[1][dtype] = build()
    return kept[1][dtype]


def _attention_weights(ln, attn):
    """K4's weights in the order its Function takes them."""
    return (ln.weight, ln.bias, attn.query.weight, attn.query.bias, attn.key.weight,
            attn.value.weight, attn.value.bias)


def _finish_weights(block):
    """K5/K6's weights in the order its Function takes them."""
    wo, fc, proj, ln = block.attn.out, block.mlp[0], block.mlp[2], block.mlp_ln
    return (wo.weight, wo.bias, ln.weight, ln.bias, fc.weight, fc.bias, proj.weight,
            proj.bias)


def attention_pack(ln, attn, dtype):
    """K4's weights in ``dtype``, packed once per module and dtype: the
    stacked (3D, D) Q/K/V weight as a GEMM operand (``gemm_operand``), the
    (3D,) bias [bq | 0 | bv] in ``dtype`` and the LayerNorm's weight and
    bias in fp32.  Kept on ``attn``."""
    def build():
        q, k, v = attn.query, attn.key, attn.value
        return {
            "wqkv": gemm_operand(torch.cat([q.weight, k.weight, v.weight]), dtype),
            "bqkv": torch.cat([q.bias, torch.zeros_like(q.bias), v.bias]).to(dtype),
            "g": ln.weight.float().contiguous(), "b": ln.bias.float().contiguous(),
        }
    return _kept(attn, _attention_weights(ln, attn), dtype, build)


def finish_pack(block, dtype):
    """K5/K6's weights in ``dtype``, packed once per module and dtype: the
    out-projection, fc and proj weights as GEMM operands, their biases in
    ``dtype`` and the MLP LayerNorm's weight and bias in fp32.  Kept on
    ``block``."""
    def build():
        wo, fc, proj, ln = block.attn.out, block.mlp[0], block.mlp[2], block.mlp_ln
        return {
            "wo": gemm_operand(wo.weight, dtype), "bo": wo.bias.to(dtype).contiguous(),
            "wf": gemm_operand(fc.weight, dtype), "bf": fc.bias.to(dtype).contiguous(),
            "wp": gemm_operand(proj.weight, dtype), "bp": proj.bias.to(dtype).contiguous(),
            "g": ln.weight.float().contiguous(), "b": ln.bias.float().contiguous(),
        }
    return _kept(block, _finish_weights(block), dtype, build)


def _slabs(dtype) -> int:
    """Slabs of a GEMM A operand: hi and lo in float32, one in bfloat16."""
    return 2 if dtype == torch.float32 else 1


def fused_attention_ln(x, ln, attn, n_head: int, t_real: int):
    """LN + QKV projection + softmax(QK^T)V over ``n_head`` heads, stopping
    before the output projection: (B, Tp, D) -> (B, Tp, D).

    ``ln`` is the block's ``attn_ln`` (nn.LayerNorm) and ``attn`` its
    attention module (``query``/``key``/``value`` nn.Linear).  Where
    autograd must record the call, it goes through
    :class:`AttentionLNFunction`."""
    weights = _attention_weights(ln, attn)
    if recording_ops():
        return torch.ops.qasr.attention_ln(x, *weights, n_head, t_real)
    if not x.is_cuda:
        return _plain_attn_ln(x, ln, attn, n_head, t_real)
    if wants_grad(x, *weights):
        return AttentionLNFunction.apply(x, *weights, ln, attn, n_head, t_real)
    return _launch_attention(x, ln, attn, n_head, t_real)


def _launch_attention(x, ln, attn, n_head: int, t_real: int):
    """K4 on the card."""
    global attn_launches
    _check_block_input("fused_attention_ln", x, n_head, t_real)
    B, Tp, D = x.shape
    dt = x.dtype
    p = attention_pack(ln, attn, dt)
    h = x.new_empty(_slabs(dt), B * Tp, D)
    qkv = x.new_empty(B, Tp, 3 * D)
    out = torch.empty_like(x)
    _kernels.check_cuda("fused_attention_ln", x, p["wqkv"], p["bqkv"], h, qkv, out, dtype=dt)
    _kernels.check_cuda("fused_attention_ln", x, p["g"], p["b"])
    _check_aligned("fused_attention_ln", x, h, qkv, out)
    _kernels.library().call(
        "qasr_attention", x.device, _kernels.DTYPE_CODES[dt],
        x.data_ptr(), p["g"].data_ptr(), p["b"].data_ptr(), p["wqkv"].data_ptr(),
        p["bqkv"].data_ptr(), head_scale(D // n_head, dt), h.data_ptr(), qkv.data_ptr(),
        out.data_ptr(), B, Tp, D, n_head, t_real,
    )
    attn_launches += 1
    return out


class AttentionLNFunction(torch.autograd.Function):
    """K4 with a gradient: the forward is the kernel, the backward the VJP
    of ``_plain_attn_ln`` recomputed from the saved input and weights (the
    JAX package's custom VJP, ``qasr_ijcnlp_tpu/ops/encoder_block.py``
    ``_attn_ln_bwd``, differentiates its XLA form the same way)."""

    @staticmethod
    def forward(ctx, x, g, b, wq, bq, wk, wv, bv, ln, attn, n_head, t_real):
        ctx.save_for_backward(x, g, b, wq, bq, wk, wv, bv)
        ctx.n_head, ctx.t_real = n_head, t_real
        return _launch_attention(x, ln, attn, n_head, t_real)

    @staticmethod
    def backward(ctx, grad):
        def plain(x, g, b, wq, bq, wk, wv, bv):
            attn = _NS(query=_NS(weight=wq, bias=bq), key=_NS(weight=wk, bias=None),
                       value=_NS(weight=wv, bias=bv))
            return _plain_attn_ln(x, _NS(weight=g, bias=b), attn, ctx.n_head, ctx.t_real)
        return (*plain_vjp(ctx, plain, grad), None, None, None, None)


def fused_block_finish(x, attn_out, block):
    """x + attn_out Wo + bo, then LN + fc + exact GELU + proj + residual:
    (B, Tp, D) -> (B, Tp, D).  Where autograd must record the call, it
    goes through :class:`BlockFinishFunction`."""
    weights = _finish_weights(block)
    if recording_ops():
        return torch.ops.qasr.block_finish(x, attn_out, *weights)
    if not x.is_cuda:
        return _plain_finish(x, attn_out, block)
    if wants_grad(x, attn_out, *weights):
        return BlockFinishFunction.apply(x, attn_out, *weights, block)
    return _launch_finish(x, attn_out, block)


def _launch_finish(x, attn_out, block):
    """K5/K6 on the card."""
    global finish_launches
    dt = x.dtype
    if x.dim() != 3 or dt not in _kernels.DTYPE_CODES or attn_out.shape != x.shape:
        raise ValueError("fused_block_finish: expected matching (B, Tp, D) "
                         "float32/bfloat16 inputs")
    B, Tp, D = x.shape
    M = B * Tp
    p = finish_pack(block, dt)
    F = p["wf"].shape[1]
    if D % GEMM_TILE or F % GEMM_TILE:
        raise ValueError(f"fused_block_finish: the kernel takes D and the MLP width "
                         f"in multiples of {GEMM_TILE}, got D={D}, F={F}")
    attn_out = attn_out.contiguous()
    S = _slabs(dt)
    asplit = x.new_empty(S, M, D) if S == 2 else None
    r = torch.empty_like(x)
    h = x.new_empty(S, M, D)
    t = x.new_empty(S, M, F)
    out = torch.empty_like(x)
    ws = [p[k] for k in ("wo", "bo", "wf", "bf", "wp", "bp")]
    _kernels.check_cuda("fused_block_finish", x, attn_out, *ws, r, h, t, out, dtype=dt)
    _kernels.check_cuda("fused_block_finish", x, p["g"], p["b"])
    _check_aligned("fused_block_finish", x, attn_out, asplit, r, h, t, out)
    _kernels.library().call(
        "qasr_finish", x.device, _kernels.DTYPE_CODES[dt],
        x.data_ptr(), attn_out.data_ptr(), None if asplit is None else asplit.data_ptr(),
        ws[0].data_ptr(), ws[1].data_ptr(), p["g"].data_ptr(), p["b"].data_ptr(),
        ws[2].data_ptr(), ws[3].data_ptr(), ws[4].data_ptr(), ws[5].data_ptr(),
        r.data_ptr(), h.data_ptr(), t.data_ptr(), out.data_ptr(), M, D, F,
    )
    finish_launches += 1
    return out


class BlockFinishFunction(torch.autograd.Function):
    """K5/K6 with a gradient: the forward is the kernel, the backward the
    VJP of ``_plain_finish`` recomputed from the saved inputs and weights
    (the rule of the JAX package's ``_fused_bwd``, which differentiates the
    whole XLA block)."""

    @staticmethod
    def forward(ctx, x, attn_out, wo, bo, g, b, wf, bf, wp, bp, block):
        ctx.save_for_backward(x, attn_out, wo, bo, g, b, wf, bf, wp, bp)
        return _launch_finish(x, attn_out, block)

    @staticmethod
    def backward(ctx, grad):
        def plain(x, attn_out, wo, bo, g, b, wf, bf, wp, bp):
            block = _NS(attn=_NS(out=_NS(weight=wo, bias=bo)), mlp_ln=_NS(weight=g, bias=b),
                        mlp=[_NS(weight=wf, bias=bf), None, _NS(weight=wp, bias=bp)])
            return _plain_finish(x, attn_out, block)
        return (*plain_vjp(ctx, plain, grad), None)


EPILOGUES = ("qkv", "out_proj", "fc", "proj")


def block_gemm(a_op, w_op, bias, epilogue: str, res=None, scale: float = 1.0):
    """One of the block's four GEMM products alone, through the kernel (for
    its tests and its timing beside ``torch.matmul``; the block's wrappers
    launch it inside K4 and K5/K6): ``a_op`` (S, M, K) and ``w_op`` (S, N, K)
    are operands as ``gemm_operand`` makes them, ``bias`` (N,) and ``res``
    (M, N; x for ``out_proj``, r for ``proj``) in the compute dtype,
    ``scale`` the rounded dh^-0.25 of ``qkv``.  Returns (M, N), or for
    ``fc`` in float32 the hi/lo slabs (2, M, N) of t."""
    global gemm_launches
    dt = bias.dtype
    S, M, K = a_op.shape
    N = w_op.shape[1]
    if not a_op.is_cuda or epilogue not in EPILOGUES or S != _slabs(dt) or \
            w_op.shape != (S, N, K) or (res is None) != (epilogue in ("qkv", "fc")):
        raise ValueError("block_gemm: expected CUDA operands of the compute dtype's "
                         "slabs and a residual exactly for out_proj and proj")
    out = a_op.new_empty((S, M, N) if epilogue == "fc" and S == 2 else (M, N))
    _kernels.check_cuda("block_gemm", a_op, w_op, bias, out,
                        *([] if res is None else [res]), dtype=dt)
    _check_aligned("block_gemm", a_op, w_op, bias, res, out)
    _kernels.library().call(
        "qasr_block_gemm", a_op.device, _kernels.DTYPE_CODES[dt], EPILOGUES.index(epilogue),
        a_op.data_ptr(), w_op.data_ptr(), bias.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(), M, N, K, scale,
    )
    gemm_launches += 1
    return out


def block_gemm_plain(a, w, bias, epilogue: str, res=None, scale: float = 1.0):
    """Plain PyTorch version of ``block_gemm`` on a (M, K) and w (N, K) in
    the compute dtype, with the reference's rounding points: the product,
    each bias add, scale and residual rounded to the compute dtype."""
    y = a @ w.t()
    if epilogue == "qkv":
        D = y.shape[1] // 3
        q, k, v = y[:, :D], y[:, D:2 * D], y[:, 2 * D:]
        return torch.cat([(q + bias[:D]) * scale, k * scale, v + bias[2 * D:]], 1)
    if epilogue == "fc":
        return gelu(y + bias)
    return res + (y + bias)


def fused_encoder_block(x, block, n_head: int, t_real: int):
    """One whole encoder block: (B, Tp, D) -> (B, Tp, D).  ``block`` is the
    port's ResidualAttentionBlock (reference state-dict names)."""
    attn_out = fused_attention_ln(x, block.attn_ln, block.attn, n_head, t_real)
    return fused_block_finish(x, attn_out, block)
