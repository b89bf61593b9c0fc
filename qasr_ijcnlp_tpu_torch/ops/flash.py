"""Encoder attention outside the fused block: packed (B, T, D) heads (K8)
and (B, H, T, dh) heads (K7).

Replaces, in ``qasr_ijcnlp_tpu/ops/flash.py``, ``_packed_kernel``
(softmax(q k^T) v per head, read straight from the model's (B, T, D)
tensors with the heads packed along D; the encoder's unfused trunk runs it
in every layer where the heads pack, as at large-v3) and ``_attn_kernel``
behind ``flash_attention`` (the same on (B, H, T, dh) heads; the trunk runs
it in every layer whose heads do not pack into the TPU's 128-lane groups,
``packed_applicable`` false: an odd count of 64-wide heads, or a width that
does not divide 128).  In both, keys at positions >= ``t_real`` are masked
and q and k arrive pre-scaled by the caller.

On the H100 (``csrc/flash.cu``) both run the tensor-core attention core of
``csrc/attention_tc.cuh`` at any head width up to ``MAX_HEAD_WIDTH``: one
block per 64 or 128 query rows of one head, key tiles brought into shared
memory by TMA through a ring of mbarrier stages, both products on ``wgmma``
(bf16 operands, or in f32 three TF32 products per product, hi.lo' + lo.hi'
+ hi.hi', which keeps the f32 error under 1e-5 at the encoder's shapes
where one TF32 product would pass 1e-4), the online softmax in fp32
registers.  No transpose, no
padding copy and no (Tq, Tk) logits in device memory: TMA's bounds give
zeros for keys >= ``t_real`` and for the padded head columns.  On Hopper
"packed" or "head-major" is only a choice of strides, so K7 takes its (B,
H, T, dh) operands as they come, including the strided head views of (B,
T, D) projections that ``models.whisper.attention`` hands it (views whose
strides TMA cannot address are read with plain loads by the same kernel),
and writes its output where merging the heads again is a free reshape.
Both are bound by tensor-core operations.  Their numerics follow the TPU
kernels: the softmax denominator sums the unrounded fp32 p, and p is
rounded to the compute dtype only for the PV product.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _kernels
from . import MAX_HEAD_WIDTH, kernel_head_width, plain_vjp, recording_ops, wants_grad

launches = 0      # K8
launches_4d = 0   # K7


def packed_applicable(n_head: int, d_model: int) -> bool:
    """The reference's gate: heads tile into 128-lane groups."""
    dh = d_model // n_head
    if dh > 128 or 128 % dh:
        return False
    return n_head % max(1, 128 // dh) == 0


def _plain_attention_packed(q, k, v, n_head: int, t_real: int):
    """Plain PyTorch version (the reference's ``_xla_attention_packed``):
    fp32 logits and softmax, weights rounded to the input dtype before PV."""
    B, Tq, D = q.shape
    dh = D // n_head
    split = lambda x: x.reshape(B, x.shape[1], n_head, dh).transpose(1, 2)
    return _plain_attention(split(q), split(k), split(v), t_real).transpose(1, 2).reshape(
        B, Tq, D)


def flash_attention_packed(q, k, v, n_head: int, t_real: int):
    """q (B, Tq, D), k and v (B, Tk, D), pre-scaled -> (B, Tq, D) in q's
    dtype.  Keys at positions >= ``t_real`` get no weight.  Where autograd
    must record the call, it goes through :class:`PackedAttentionFunction`."""
    t_real = min(t_real, k.shape[1])
    if recording_ops():
        return torch.ops.qasr.flash_attention_packed(q, k, v, n_head, t_real)
    if not q.is_cuda:
        return _plain_attention_packed(q, k, v, n_head, t_real)
    if wants_grad(q, k, v):
        return PackedAttentionFunction.apply(q, k, v, n_head, t_real)
    return _launch_packed(q, k, v, n_head, t_real)


def _launch_packed(q, k, v, n_head: int, t_real: int):
    """K8 on the card."""
    global launches
    dt = q.dtype
    if q.dim() != 3 or dt not in _kernels.DTYPE_CODES:
        raise ValueError(f"flash_attention_packed: expected (B, T, D) float32/"
                         f"bfloat16 q, got {tuple(q.shape)} {dt}")
    B, Tq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D:
        raise ValueError(f"flash_attention_packed: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    kernel_head_width("flash_attention_packed", D, n_head)
    if t_real < 1:
        raise ValueError(f"flash_attention_packed: t_real={t_real} < 1")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _kernels.check_cuda("flash_attention_packed", q, k, v, out, dtype=dt)
    _kernels.library().call(
        "qasr_packed_attention", q.device, _kernels.DTYPE_CODES[dt],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Tq, k.shape[1], D, n_head, t_real,
    )
    launches += 1
    return out


def _plain_attention(q, k, v, t_real: int):
    """Plain PyTorch version of K7 (the reference's ``_xla_attention`` with
    the kernel body's key mask): (B, H, Tq, dh) -> (B, H, Tq, dh); fp32
    logits and softmax, weights rounded to the input dtype before PV."""
    logits = (q @ k.transpose(-1, -2)).float()
    if t_real != k.shape[2]:
        keep = torch.arange(k.shape[2], device=k.device) < t_real
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.softmax(logits, dim=-1).to(q.dtype) @ v


def flash_attention(q, k, v, t_real: Optional[int] = None):
    """q (B, H, Tq, dh), k and v (B, H, Tk, dh), pre-scaled -> (B, H, Tq, dh)
    in q's dtype.  Keys at positions >= ``t_real`` (default Tk) get no
    weight.  On the card the operands may be any strided views with unit
    column stride; the output is a (B, H, Tq, dh) view of a (B, Tq, H, dh)
    tensor, so ``_merge_heads`` of it copies nothing.  Where autograd must
    record the call, it goes through :class:`FlashAttentionFunction`."""
    t_real = k.shape[2] if t_real is None else min(t_real, k.shape[2])
    if recording_ops():
        return torch.ops.qasr.flash_attention(q, k, v, t_real)
    if not q.is_cuda:
        return _plain_attention(q, k, v, t_real)
    if wants_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, t_real)
    return _launch_4d(q, k, v, t_real)


def _launch_4d(q, k, v, t_real: int):
    """K7 on the card."""
    global launches_4d
    dt = q.dtype
    if q.dim() != 4 or dt not in _kernels.DTYPE_CODES:
        raise ValueError(f"flash_attention: expected (B, H, T, dh) float32/bfloat16 "
                         f"q, got {tuple(q.shape)} {dt}")
    B, H, Tq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if dh > MAX_HEAD_WIDTH:
        raise ValueError(f"flash_attention: head width {dh} > {MAX_HEAD_WIDTH}")
    if t_real < 1:
        raise ValueError(f"flash_attention: t_real={t_real} < 1")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = q.new_empty(B, Tq, H, dh).transpose(1, 2)
    _kernels.check_cuda("flash_attention", q, k, v, out, dtype=dt, contiguous=False)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    _kernels.library().call(
        "qasr_flash_attention", q.device, _kernels.DTYPE_CODES[dt],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Tq, k.shape[2], dh, t_real, strides,
    )
    launches_4d += 1
    return out


class PackedAttentionFunction(torch.autograd.Function):
    """K8 with a gradient: the forward is the kernel, the backward the VJP
    of ``_plain_attention_packed`` recomputed from the saved q, k and v
    (the JAX package's ``qasr_ijcnlp_tpu/ops/flash.py`` ``_flash_packed_bwd``
    differentiates its XLA form the same way)."""

    @staticmethod
    def forward(ctx, q, k, v, n_head, t_real):
        ctx.save_for_backward(q, k, v)
        ctx.n_head, ctx.t_real = n_head, t_real
        return _launch_packed(q, k, v, n_head, t_real)

    @staticmethod
    def backward(ctx, grad):
        plain = lambda q, k, v: _plain_attention_packed(q, k, v, ctx.n_head, ctx.t_real)
        return (*plain_vjp(ctx, plain, grad), None, None)


class FlashAttentionFunction(torch.autograd.Function):
    """K7 with a gradient: the forward is the kernel, the backward the VJP
    of ``_plain_attention`` recomputed from the saved q, k and v (the JAX
    package's ``_flash_bwd`` rule)."""

    @staticmethod
    def forward(ctx, q, k, v, t_real):
        ctx.save_for_backward(q, k, v)
        ctx.t_real = t_real
        return _launch_4d(q, k, v, t_real)

    @staticmethod
    def backward(ctx, grad):
        plain = lambda q, k, v: _plain_attention(q, k, v, ctx.t_real)
        return (*plain_vjp(ctx, plain, grad), None)
