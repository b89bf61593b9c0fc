"""Attention on packed (B, T, D) heads (K8).

Replaces ``qasr_ijcnlp_tpu/ops/flash.py`` ``_packed_kernel``: softmax(q k^T)
v per 64-wide head, read straight from the model's (B, T, D) tensors with
the heads packed along D, keys at positions >= ``t_real`` masked, q and k
pre-scaled by the caller.  The encoder's unfused trunk (large-v3, D = 1280)
runs it in every layer.

On the H100 (``csrc/flash.cu``) it is the online-softmax attention core that
K4 also uses (``csrc/attention.cuh``), launched on separate q, k and v
pointers: no transpose, no padding copy, no (Tq, Tk) logits in device
memory.  It is bound by FMA throughput on the CUDA cores (no tensor cores
yet).  Its numerics follow the TPU kernel: the softmax denominator sums the
unrounded fp32 p, and p is rounded to the compute dtype only for the PV
product.

The 4D ``flash_attention`` (K7), for head geometries that cannot be packed,
is not ported: ROADMAP.md queue 2, K7.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .encoder_block import DH

launches = 0


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
    logits = (split(q) @ split(k).transpose(-1, -2)).float()
    if t_real != k.shape[1]:
        keep = torch.arange(k.shape[1], device=k.device) < t_real
        logits = logits.masked_fill(~keep, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return (w @ split(v)).transpose(1, 2).reshape(B, Tq, D)


def flash_attention_packed(q, k, v, n_head: int, t_real: int):
    """q (B, Tq, D), k and v (B, Tk, D), pre-scaled -> (B, Tq, D) in q's
    dtype.  Keys at positions >= ``t_real`` get no weight."""
    t_real = min(t_real, k.shape[1])
    if not q.is_cuda:
        return _plain_attention_packed(q, k, v, n_head, t_real)
    global launches
    dt = q.dtype
    if q.dim() != 3 or dt not in _kernels.DTYPE_CODES:
        raise ValueError(f"flash_attention_packed: expected (B, T, D) float32/"
                         f"bfloat16 q, got {tuple(q.shape)} {dt}")
    B, Tq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D:
        raise ValueError(f"flash_attention_packed: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D != n_head * DH:
        raise ValueError(f"flash_attention_packed: the kernel needs head width "
                         f"{DH}, got D={D}, n_head={n_head}")
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
