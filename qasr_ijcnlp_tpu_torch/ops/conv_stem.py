"""Encoder conv stem (K2, K3): mel -> conv1 -> GELU -> conv2(s2) -> GELU -> +pos.

Replaces ``qasr_ijcnlp_tpu/ops/conv_stem.py`` ``_stem_kernel`` (K2, D <= 512)
and ``_stem_kernel_chunked`` (K3, 512 < D <= 1024), which emit the
transformer trunk's input directly: row-major (B, t_pad, D), position
embeddings added, padding rows zeroed.  The TPU cut time into 256-row chunks
above D = 512 only because the whole-axis activations passed 16 MB of VMEM;
the port's GEMM tile does not depend on D, so one kernel serves both ranges,
and also D = 1280 (large-v3), whose stem the reference leaves to XLA.

On the H100 (``csrc/conv_stem.cu``) each convolution is one tensor-core
GEMM (``csrc/gemm_tc.cuh``, wgmma + TMA) whose A operand is three row views
of one channels-last buffer: conv1 reads the mel rows at row offsets 0, 1,
2, conv2 reads y1 at rows 2m, 2m + 1, 2m + 2, with no im2col copy.  A pass
turns the mel into those rows first; conv1's epilogue writes y1 straight
into conv2's input buffer.  The row layout is ``stem_pitch``'s; the weights
are packed once per module and dtype (``stem_pack``).  f32 runs as 3xTF32.
The kernel takes D a multiple of 128 (every Whisper width) and 80 or 128
mel bins; anything else raises.  The TPU kernel's even/odd phase split
was a layout trick for whole-array shifts and has no counterpart.
"""

from __future__ import annotations

from types import SimpleNamespace as _NS

import torch
import torch.nn.functional as F

from .. import _kernels
from . import gelu, plain_vjp, recording_ops, round_up, wants_grad
from .encoder_block import GEMM_TILE, _check_aligned, _kept, _slabs, gemm_operand
from .melfront import N_MELS

launches = 0


def _plain_stem(encoder, mel, t_pad: int, dtype):
    """Plain PyTorch version (conv + GELU + conv + GELU + pos + pad).  The
    convolutions run with cuDNN's TF32 off (it is on by default), so the f32
    version stays true fp32 on the card."""
    x = mel.to(dtype)

    def conv(x, c, stride):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(x, c.weight.to(dtype), c.bias.to(dtype), stride=stride,
                            padding=1)

    x = gelu(conv(x, encoder.conv1, 1))
    x = gelu(conv(x, encoder.conv2, 2))
    x = x.transpose(1, 2)
    x = x + encoder.positional_embedding[: x.shape[1]].to(dtype)
    if t_pad != x.shape[1]:
        x = F.pad(x, (0, 0, 0, t_pad - x.shape[1]))
    return x.contiguous()


def stem_pitch(t_mel: int, t_pad: int) -> int:
    """P, conv2's row pitch per item: output row b P + t is item b's frame t.
    conv1's rows and y1's have a pitch of 2P, so that conv2's output row m
    reads y1 rows 2m + j with no offset per item.  An item holds y1's zero
    row and its t_mel frames (t_mel + 1 <= 2P) and, in conv1's input, two
    leading zero rows (t_mel + 2 <= 2P): P = max(t_pad, t_mel / 2 + 1)."""
    return max(t_pad, t_mel // 2 + 1)


def _tap_major(w, c_pad: int):
    """(D, C, 3) conv weight -> (D, 3 c_pad) with column j c_pad + c holding
    w[:, c, j] (channels zero-padded to c_pad): the GEMM's tap-major W."""
    w = F.pad(w, (0, 0, 0, c_pad - w.shape[1]))
    return w.permute(0, 2, 1).reshape(w.shape[0], -1)


def _stem_weights(encoder):
    """The stem's weights in the order its Function takes them."""
    c1, c2 = encoder.conv1, encoder.conv2
    return (c1.weight, c1.bias, c2.weight, c2.bias, encoder.positional_embedding)


def stem_pack(encoder, dtype):
    """The stem's weights in ``dtype``, packed once per module and dtype:
    conv1 and conv2 as tap-major GEMM operands (``gemm_operand``: f32 as
    TF32 hi/lo slabs), conv1's channels padded to the k-slice (``c_pad``),
    the biases and the positional embedding cast to ``dtype``.  Kept on
    ``encoder``."""
    def build():
        c1, c2 = encoder.conv1, encoder.conv2
        c_pad = round_up(c1.weight.shape[1], 128 // dtype.itemsize)  # a GEMM k-slice
        return {
            "w1": gemm_operand(_tap_major(c1.weight, c_pad), dtype),
            "b1": c1.bias.to(dtype).contiguous(),
            "w2": gemm_operand(_tap_major(c2.weight, c2.weight.shape[1]), dtype),
            "b2": c2.bias.to(dtype).contiguous(),
            "pos": encoder.positional_embedding.to(dtype).contiguous(),
            "c_pad": c_pad,
        }
    return _kept(encoder, _stem_weights(encoder), dtype, build)


def fused_conv_stem(encoder, mel, t_pad: int, compute_dtype=torch.float32):
    """(B, n_mels, T_mel) mel -> (B, t_pad, D) trunk input (GELU'd conv stack
    plus position embeddings, rows >= T_mel // 2 zeroed).

    ``encoder`` holds ``conv1``/``conv2`` (nn.Conv1d, k=3) and
    ``positional_embedding`` (the port's AudioEncoder).  Where autograd
    must record the call, it goes through :class:`ConvStemFunction`."""
    dt = compute_dtype
    weights = _stem_weights(encoder)
    if recording_ops():
        return torch.ops.qasr.conv_stem(mel, *weights, t_pad, dt)
    if not mel.is_cuda:
        return _plain_stem(encoder, mel, t_pad, dt)
    if wants_grad(mel, *weights):
        return ConvStemFunction.apply(mel, *weights, encoder, t_pad, dt)
    return _launch_stem(encoder, mel, t_pad, dt)


def _launch_stem(encoder, mel, t_pad: int, dt):
    """K2/K3 on the card."""
    global launches
    if mel.dim() != 3 or mel.shape[-1] % 2 or dt not in _kernels.DTYPE_CODES:
        raise ValueError(f"fused_conv_stem: expected (B, C, even T) mel and a "
                         f"float32/bfloat16 dtype, got {tuple(mel.shape)}, {dt}")
    B, C0, Tm = mel.shape
    t_out = Tm // 2
    D = encoder.conv1.weight.shape[0]
    if D % GEMM_TILE or C0 not in N_MELS:
        raise ValueError(f"fused_conv_stem: the kernel takes D a multiple of {GEMM_TILE} "
                         f"and {N_MELS} mel bins, got D={D}, {C0} bins")
    if t_pad < t_out or encoder.conv1.weight.shape[1:] != (C0, 3):
        raise ValueError("fused_conv_stem: t_pad or conv1 shape mismatch")
    if encoder.positional_embedding.shape[0] < t_out:
        raise ValueError("fused_conv_stem: positional embedding too short")
    p = stem_pack(encoder, dt)
    P, S, c_pad = stem_pitch(Tm, t_pad), _slabs(dt), p["c_pad"]
    mel = mel.float().contiguous()
    ws = [p[k] for k in ("w1", "b1", "w2", "b2", "pos")]
    xb = mel.new_empty(S, 2 * B * P, c_pad, dtype=dt)
    y1 = mel.new_empty(S, 2 * B * P, D, dtype=dt)
    out = mel.new_empty(B, t_pad, D, dtype=dt)
    _kernels.check_cuda("fused_conv_stem", mel, *ws, xb, y1, out)
    _kernels.check_cuda("fused_conv_stem", *ws, xb, y1, out, dtype=dt)
    _check_aligned("fused_conv_stem", *ws, xb, y1, out)
    _kernels.library().call(
        "qasr_conv_stem", mel.device, _kernels.DTYPE_CODES[dt],
        mel.data_ptr(), *(w.data_ptr() for w in ws), xb.data_ptr(), y1.data_ptr(),
        out.data_ptr(), B, C0, c_pad, Tm, D, t_out, t_pad, P,
    )
    launches += 1
    return out


class ConvStemFunction(torch.autograd.Function):
    """K2/K3 with a gradient: the forward is the kernel, the backward the
    VJP of ``_plain_stem`` recomputed from the saved mel and weights (the
    JAX package's ``qasr_ijcnlp_tpu/ops/conv_stem.py`` ``_stem_bwd``
    differentiates its XLA convolutions the same way)."""

    @staticmethod
    def forward(ctx, mel, w1, b1, w2, b2, pos, encoder, t_pad, dtype):
        ctx.save_for_backward(mel, w1, b1, w2, b2, pos)
        ctx.t_pad, ctx.dtype = t_pad, dtype
        return _launch_stem(encoder, mel, t_pad, dtype)

    @staticmethod
    def backward(ctx, grad):
        def plain(mel, w1, b1, w2, b2, pos):
            enc = _NS(conv1=_NS(weight=w1, bias=b1), conv2=_NS(weight=w2, bias=b2),
                      positional_embedding=pos)
            return _plain_stem(enc, mel, ctx.t_pad, ctx.dtype)
        return (*plain_vjp(ctx, plain, grad), None, None, None)
