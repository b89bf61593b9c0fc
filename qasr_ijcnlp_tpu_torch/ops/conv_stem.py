"""Encoder conv stem (K2, K3): mel -> conv1 -> GELU -> conv2(s2) -> GELU -> +pos.

Replaces ``qasr_ijcnlp_tpu/ops/conv_stem.py`` ``_stem_kernel`` (K2, D <= 512)
and ``_stem_kernel_chunked`` (K3, 512 < D <= 1024), which emit the
transformer trunk's input directly: row-major (B, t_pad, D), position
embeddings added, padding rows zeroed.  The TPU cut time into 256-row chunks
above D = 512 only because the whole-axis activations passed 16 MB of VMEM;
the port's implicit-GEMM tile does not depend on D, so one kernel serves
both ranges, and also D = 1280 (large-v3), whose stem the reference leaves
to XLA.

On the H100 (``csrc/conv_stem.cu``) each convolution is one implicit GEMM
whose tile loads read mel (or y1) at the tap offsets; the TPU kernel's
even/odd phase split was a layout trick for whole-array shifts and has no
counterpart.  y1 goes through device memory between the two launches.  The
stem is bound by conv2's FMAs on the CUDA cores (no tensor cores yet).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels
from . import gelu

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


def fused_conv_stem(encoder, mel, t_pad: int, compute_dtype=torch.float32):
    """(B, n_mels, T_mel) mel -> (B, t_pad, D) trunk input (GELU'd conv stack
    plus position embeddings, rows >= T_mel // 2 zeroed).

    ``encoder`` holds ``conv1``/``conv2`` (nn.Conv1d, k=3) and
    ``positional_embedding`` (the port's AudioEncoder)."""
    dt = compute_dtype
    if not mel.is_cuda:
        return _plain_stem(encoder, mel, t_pad, dt)
    global launches
    if mel.dim() != 3 or mel.shape[-1] % 2 or dt not in _kernels.DTYPE_CODES:
        raise ValueError(f"fused_conv_stem: expected (B, C, even T) mel and a "
                         f"float32/bfloat16 dtype, got {tuple(mel.shape)}, {dt}")
    B, C0, Tm = mel.shape
    t_out = Tm // 2
    D = encoder.conv1.weight.shape[0]
    if t_pad < t_out or encoder.conv1.weight.shape[1:] != (C0, 3):
        raise ValueError("fused_conv_stem: t_pad or conv1 shape mismatch")
    mel = mel.float().contiguous()
    w = lambda p: p.to(dt).contiguous()
    ws = [w(encoder.conv1.weight), w(encoder.conv1.bias), w(encoder.conv2.weight),
          w(encoder.conv2.bias), w(encoder.positional_embedding[:t_out])]
    if ws[4].shape != (t_out, D):
        raise ValueError("fused_conv_stem: positional embedding too short")
    y1 = mel.new_empty(B, Tm, D, dtype=dt)
    out = mel.new_empty(B, t_pad, D, dtype=dt)
    _kernels.check_cuda("fused_conv_stem", mel, *ws, y1, out)
    _kernels.check_cuda("fused_conv_stem", *ws, y1, out, dtype=dt)
    _kernels.library().call(
        "qasr_conv_stem", mel.device, _kernels.DTYPE_CODES[dt],
        mel.data_ptr(), *(p.data_ptr() for p in ws), y1.data_ptr(),
        out.data_ptr(), B, C0, Tm, D, t_out, t_pad,
    )
    launches += 1
    return out
