"""int8 cross-attention of the decode loop (K9).

Replaces ``qasr_ijcnlp_tpu/ops/decode_attn.py`` ``_kernel``: with
``DecodingOptions(kv_int8=True)`` every decoder layer's cross K/V is stored
once per audio as int8 codes with one fp32 scale per (batch item, head,
audio position), and each decode step attends over them:

    logits = (q Dh^-0.5) . code_k * scale_k   (keys >= t_real masked)
    w = softmax(logits) in fp32;  out = (w * scale_v) . code_v

so only int8 bytes of the cache stream through the step.  The output is
fp32 whatever the compute dtype; the caller casts it to the activation
dtype, as the reference does.

Layout on the card: codes (B, H, Tp, Dh) int8, one audio position's Dh
codes in one Dh-byte row, and scales (B, H, Tp) fp32, with Tp =
round_up(Ta, 128) and the padding positions' codes and scales 0.  (The
TPU's (B, H, Dh, Tp) "T-on-lanes" layout existed for its int8 (32, 128)
tile; the tests compare codes and scales after a transpose.)

On the H100 (``csrc/decode_attn.cu``) one block serves one (batch item,
head) and all of its G x T_new query rows, so each code is read from
device memory once per step whatever the group size.  Like the reference's
kernel it takes any head width, up to ``MAX_HEAD_WIDTH``: 16-byte loads
where Dh is a multiple of 16, single bytes otherwise.  The kernel is bound
by those bytes: at large-v3, B = 8, one layer's step reads 31.5 MB of codes
and 2.0 MB of scales.  No single PyTorch call attends over int8 codes with
per-position scales, so the kernel has no library twin.
"""

from __future__ import annotations

import torch

from .. import _kernels
from . import MAX_HEAD_WIDTH, round_up

LANE = 128  # audio positions are padded to a multiple of this

launches = 0


def quantize_kv(x: torch.Tensor, heads: int):
    """(B, Ta, D) float -> ((B, H, Tp, Dh) int8 codes, (B, H, Tp) fp32 scales).

    Symmetric per (b, h, t): scale = max |x| over Dh / 127, codes =
    clip(round(x / scale)) with round half to even.  The operations and
    their order are the reference's as XLA compiles them (the division by
    127 becomes a product with the fp32 reciprocal), so codes and scales
    equal its bit for bit.  Padding positions get codes and scale 0."""
    B, Ta, D = x.shape
    Dh = D // heads
    Tp = round_up(Ta, LANE)
    xh = x.float().reshape(B, Ta, heads, Dh)
    amax = xh.abs().amax(dim=-1)  # (B, Ta, H)
    scale = amax * (1.0 / 127.0)
    inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, 1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xh * inv[..., None]), -127, 127).to(torch.int8)
    q = q.permute(0, 2, 1, 3)  # (B, H, Ta, Dh)
    scale = scale.permute(0, 2, 1)  # (B, H, Ta)
    if Tp != Ta:
        q = torch.nn.functional.pad(q, (0, 0, 0, Tp - Ta))
        scale = torch.nn.functional.pad(scale, (0, Tp - Ta))
    return q.contiguous(), scale.contiguous()


def int8_cross_attention_plain(q, k8, sk, v8, sv, n_head: int, t_real: int):
    """Plain PyTorch version of the kernel, the reference's numerics: q in
    fp32 times Dh^-0.5, logits times the K scale after the product, keys >=
    ``t_real`` at -inf, fp32 softmax, V's scale folded into the weights.
    q (B G, T_new, D) rows group-major -> fp32 (B G, T_new, D)."""
    BG, T_new, D = q.shape
    B, H, Tp, Dh = k8.shape
    G = BG // B
    qh = (q.float() * float(Dh) ** -0.5).reshape(B, G, T_new, H, Dh)
    qh = qh.permute(0, 3, 1, 2, 4).reshape(B, H, G * T_new, Dh)
    logits = (qh @ k8.float().transpose(-1, -2)) * sk[:, :, None, :]
    keep = torch.arange(Tp, device=q.device) < t_real
    logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    w = p / p.sum(dim=-1, keepdim=True)
    out = (w * sv[:, :, None, :]) @ v8.float()  # (B, H, G T_new, Dh)
    out = out.reshape(B, H, G, T_new, Dh).permute(0, 2, 3, 1, 4)
    return out.reshape(BG, T_new, D)


def int8_cross_attention(q, k8, sk, v8, sv, n_head: int, t_real: int):
    """Cross-attention of ``q`` (B G, T_new, D) over the int8 cache
    (codes (B, H, Tp, Dh), scales (B, H, Tp)) -> fp32 (B G, T_new, D).

    The ``B G`` query rows share each of the B cached segments (G is a
    beam or best-of group), group-major as in the reference."""
    if not q.is_cuda:
        return int8_cross_attention_plain(q, k8, sk, v8, sv, n_head, t_real)
    global launches
    if q.dim() != 3 or q.dtype not in _kernels.DTYPE_CODES:
        raise ValueError(f"int8_cross_attention: expected (BG, T_new, D) float32/"
                         f"bfloat16 q, got {tuple(q.shape)} {q.dtype}")
    BG, T_new, D = q.shape
    if k8.dim() != 4:
        raise ValueError(f"int8_cross_attention: expected (B, H, Tp, Dh) codes, "
                         f"got {tuple(k8.shape)}")
    B, H, Tp, Dh = k8.shape
    if (H != n_head or D != H * Dh or BG % B or v8.shape != k8.shape
            or sk.shape != (B, H, Tp) or sv.shape != sk.shape):
        raise ValueError(
            f"int8_cross_attention: q {tuple(q.shape)}, codes {tuple(k8.shape)} / "
            f"{tuple(v8.shape)}, scales {tuple(sk.shape)} / {tuple(sv.shape)} do "
            f"not fit {n_head} heads")
    if Dh > MAX_HEAD_WIDTH:
        raise ValueError(f"int8_cross_attention: head width {Dh} > {MAX_HEAD_WIDTH}")
    if not 1 <= t_real <= Tp:
        raise ValueError(f"int8_cross_attention: t_real={t_real} outside [1, {Tp}]")
    q = q.contiguous()
    out = torch.empty(BG, T_new, D, dtype=torch.float32, device=q.device)
    _kernels.check_cuda("int8_cross_attention", q, k8, v8, out)
    _kernels.check_cuda("int8_cross_attention", k8, v8, dtype=torch.int8)
    _kernels.check_cuda("int8_cross_attention", sk, sv, dtype=torch.float32)
    if sk.device != q.device:
        raise ValueError("int8_cross_attention: scales are not on q's device")
    if k8.data_ptr() % 16 or v8.data_ptr() % 16:
        raise ValueError("int8_cross_attention: codes must be 16-byte aligned")
    _kernels.library().call(
        "qasr_int8_cross_attention", q.device, _kernels.DTYPE_CODES[q.dtype],
        q.data_ptr(), k8.data_ptr(), sk.data_ptr(), v8.data_ptr(), sv.data_ptr(),
        out.data_ptr(), B, BG // B, T_new, H, Tp, Dh, t_real, float(Dh) ** -0.5,
    )
    launches += 1
    return out
