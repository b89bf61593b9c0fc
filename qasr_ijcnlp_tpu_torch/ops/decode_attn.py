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

On the H100 (``csrc/decode_attn.cu``) the kernel is bound by the bytes of
the codes and scales: at large-v3, B = 8, one layer's step reads 30.7 MB of
codes and 1.9 MB of scales (the 1,500 real positions), 9.8 us at the HBM
rate.  The TPU kernel's grid (one (batch item, head) per step, its whole
cache in VMEM) carried over as one block per (batch item, head) gave 160
blocks on 132 SMs at large-v3, each reading its cache phase after phase,
and reached 8-15% of that rate.  So the kernel splits the audio axis: a
cluster of S blocks (``split``: 6 to 8, as many as let every cluster fit on
the card at once) serves one (batch item, head), each block a chunk of
``cs`` positions (a multiple of 16) that reaches shared memory by 1D bulk
copies: K's codes and both scales at the start, V's codes into the same
buffer once the logits are done, landing while the softmax runs.  Each
block serves all G x T_new query rows of its chunk, so every code is still
read once per call whatever the group size, and leaves a local max m, sum
l and unnormalised PV sum acc; the cluster merges them in distributed
shared memory, out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, in
the same single launch.  Like the reference's kernel it takes any head
width, up to ``MAX_HEAD_WIDTH``.  No single PyTorch call attends over int8
codes with per-position scales, so the kernel has no library twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from . import MAX_HEAD_WIDTH, round_up

LANE = 128  # audio positions are padded to a multiple of this
MAX_SPLIT = 8  # blocks per (batch item, head): the portable cluster size

launches = 0


def chunk(t_real: int, S: int) -> int:
    """cs, the positions of each of S chunks of [0, t_real): block s takes
    [s cs, min(t_real, (s + 1) cs)).  A multiple of 16, so every chunk's
    bytes start 16-byte aligned at any head width.  A chunk may hold no
    real position (t_real = 200, S = 8: cs = 32, the 8th starts at 224)."""
    return round_up(-(-t_real // S), 16)


def split(t_real: int, fits=lambda S, cs: True):
    """(S, cs): the kernel's split of the audio axis.  S is the largest of
    8, 7 and 6 (at most the chunks of 16 positions t_real holds) whose
    clusters all fit on the card at once (``fits(S, cs)``), so that every
    block's copies are in flight together in one round: a second round
    waits for the first to finish, its copies overlapping no compute.
    Where none fits, the most t_real allows (8 from 113 positions up)."""
    top = min(MAX_SPLIT, -(-t_real // 16))
    for S in (8, 7, 6):
        if S <= top and fits(S, chunk(t_real, S)):
            return S, chunk(t_real, S)
    return top, chunk(t_real, top)


@functools.lru_cache(maxsize=None)
def _card_split(device: torch.device, dtype_code: int, G: int, T_new: int, Dh: int,
                t_real: int, n_bh: int):
    """``split`` with ``fits`` asking the card how many clusters of each
    candidate it holds at once (cudaOccupancyMaxActiveClusters), once per
    shape."""
    def fits(S, cs):
        n = ctypes.c_int(0)
        _kernels.library().call("qasr_int8_cross_attention_clusters", device, dtype_code, G,
                                T_new, Dh, t_real, S, cs, ctypes.addressof(n))
        return n.value >= n_bh

    return split(t_real, fits)


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
    if Tp % 16:
        raise ValueError(f"int8_cross_attention: Tp={Tp} is not a multiple of 16")
    q = q.contiguous()
    out = torch.empty(BG, T_new, D, dtype=torch.float32, device=q.device)
    _kernels.check_cuda("int8_cross_attention", q, k8, v8, out)
    _kernels.check_cuda("int8_cross_attention", k8, v8, dtype=torch.int8)
    _kernels.check_cuda("int8_cross_attention", sk, sv, dtype=torch.float32)
    if sk.device != q.device:
        raise ValueError("int8_cross_attention: scales are not on q's device")
    if any(t.data_ptr() % 16 for t in (k8, v8, sk, sv)):
        raise ValueError("int8_cross_attention: codes and scales must be 16-byte aligned")
    _kernels.library().call(
        "qasr_int8_cross_attention", q.device, _kernels.DTYPE_CODES[q.dtype],
        q.data_ptr(), k8.data_ptr(), sk.data_ptr(), v8.data_ptr(), sv.data_ptr(),
        out.data_ptr(), B, BG // B, T_new, H, Tp, Dh, t_real,
        *_card_split(q.device, _kernels.DTYPE_CODES[q.dtype], BG // B, T_new, Dh, t_real, B * H),
        float(Dh) ** -0.5,
    )
    launches += 1
    return out
