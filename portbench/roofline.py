"""Peaks of one H100 and the operations and bytes of the port's work.

Everything here is arithmetic on shapes, so the yardstick stays the same
whatever a later change does to the program.  The kernel functions
(``mel_work`` ... ``step_work``) are copied from the port's ``chip_smoke.py``
(its ``mel_work`` to ``step_work``); the model functions count the
multiply-adds of the published Whisper architecture (two operations each)
for the encoder, the decoder's prompt pass and token steps, and a training
step.

A kernel's roofline share is the least time the card could take for the
work of its calls, the larger of operations over the peak rate of their type
and bytes over the HBM rate, divided by the device time of those calls.
Each input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, fp32 on the
# CUDA cores, and "tf32x3", an fp32 product done as three TF32 products on
# the tensor cores (the port's K1-K8 in f32).
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
MODEL_PEAK = PEAK_FLOPS["bf16"]


def bound_s(flops: float, nbytes: float, peak: str) -> float:
    """Least seconds the card could take for ``flops`` at ``peak``'s rate
    and ``nbytes`` at the HBM rate."""
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)


# -- kernels (copied from chip_smoke.py) ----------------------------------------

def mel_work(B, L, frames, n_mels):
    """K1: the DFT of every frame and the mel projection; the padded PCM
    in, the log-mel out (fp32)."""
    return (2 * B * frames * 400 * 402 + 2 * B * frames * 201 * n_mels,
            4 * (B * L + B * n_mels * frames))


def stem_work(B, C0, Tm, D, t_out, Tp, s):
    """K2/K3: both convolutions; the mel in (fp32), weights, positions and
    the padded trunk input out in the compute dtype (``s`` bytes)."""
    flops = 2 * B * Tm * D * 3 * C0 + 2 * B * t_out * D * 3 * D
    weights = D * C0 * 3 + D * D * 3 + 2 * D + t_out * D
    return flops, 4 * B * C0 * Tm + s * (weights + B * Tp * D)


def attn_work(B, Tp, D, H, t_real, s):
    """K4: LN, the Q/K/V projections of every row, attention among the
    t_real real rows."""
    flops = 2 * B * Tp * D * 3 * D + 4 * B * H * t_real * t_real * (D // H)
    return flops, s * (2 * B * Tp * D + 3 * D * D + 3 * D) + 8 * D


def finish_work(B, Tp, D, s):
    """K5/K6: the out projection, LN and the MLP with both residuals."""
    return 18 * B * Tp * D * D, s * (3 * B * Tp * D + 9 * D * D + 6 * D) + 8 * D


def packed_work(B, Tq, Tk, D, H, t_real, s):
    """K7/K8: attention of the real query rows over the t_real real keys
    (query rows past t_real are padding, which the caller drops)."""
    flops = 4 * B * H * min(Tq, t_real) * t_real * (D // H)
    return flops, s * (2 * B * Tq * D + 2 * B * Tk * D)


def int8_work(B, H, R, t_real, dh=64):
    """K9: int8 cross attention of R query rows."""
    flops = 4 * B * H * R * t_real * dh
    return flops, 2 * B * H * t_real * (dh + 4) + 8 * B * R * H * dh


def step_work(B, D, t_self, Ta, s):
    """K10: one decoder layer's single-token step."""
    flops = 2 * B * 14 * D * D + 4 * B * D * (t_self + Ta)
    return flops, s * (14 * D * D + 11 * D) + 24 * D + s * B * D * (2 * t_self + 2 + 2 * Ta)


# -- the whole model (published architecture) -------------------------------------

def _pad128(t: int) -> int:
    return (t + 127) // 128 * 128


def encoder_flops(dims) -> float:
    """One clip through the stem and the encoder blocks (real rows)."""
    D, T, C0 = dims["n_audio_state"], dims["n_audio_ctx"], dims["n_mels"]
    stem = 2 * (2 * T) * D * 3 * C0 + 2 * T * D * 3 * D
    block = 2 * T * 12 * D * D + 4 * T * T * D
    return stem + dims["n_audio_layer"] * block


def cross_kv_flops(dims) -> float:
    """The decoder's cross K/V projections of one clip, every layer."""
    D, T = dims["n_text_state"], dims["n_audio_ctx"]
    return dims["n_text_layer"] * 2 * T * 2 * D * D


def decoder_token_flops(dims, position: int) -> float:
    """One decoder position with ``position`` earlier keys in its self
    cache: every layer (self and cross attention, MLP) and the logits."""
    D, Ta, V = dims["n_text_state"], dims["n_audio_ctx"], dims["n_vocab"]
    layer = 2 * 4 * D * D + 2 * 2 * D * D + 2 * 8 * D * D + 4 * (position + 1) * D + 4 * Ta * D
    return dims["n_text_layer"] * layer + 2 * D * V


def decode_flops(dims, prompt: int, sampled: int) -> float:
    """One clip decoded greedily: encoder, cross K/V, the prompt pass over
    ``prompt`` positions and ``sampled - 1`` single-token steps (the last
    sampled token is never fed back)."""
    positions = list(range(prompt)) + list(range(prompt, prompt + sampled - 1))
    return (encoder_flops(dims) + cross_kv_flops(dims)
            + sum(decoder_token_flops(dims, p) for p in positions))


def train_flops(dims, tokens: int) -> float:
    """One training row: three times the forward (the backward counted as
    twice the forward; remat's recompute not counted) of the encoder and
    the teacher-forced decoder over ``tokens`` positions."""
    fwd = encoder_flops(dims) + cross_kv_flops(dims) + sum(
        decoder_token_flops(dims, p) for p in range(tokens))
    return 3 * fwd


# -- the hand kernels in a device trace -------------------------------------------

# Kernel entries of the port's library (qasr_ijcnlp_tpu_torch/csrc), by the
# substrings that name their device kernels in a profiler trace.  ``anchor``
# occurs once a call; ``parts`` are every kernel the entry launches (a
# substring may lie inside another: "ProjEp" inside "OutProjEp").  The
# templated GEMM and attention kernels are told apart by their epilogue or
# instantiation.
KERNELS: Dict[str, Dict] = {
    "K1": {"entry": "qasr_log_mel", "file": "melfront.cu",
           "anchor": ("audio_rows_kernel",),
           "parts": ("audio_rows_kernel", "PowerEp", "LogMelEp")},
    "K3": {"entry": "qasr_conv_stem", "file": "conv_stem.cu",
           "anchor": ("mel_rows_kernel",),
           "parts": ("mel_rows_kernel", "Conv1Ep", "Conv2Ep")},
    # K4 (qasr_attention) and K6 (qasr_finish) both run layer_norm_kernel,
    # so the fused block is counted as one entry: a call is one of each.
    "K4+K6": {"entry": "qasr_attention + qasr_finish", "file": "encoder_block.cu",
              "anchor": ("FcEp",),
              "parts": ("layer_norm_kernel", "QkvEp", "attn_tc_kernel", "split_kernel",
                        "OutProjEp", "FcEp", "ProjEp")},
    "K8": {"entry": "qasr_packed_attention", "file": "flash.cu",
           "anchor": ("attn_tc_kernel",), "parts": ("attn_tc_kernel",)},
    "K9": {"entry": "qasr_int8_cross_attention", "file": "decode_attn.cu",
           "anchor": ("int8_xattn_kernel",), "parts": ("int8_xattn_kernel",)},
    "K10": {"entry": "qasr_decoder_layer_step", "file": "decoder_step.cu",
            "anchor": ("decoder_layer_kernel",), "parts": ("decoder_layer_kernel",)},
}


def _has(name: str, word: str) -> bool:
    """``word`` in ``name`` as a whole identifier ("ProjEp" is not in
    "OutProjEp", "layer_norm_kernel" not in "vectorized_layer_norm_kernel")."""
    return re.search(r"(?<![A-Za-z0-9_])" + word + r"(?![A-Za-z0-9_])", name) is not None


def kernel_of(name: str, present: Tuple[str, ...]) -> str:
    """The entry (of ``present``, the entries the cell's path runs) that a
    device kernel named ``name`` belongs to, or "" for any other kernel."""
    for kid in present:
        if any(_has(name, p) for p in KERNELS[kid]["parts"]):
            return kid
    return ""


def is_anchor(kid: str, name: str) -> bool:
    return any(_has(name, a) for a in KERNELS[kid]["anchor"])


def trace_entries(kernels: Dict[str, Tuple[int, float]], dims, B: int,
                  s: int) -> Dict[str, Tuple[float, float, int]]:
    """{entry: (bound seconds, device seconds, calls)} of the encoder's and
    the frontend's hand kernels among a trace's ``kernels`` ({name: (count,
    seconds)}), every call at batch ``B`` in a compute dtype of ``s`` bytes.
    ``attn_tc_kernel`` is the fused block's (K4) where the trace holds the
    fused block's finish, else K8's."""
    fused = any(_has(n, "FcEp") for n in kernels)
    present = ("K1", "K3", "K4+K6" if fused else "K8")
    acc: Dict[str, list] = {}
    for name, (count, secs) in kernels.items():
        kid = kernel_of(name, present)
        if kid:
            e = acc.setdefault(kid, [0, 0.0])
            e[0] += count if is_anchor(kid, name) else 0
            e[1] += secs
    return {kid: (calls * kernel_call_bound_s(kid, dims, B, s), secs, calls)
            for kid, (calls, secs) in acc.items() if calls and secs > 0}


def trace_share(profile: Dict, dims, kids=None, s: int = 2) -> Optional[float]:
    """Percent of the bound reached by the entries ``kids`` (all when None)
    in a driver's traced stretch (``profile``: ``trace`` and ``batch``), or
    None where the trace holds none of them."""
    summary = profile.get("trace") if profile else None
    if summary is None:
        return None
    entries = trace_entries(summary["kernels"], dims, profile["batch"], s)
    picked = [v for k, v in entries.items() if kids is None or k in kids]
    if not picked:
        return None
    return 100.0 * sum(b for b, _, _ in picked) / sum(t for _, t, _ in picked)


def kernel_call_bound_s(kid: str, dims, B: int, s: int) -> float:
    """Least seconds of one call of entry ``kid`` at batch ``B`` in a
    compute dtype of ``s`` bytes (K1 always fp32 through 3xTF32)."""
    T = dims["n_audio_ctx"]
    Tp, D, H = _pad128(T), dims["n_audio_state"], dims["n_audio_head"]
    peak = "bf16" if s == 2 else "tf32x3"
    if kid == "K1":
        return bound_s(*mel_work(B, 480000 + 400, 2 * T, dims["n_mels"]), "tf32x3")
    if kid == "K3":
        return bound_s(*stem_work(B, dims["n_mels"], 2 * T, D, T, Tp, s), peak)
    if kid == "K4+K6":
        a, f = attn_work(B, Tp, D, H, T, s), finish_work(B, Tp, D, s)
        return bound_s(a[0] + f[0], a[1] + f[1], peak)
    if kid == "K8":
        return bound_s(*packed_work(B, Tp, Tp, D, H, T, s), peak)
    raise KeyError(kid)
