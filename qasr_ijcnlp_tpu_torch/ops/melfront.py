"""STFT + mel frontend (K1): frames x Hann -> DFT -> power -> mel -> log10.

Replaces ``qasr_ijcnlp_tpu/ops/melfront.py`` ``_mel_kernel``.  A 400-point
DFT is small enough that one matrix product per stage beats an FFT, so the
frontend is two products: windowed frames @ [cos | -sin] (400 -> 2 x 201),
then |.|^2 @ mel^T (201 -> n_mels), then log10(max(., 1e-10)).  The reference
pins both products to true fp32 (``Precision.HIGHEST``); the CUDA kernel
(``csrc/melfront.cu``) uses fp32 FMAs only, and the plain version runs with
TF32 off.  On the H100 the DFT product dominates and is bound by CUDA-core
FMA throughput; the kernel reads frames straight out of the padded waveform
and never stores the power spectrum.

The per-item max - 8 clamp and the (x + 4) / 4 scaling depend on the whole
spectrogram, so they stay outside the kernel, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..audio import HOP_LENGTH, N_FFT, mel_filters

launches = 0


@functools.lru_cache(maxsize=None)
def _tables(n_mels: int):
    """Periodic Hann window (400,), DFT basis (402, 400) = [cos; -sin] rows,
    mel filterbank (n_mels, 201); numpy float32."""
    n_bins = N_FFT // 2 + 1
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT))
    ang = 2 * np.pi * np.arange(n_bins)[:, None] * np.arange(N_FFT)[None, :] / N_FFT
    basis = np.concatenate([np.cos(ang), -np.sin(ang)]).astype(np.float32)
    return window.astype(np.float32), basis, mel_filters(n_mels)


@functools.lru_cache(maxsize=8)
def _device_tables(n_mels: int, device: torch.device):
    return tuple(torch.from_numpy(t).to(device) for t in _tables(n_mels))


def _plain_log10_mel(audio, n_mels: int):
    """Plain PyTorch version: reflect-padded (B, L) -> (B, n_mels, frames - 1)
    log10 mel (the reference drops the final frame)."""
    window, basis, melfb = _device_tables(n_mels, audio.device)
    frames = audio.unfold(-1, N_FFT, HOP_LENGTH)[:, :-1] * window  # (B, F, 400)
    spec = frames @ basis.t()
    n_bins = N_FFT // 2 + 1
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    mel = power @ melfb.t()  # (B, F, n_mels)
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def log10_mel(audio, n_mels: int = 80):
    """Reflect-padded waveform (B, L) float32 -> (B, n_mels, frames - 1)
    log10 mel power, before the clamp and scaling."""
    if not audio.is_cuda:
        return _plain_log10_mel(audio, n_mels)
    global launches
    if audio.dim() != 2 or audio.dtype != torch.float32 or audio.shape[-1] < N_FFT:
        raise ValueError(f"log10_mel: expected (B, L >= {N_FFT}) float32 audio, "
                         f"got {tuple(audio.shape)} {audio.dtype}")
    B, L = audio.shape
    n_frames = (L - N_FFT) // HOP_LENGTH + 1
    F_keep = n_frames - 1
    window, basis, melfb = _device_tables(n_mels, audio.device)
    audio = audio.contiguous()
    spec = audio.new_empty(B * F_keep, 2 * (N_FFT // 2 + 1))
    out = audio.new_empty(B, n_mels, F_keep)
    _kernels.check_cuda("log10_mel", audio, window, basis, melfb, spec, out,
                        dtype=torch.float32)
    _kernels.library().call(
        "qasr_log_mel", audio.device, audio.data_ptr(), window.data_ptr(),
        basis.data_ptr(), melfb.data_ptr(), spec.data_ptr(), out.data_ptr(),
        B, L, F_keep, n_mels,
    )
    launches += 1
    return out


def reflect_pad(audio2d, padding: int = 0):
    """Zero-pad ``padding`` samples at the end, then reflect-pad n_fft // 2
    on both sides (torch.stft(center=True))."""
    if padding > 0:
        audio2d = F.pad(audio2d, (0, padding))
    return F.pad(audio2d[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]


def clamp_and_scale(log_spec):
    """Per-item dynamic-range clamp to (max - 8), then (x + 4) / 4."""
    item_max = log_spec.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_spec, item_max - 8.0) + 4.0) / 4.0


def fused_log_mel_batched(audio2d, n_mels: int = 80, padding: int = 0):
    """(B, n_samples) float32 waveforms -> (B, n_mels, n_frames) log-mel,
    each item clamped by its own max."""
    return clamp_and_scale(log10_mel(reflect_pad(audio2d, padding), n_mels))


def fused_log_mel_spectrogram(audio, n_mels: int = 80, padding: int = 0):
    """1-D waveform -> (n_mels, n_frames) log-mel."""
    return fused_log_mel_batched(audio[None], n_mels, padding)[0]
