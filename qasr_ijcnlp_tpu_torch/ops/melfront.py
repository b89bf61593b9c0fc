"""STFT + mel frontend (K1): frames x Hann -> DFT -> power -> mel -> log10.

Replaces ``qasr_ijcnlp_tpu/ops/melfront.py`` ``_mel_kernel``.  A 400-point
DFT is small enough that one matrix product per stage beats an FFT, so the
frontend is two products: windowed frames @ [cos | -sin] (400 -> 2 x 201),
then |.|^2 @ mel^T (201 -> n_mels), then log10(max(., 1e-10)).  The reference
pins both products to true fp32 (``Precision.HIGHEST``); the plain version
runs with TF32 off.

On the H100 (``csrc/melfront.cu``) both products run on the tensor cores
(``csrc/gemm_tc.cuh``, wgmma + TMA) as 3xTF32.  A pass cuts each padded
waveform into rows of one hop (160 samples, ``frame_rows``); a frame is
three consecutive rows, read as three row views with no framing copy.  The
DFT's basis has the Hann window folded in and its rows interleaved as (cos,
-sin) per bin (``gemm_tables``, built once per device), so the DFT's
epilogue squares and sums each (re, im) pair into the power spectrum, and
the mel product's epilogue writes log10 already transposed.

The per-item max - 8 clamp and the (x + 4) / 4 scaling depend on the whole
spectrogram, so they stay outside the kernel, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from . import recording_ops
from ..audio import HOP_LENGTH, N_FFT, mel_filters
from .encoder_block import gemm_operand

launches = 0
N_MELS = (80, 128)  # the mel bins the kernels take (every Whisper size's)


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


# The kernel's GEMM widths: a frame is three hops (K 480, samples past 400
# weighted 0); (re, im) of 201 bins -> 512 columns; power 201 -> 256 bins;
# n_mels -> 128 columns.
DFT_K, DFT_N, POWER_K, MEL_N = 3 * HOP_LENGTH, 512, 256, 128


@functools.lru_cache(maxsize=8)
def gemm_tables(n_mels: int, device: torch.device):
    """The kernel's weights as 3xTF32 GEMM operands (hi/lo slabs): the DFT
    basis (2, 512, 480), row 2i = window x cos of bin i and row 2i + 1 =
    -window x sin (the window folded in, in float64, rounded once), zero
    past bin 200 and past sample 400; the mel filterbank (2, 128, 256),
    zero-padded."""
    n_bins = N_FFT // 2 + 1
    k = np.arange(N_FFT)
    window = 0.5 * (1 - np.cos(2 * np.pi * k / N_FFT))
    ang = 2 * np.pi * np.arange(n_bins)[:, None] * k[None, :] / N_FFT
    basis = np.zeros((DFT_N, DFT_K))
    basis[0:2 * n_bins:2, :N_FFT] = window * np.cos(ang)
    basis[1:2 * n_bins:2, :N_FFT] = -window * np.sin(ang)
    melfb = np.zeros((MEL_N, POWER_K), np.float32)
    melfb[:n_mels, :n_bins] = mel_filters(n_mels)
    return tuple(gemm_operand(torch.from_numpy(t.astype(np.float32)), torch.float32)
                 .to(device) for t in (basis, melfb))


def frame_rows(length: int):
    """(F, R) for a padded waveform of ``length`` samples: F frames kept
    (the reference drops the final one) and R >= F + 2 hop rows an item,
    so that frame f's three rows f, f + 1, f + 2 lie in its item."""
    n_keep = (length - N_FFT) // HOP_LENGTH
    return n_keep, n_keep + 2


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
    if recording_ops():
        return torch.ops.qasr.log10_mel(audio, n_mels)
    if not audio.is_cuda:
        return _plain_log10_mel(audio, n_mels)
    return _launch_log_mel(audio, n_mels)


def _launch_log_mel(audio, n_mels: int):
    """K1 on the card."""
    global launches
    if audio.dim() != 2 or audio.dtype != torch.float32 or \
            audio.shape[-1] < N_FFT + HOP_LENGTH:
        raise ValueError(f"log10_mel: expected (B, L >= {N_FFT + HOP_LENGTH}) float32 "
                         f"audio, got {tuple(audio.shape)} {audio.dtype}")
    if n_mels not in N_MELS:
        raise ValueError(f"log10_mel: the kernel takes {N_MELS} mel bins, got {n_mels}")
    B, L = audio.shape
    F_keep, R = frame_rows(L)
    basis, melfb = gemm_tables(n_mels, audio.device)
    audio = audio.contiguous()
    rows = audio.new_empty(2, B * R, HOP_LENGTH)
    power = audio.new_empty(2, B * R, POWER_K)
    out = audio.new_empty(B, n_mels, F_keep)
    _kernels.check_cuda("log10_mel", audio, basis, melfb, rows, power, out,
                        dtype=torch.float32)
    _kernels.library().call(
        "qasr_log_mel", audio.device, audio.data_ptr(), basis.data_ptr(), melfb.data_ptr(),
        rows.data_ptr(), power.data_ptr(), out.data_ptr(), B, L, R, F_keep, n_mels,
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
