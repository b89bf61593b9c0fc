"""Audio frontend: constants, padding and the log-mel spectrogram on arrays.

Port of ``qasr_ijcnlp_tpu/audio.py``.  Requests arrive as PCM arrays
(float32 in [-1, 1], or int16), as in the server's JSON body; decoding audio
files waits for the native decoders.  The spectrogram matches the reference
pipeline: periodic-Hann STFT (n_fft 400, hop 160, centered with reflect
padding), power spectrum, Slaney mel projection, log10, per-item clamp to
(max - 8), then (x + 4) / 4.  On a CUDA tensor the STFT-to-log10 part runs in
the hand-written kernel of :mod:`.ops.melfront`.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30-second chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 frames in a mel spectrogram input

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # the initial convolutions have stride 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 10ms per audio frame
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 20ms per audio token


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad with zeros or trim ``array`` to ``length`` along ``axis``.

    Works on numpy arrays and torch tensors."""
    if array.shape[axis] > length:
        index = [slice(None)] * array.ndim
        index[axis] = slice(0, length)
        array = array[tuple(index)]
    if array.shape[axis] < length:
        if isinstance(array, torch.Tensor):
            axis = axis % array.ndim
            pad = [0, 0] * (array.ndim - 1 - axis) + [0, length - array.shape[axis]]
            array = F.pad(array, pad)
        else:
            pad_widths = [(0, 0)] * array.ndim
            pad_widths[axis] = (0, length - array.shape[axis])
            array = np.pad(array, pad_widths)
    return array


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )


@functools.lru_cache(maxsize=None)
def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1 + n_fft//2),
    numerically ``librosa.filters.mel(sr=16000, n_fft=400, n_mels=80|128)``."""
    if n_mels not in (80, 128):
        raise ValueError(f"Unsupported n_mels: {n_mels}")
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_min = _hz_to_mel_slaney(np.array(0.0))
    mel_max = _hz_to_mel_slaney(np.array(sr / 2.0))
    mel_f = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _as_waveform(audio, device) -> torch.Tensor:
    """PCM array or tensor -> float32 tensor on ``device``.  int16 crosses
    to the device as int16 (half the bytes) and is rescaled there by an
    exact power-of-two divide."""
    if isinstance(audio, np.ndarray):
        audio = torch.from_numpy(np.ascontiguousarray(audio))
    if not isinstance(audio, torch.Tensor):
        audio = torch.as_tensor(np.asarray(audio, np.float32))
    if device is not None:
        audio = audio.to(device)
    if audio.dtype == torch.int16:
        return audio.float() / 32768.0
    return audio.float()


def log_mel_spectrogram(
    audio: Union[np.ndarray, torch.Tensor],
    n_mels: int = 80,
    padding: int = 0,
    device: Optional[Union[str, torch.device]] = "cuda",
) -> torch.Tensor:
    """Log-mel spectrogram of 16 kHz PCM, shape (..., n_mels, n_frames), on
    ``device``: the card unless the caller asks for the CPU (``None`` keeps
    a tensor where it lies).  ``n_mels`` is 80, or 128 for large-v3.

    Batched calls clamp each item's dynamic range by its own max, matching
    the reference's per-clip computation."""
    from .ops.melfront import fused_log_mel_batched

    audio = _as_waveform(audio, device)
    lead = audio.shape[:-1]
    out = fused_log_mel_batched(audio.reshape(-1, audio.shape[-1]), n_mels, padding)
    return out.reshape(*lead, *out.shape[1:])
