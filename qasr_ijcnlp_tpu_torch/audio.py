"""Audio frontend: loading, constants, padding and the log-mel spectrogram.

Port of ``qasr_ijcnlp_tpu/audio.py``.  Audio arrives as PCM arrays
(float32 in [-1, 1], or int16) or as files: ``load_audio`` runs the
``ffmpeg`` binary when there is one, else the native WAV and FLAC decoders
(``_native.py``) or, without ``g++``, the stdlib WAV reader, all on the
host.  The spectrogram matches the reference
pipeline: periodic-Hann STFT (n_fft 400, hop 160, centered with reflect
padding), power spectrum, Slaney mel projection, log10, per-item clamp to
(max - 8), then (x + 4) / 4.  On a CUDA tensor the STFT-to-log10 part runs in
the hand-written kernel of :mod:`.ops.melfront`.
"""

from __future__ import annotations

import functools
import subprocess
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .profiling import span

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30-second chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 frames in a mel spectrogram input

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # the initial convolutions have stride 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 10ms per audio frame
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 20ms per audio token


# ---------------------------------------------------------------------------
# Host-side audio IO
# ---------------------------------------------------------------------------


def resample_audio(data: np.ndarray, rate: int, sr: int) -> np.ndarray:
    """Mono waveform ``rate`` -> ``sr`` Hz with anti-aliasing.

    Downsampling low-passes BEFORE interpolating; scipy's polyphase
    resampler when available, windowed-sinc FIR + linear interp otherwise.
    The native decoders apply the same filter in C++ (native/resample.cpp).
    """
    if rate == sr:
        return np.asarray(data, np.float32)
    if sr < rate:
        try:
            from math import gcd

            from scipy.signal import resample_poly

            g = gcd(int(rate), int(sr))
            return resample_poly(data, sr // g, rate // g).astype(np.float32)
        except Exception:
            cutoff = 0.45 * sr / rate  # cycles/sample at the input rate
            taps = 65
            n = np.arange(taps) - (taps - 1) / 2
            h = np.sinc(2 * cutoff * n) * np.hamming(taps)
            h /= h.sum()
            data = np.convolve(data, h, mode="same")
    n_out = int(round(len(data) * sr / rate))
    x_old = np.arange(len(data), dtype=np.float64) / rate
    x_new = np.arange(n_out, dtype=np.float64) / sr
    return np.interp(x_new, x_old, data).astype(np.float32)


def _load_wav(file: str, sr: int) -> np.ndarray:
    """Decode a PCM WAV file, mono-mixing and resampling: the native
    decoder, else (no ``g++``, or a variant it does not take, such as
    WAVE_FORMAT_EXTENSIBLE) the stdlib reader."""
    try:
        from ._native import native_wav_decode

        with open(file, "rb") as f:
            data = f.read()
        audio = native_wav_decode(data, sr)
        if audio is not None:
            return audio
    except ValueError:
        raise
    except Exception:
        pass  # native library unavailable; stdlib path below
    import wave

    with wave.open(file, "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return resample_audio(data, rate, sr)


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Open an audio file as a mono float32 waveform at ``sr`` Hz: the
    ``ffmpeg`` binary when present, else the native WAV / FLAC decoders, the
    stdlib WAV reader or, if installed, ``soundfile``."""
    audio = _load_audio_any(file, sr)
    if audio.dtype == np.int16:
        return audio.astype(np.float32) / 32768.0
    return audio


def _load_audio_any(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Like :func:`load_audio`, but int16 whenever the decode chain is
    losslessly 16-bit (ffmpeg's s16le output; a 16-bit mono WAV already at
    ``sr``), float32 otherwise: int16 halves the bytes copied to the card,
    where :func:`log_mel_spectrogram` rescales by an exact power of two."""
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", file,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        return np.frombuffer(out, np.int16).flatten()
    except FileNotFoundError:
        pass  # no ffmpeg binary on this host
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e

    if file.lower().endswith(".wav"):
        pcm = _read_wav_pcm16(file, sr)
        if pcm is not None:
            return pcm
        return _load_wav(file, sr)
    with open(file, "rb") as f:
        head = f.read(4)
    if head == b"fLaC":
        from ._native import native_flac_decode

        with open(file, "rb") as f:
            data = f.read()
        decoded = native_flac_decode(data, sr)
        if decoded is not None:
            return decoded
    try:
        import soundfile  # type: ignore

        data, rate = soundfile.read(file, dtype="float32", always_2d=True)
        return resample_audio(data.mean(axis=1), rate, sr)
    except ImportError:
        raise RuntimeError(
            f"Cannot decode {file!r}: no ffmpeg binary and no soundfile package; "
            "only PCM WAV and FLAC are decoded natively."
        )


def _read_wav_pcm16(file: str, sr: int) -> Optional[np.ndarray]:
    """int16 samples of a mono 16-bit PCM WAV already at ``sr`` Hz, or None
    when the file needs mixing, resampling or format conversion."""
    import wave

    try:
        with wave.open(file, "rb") as w:
            if (
                w.getnchannels() != 1
                or w.getsampwidth() != 2
                or w.getframerate() != sr
            ):
                return None
            raw = w.readframes(w.getnframes())
    except Exception:
        return None  # compressed/extensible variants: full decoders
    return np.frombuffer(raw, np.int16)


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad with zeros or trim ``array`` to ``length`` along ``axis``.

    Works on numpy arrays and torch tensors."""
    with span("frontend.pad"):
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
        with span("frontend.upload"):
            audio = audio.to(device)
    if audio.dtype == torch.int16:
        return audio.float() / 32768.0
    return audio.float()


def preprocess_audio_for_whisper(audio, n_mels: int = 80,
                                 device: Optional[Union[str, torch.device]] = "cuda"):
    """Raw waveform -> model-ready (n_mels, 3000) mel (reference
    utils.py:121-139: pad/trim to 30 s then log-mel)."""
    return log_mel_spectrogram(pad_or_trim(np.asarray(audio, np.float32)), n_mels,
                               device=device)


def log_mel_spectrogram(
    audio: Union[str, np.ndarray, torch.Tensor],
    n_mels: int = 80,
    padding: int = 0,
    device: Optional[Union[str, torch.device]] = "cuda",
) -> torch.Tensor:
    """Log-mel spectrogram of 16 kHz PCM (or of an audio file's, by path),
    shape (..., n_mels, n_frames), on ``device``: the card unless the
    caller asks for the CPU (``None`` keeps a tensor where it lies).
    ``n_mels`` is 80, or 128 for large-v3; ``padding`` zero samples are
    appended first.

    Batched calls clamp each item's dynamic range by its own max, matching
    the reference's per-clip computation."""
    from .ops.melfront import (
        _plain_log10_mel, clamp_and_scale, fused_log_mel_batched, reflect_pad,
    )

    if isinstance(audio, str):
        audio = _load_audio_any(audio)
    with span("frontend"):
        audio = _as_waveform(audio, device)
        lead = audio.shape[:-1]
        audio = audio.reshape(-1, audio.shape[-1])
        if _USE_FUSED_MEL is False:
            out = clamp_and_scale(_plain_log10_mel(reflect_pad(audio, padding), n_mels))
        else:
            out = fused_log_mel_batched(audio, n_mels, padding)
        return out.reshape(*lead, *out.shape[1:])


# None: the mel kernel (K1) wherever the audio lies on the card (the
# default); False: its plain version on the card too (as the JAX package's
# ``set_fused_mel(False)``); True: as None.
_USE_FUSED_MEL: Optional[bool] = None


def set_fused_mel(enabled: Optional[bool]) -> None:
    """The mel kernel K1: None or True on the card, False plain."""
    global _USE_FUSED_MEL
    _USE_FUSED_MEL = enabled


def wire_pcm16(audio) -> Tuple[np.ndarray, float]:
    """A clip as the engine and the server carry it to the device: padded or
    trimmed to 30 s and quantized to int16 against its own peak (float32 in
    [-1, 1], or int16 PCM), with the factor back (float = int16 * scale)."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    audio = pad_or_trim(np.asarray(audio, np.float32))
    peak = float(max(np.max(np.abs(audio)), 1e-9))
    return (audio * (32767.0 / peak)).astype(np.int16), peak / 32767.0


def wire_log_mel(pcm16: torch.Tensor, scales: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, n_mels, 3000) log-mel of int16 clips (B, 480000) times their
    scales (B,), on their device: K1 on the card."""
    return log_mel_spectrogram(pcm16.float() * scales[:, None], n_mels, device=None)
