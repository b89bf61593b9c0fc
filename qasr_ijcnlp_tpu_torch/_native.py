"""ctypes binding of the native audio decoders (``native/*.cpp``).

The port keeps its own copies of the JAX package's WAV, FLAC and
resampling sources (``tests/test_torch_io.py`` holds them equal byte for
byte, but for the reference's paths in comments) and builds them with the
system ``g++`` at first use into ``native/build/libqasr_torch_audio_<hash>
.so`` (keyed by the sources' hash).  A ``None`` handle (no ``g++``) sends
the caller to the stdlib WAV decoder, a host decoding path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
SOURCES = ("wavio.cpp", "flac.cpp", "resample.cpp")


def sources():
    """The native sources the library is built from (package data)."""
    return [os.path.join(_NATIVE_DIR, s) for s in SOURCES]


def _build() -> Optional[str]:
    h = hashlib.sha1()
    for src in sources():
        with open(src, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(_BUILD_DIR, f"libqasr_torch_audio_{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", *sources(), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except Exception:
        return None


_LIB = "unset"


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB == "unset":
        path = _build()
        _LIB = None if path is None else ctypes.CDLL(path)
        if _LIB is not None:
            for fn in (_LIB.qasr_wav_decode, _LIB.qasr_flac_decode):
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                               ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    return _LIB


def _decode(fn_name: str, kind: str, data: bytes, target_rate: int):
    lib = _lib()
    if lib is None:
        return None
    fn = getattr(lib, fn_name)
    n = fn(data, len(data), target_rate, None, 0)
    if n == -2:
        # A valid variant the decoder does not take (e.g. WAVE_FORMAT_
        # EXTENSIBLE): None sends the caller to the next decoder.
        return None
    if n < 0:
        raise ValueError(f"{kind} decode failed (code {n})")
    out = np.empty(int(n), np.float32)
    got = fn(data, len(data), target_rate, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
             n)
    if got < 0:
        raise ValueError(f"{kind} decode failed (code {got})")
    return out[:got]


def native_wav_decode(data: bytes, target_rate: int = 16000):
    """WAV bytes -> mono float32 at ``target_rate``; None without the
    library or for a variant it does not take; ValueError on malformed
    input."""
    return _decode("qasr_wav_decode", "WAV", data, target_rate)


def native_flac_decode(data: bytes, target_rate: int = 16000):
    """FLAC bytes -> mono float32 at ``target_rate``; as
    :func:`native_wav_decode`."""
    return _decode("qasr_flac_decode", "FLAC", data, target_rate)
