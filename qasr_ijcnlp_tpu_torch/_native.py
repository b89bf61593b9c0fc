"""ctypes binding of the native audio decoders, edit distance and BPE
merge core (``native/*.cpp``).

The port keeps its own copies of the JAX package's WAV, FLAC, resampling,
Levenshtein and BPE sources (``tests/test_torch_io.py`` and
``tests/test_torch_packaging.py`` hold them equal byte for byte, but for
the reference's paths in comments) and builds them with the system ``g++``
at first use into ``native/build/libqasr_torch_native_<hash>.so`` (keyed by
the sources' hash).  A ``None`` handle (no ``g++``) sends the caller to the
stdlib WAV decoder, the numpy edit distance or the pure-Python BPE merge,
host paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
SOURCES = ("wavio.cpp", "flac.cpp", "resample.cpp")  # the audio decoders
EDITDIST = "editdist.cpp"  # the Levenshtein core of ``metrics``
BPE = "bpe.cpp"  # the tokenizer's merge core


def sources():
    """The native sources the library is built from (package data)."""
    return [os.path.join(_NATIVE_DIR, s) for s in (*SOURCES, EDITDIST, BPE)]


def _build() -> Optional[str]:
    h = hashlib.sha1()
    for src in sources():
        with open(src, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(_BUILD_DIR, f"libqasr_torch_native_{h.hexdigest()[:16]}.so")
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
            i32p = ctypes.POINTER(ctypes.c_int32)
            _LIB.qasr_levenshtein.restype = ctypes.c_int32
            _LIB.qasr_levenshtein.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32]
            _LIB.qasr_bpe_create.restype = ctypes.c_void_p
            _LIB.qasr_bpe_create.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                             i32p, ctypes.c_int64]
            _LIB.qasr_bpe_merge.restype = ctypes.c_int32
            _LIB.qasr_bpe_merge.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                            i32p, ctypes.c_int32]
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


def native_levenshtein(a_ids, b_ids) -> Optional[int]:
    """Edit distance over two int-id sequences by the C++ core; None
    without the library."""
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a_ids, np.int32)
    b = np.ascontiguousarray(b_ids, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    return int(lib.qasr_levenshtein(a.ctypes.data_as(i32p), len(a), b.ctypes.data_as(i32p),
                                    len(b)))


class _BPEHandle:
    """Native BPE state per rank table (the JAX package's ``_BPEHandle``).

    A table's entry holds a strong reference to its ranks dict beside the
    native handle: keyed by ``id(ranks)`` alone, a collected dict's id
    could be reused by another table and serve stale merges.  The output
    buffer is thread-local, so concurrent encodes never share it."""

    CAPACITY = 4096

    def __init__(self):
        self._tables: Dict[int, tuple] = {}  # id -> (ranks, handle)
        self._tls = threading.local()

    def _out_buf(self):
        buf = getattr(self._tls, "out", None)
        if buf is None:
            buf = self._tls.out = (ctypes.c_int32 * self.CAPACITY)()
        return buf

    def _table_for(self, ranks: Dict[bytes, int]) -> ctypes.c_void_p:
        entry = self._tables.get(id(ranks))
        if entry is not None and entry[0] is ranks:
            return entry[1]
        items = list(ranks.items())
        offsets = (ctypes.c_int64 * (len(items) + 1))()
        pos = 0
        for i, (k, _) in enumerate(items):
            offsets[i] = pos
            pos += len(k)
        offsets[len(items)] = pos
        vals = (ctypes.c_int32 * len(items))(*[v for _, v in items])
        handle = ctypes.c_void_p(_lib().qasr_bpe_create(b"".join(k for k, _ in items),
                                                        offsets, vals, len(items)))
        self._tables[id(ranks)] = (ranks, handle)
        return handle

    def merge(self, piece: bytes, ranks: Dict[bytes, int]) -> List[int]:
        """The ids of one pre-tokenized piece; the pure-Python merge where
        the output buffer overflows or a byte is not in the table."""
        out = self._out_buf()
        n = _lib().qasr_bpe_merge(self._table_for(ranks), piece, len(piece), out,
                                  self.CAPACITY)
        if n < 0:
            from .tokenizer.bpe import _bpe_merge

            return _bpe_merge(piece, ranks)
        return list(out[:n])


def bpe_handle() -> _BPEHandle:
    """A native BPE handle; RuntimeError without the library (no g++)."""
    if _lib() is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    return _BPEHandle()
