"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Counterpart of ``qasr_ijcnlp_tpu/_native.py`` with one difference: it never
degrades to ``None``.  A missing ``nvcc``, a failed compile or a missing
symbol raises, because a CUDA tensor that reached a kernel wrapper has no
other path to take.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and one more ``nvcc`` links the objects into
``csrc/build/libqasr_kernels_<hash>.so``, where the hash covers the sources
and the flags, so an edited kernel rebuilds and an unchanged one loads from
disk.  The library has a plain C interface (no PyTorch headers, so it builds
in seconds) and is bound with ``ctypes``: pointers and the CUDA stream go in
as ``c_void_p``, and every entry point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import List, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# name -> argtypes of every C entry point (the trailing pointer is the stream).
_SIGNATURES = {
    "qasr_conv_stem": [_I] + [_P] * 9 + [_I] * 8 + [_P],
    "qasr_attention": [_I] + [_P] * 5 + [_F] + [_P] * 3 + [_I] * 6 + [_P],
    "qasr_finish": [_I] + [_P] * 15 + [_I] * 3 + [_P],
    "qasr_block_gemm": [_I, _I] + [_P] * 5 + [_I] * 3 + [_F, _P],
    "qasr_packed_attention": [_I] + [_P] * 4 + [_I] * 6 + [_P],
    "qasr_flash_attention": [_I] + [_P] * 4 + [_I] * 6 + [_STRIDES, _P],
    "qasr_log_mel": [_P] * 6 + [_I] * 5 + [_P],
    "qasr_int8_cross_attention": [_I] + [_P] * 6 + [_I] * 9 + [_F, _P],
    "qasr_int8_cross_attention_clusters": [_I] * 7 + [_P, _P],
    "qasr_decoder_layer_step": [_I] + [_P] * 9 + [_I] * 11 + [_P],
    "qasr_attn_parts": [_I] + [_P] * 4 + [_I] * 3 + [_P],
    "qasr_step_formulations": [_I] + [_P] * 6 + [_I] * 3 + [_P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelLibrary:
    """The compiled library plus what its build printed."""

    def __init__(self, path: str, commands: List[List[str]], build_seconds: float,
                 build_log: str):
        self.path = path
        self.commands = commands
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, device: torch.device, *args) -> None:
        """Launch ``name`` on ``device``'s current stream; raise on a CUDA
        error (a refused launch never runs, and a later synchronize would
        not report it)."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(self._lib, name)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} failed with cudaError {err}")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from qasr_ijcnlp_tpu_torch/csrc at first use"
    )


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile (or reuse) the library for the current sources."""
    target = os.path.join(BUILD_DIR, f"libqasr_kernels_{source_hash()}.so")
    units = [p for p in _sources() if p.endswith(".cu")]
    nvcc = _nvcc()
    objs = [os.path.basename(u)[:-3] + ".o" for u in units]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", u, "-o", o] for u, o in zip(units, objs)]
    link = [nvcc, "-shared", "-o", target, *objs]
    if os.path.isfile(target):
        return KernelLibrary(target, compiles + [link], 0.0, "(cached build)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    tmp = os.path.join(work, os.path.basename(target))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=work, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [p.communicate()[0] for p in procs]  # waits for every compile
    failed = [(cmd, log) for cmd, p, log in zip(compiles, procs, logs) if p.returncode]
    if not failed:
        linked = subprocess.run([*link[:3], tmp, *objs], cwd=work,
                                capture_output=True, text=True)
        logs.append(linked.stdout + linked.stderr)
        if linked.returncode:
            failed = [(link, logs[-1])]
    seconds = time.perf_counter() - t0
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        cmd, log = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    return KernelLibrary(target, compiles + [link], seconds, "".join(logs))


_LOCK = threading.Lock()
_LIBRARY: Optional[KernelLibrary] = None


def library() -> KernelLibrary:
    """The process-wide kernel library, built on first use."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            _LIBRARY = build()
        return _LIBRARY


def check_cuda(name: str, *tensors: torch.Tensor, dtype=None,
               contiguous: bool = True) -> None:
    """Raise unless every tensor is a CUDA tensor on the first tensor's
    device, contiguous (or, with ``contiguous=False``, with unit stride in
    its last dim) and of ``dtype`` when given."""
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(
                f"{name}: expected CUDA tensors on {device}, got {t.device}"
            )
        if not (t.is_contiguous() if contiguous else t.stride(-1) == 1):
            raise ValueError(f"{name}: expected contiguous tensors")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
