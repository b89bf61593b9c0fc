"""Weight-only int8 quantization for deployment artifacts.

Port of ``qasr_ijcnlp_tpu/models/quantize.py``: per-channel symmetric int8
over the large weight arrays, each becoming ``{"q": int8, "s": f32 scales}``
with ``q * s`` the dequantized weight; small entries (under ``min_size``
elements, or of fewer than two dims) stay f32.  ``export.py`` uses it to
store 1-byte weights in a program that dequantizes them on the device.

The channels are the JAX package's, so ``q`` and ``s`` are bit-equal to
its: it scales over the last dim of *its* parameter tree, whose layout is
not the port's state dict.  There the Linear weights are ``(in, out)``
(one scale per output channel), every block stack is one ``(L, ...)``
array (one scale per channel shared by all L layers, also for the stacked
biases and LayerNorm parameters once L x width reaches ``min_size``), the
conv weights are ``(O, I, K)`` (a scale per tap) and the embeddings
``(T, D)`` (a scale per feature).  So the state dict goes to that tree
(:func:`..convert.to_jax_params`), is quantized there in numpy with the
JAX function's arithmetic (true division ``absmax / 127``, ``np.rint``
half to even, the clip to +-127, a zero scale set to 1), and comes back
by name (:func:`..convert.from_jax_params`).  Each ``s`` keeps the shape
that broadcasts it over its state-dict entry: ``(out, 1)`` for a Linear
weight, ``(D,)`` for a bias, an embedding or a LayerNorm, ``(K,)`` for a
conv weight.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from .convert import from_jax_params, to_jax_params
from .dims import ModelDimensions

#: Entries smaller than this stay f32 (the JAX package's threshold).
DEFAULT_MIN_SIZE = 4096

QTensor = Dict[str, torch.Tensor]  # {"q": int8, "s": float32}


def is_quantized(entry) -> bool:
    return isinstance(entry, dict) and set(entry) == {"q", "s"} and \
        entry["q"].dtype == torch.int8


def _quantize_leaf(x: np.ndarray, min_size: int):
    """The JAX package's per-leaf rule: (q, s) or None (left f32)."""
    if x.ndim < 2 or x.size < min_size or not np.issubdtype(x.dtype, np.floating):
        return None
    absmax = np.max(np.abs(x), axis=tuple(range(x.ndim - 1)))
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    return np.clip(np.rint(x / scale), -127, 127).astype(np.int8), scale


def _squeeze_constant(s: torch.Tensor) -> torch.Tensor:
    """``s`` with every axis along which it is constant cut to length 1:
    the smallest tensor that broadcasts to it."""
    for ax in range(s.dim()):
        first = s.narrow(ax, 0, 1)
        if bool((s == first).all()):
            s = first
    return s.contiguous()


def quantize_params(module_or_sd, dims: ModelDimensions,
                    min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, Union[torch.Tensor, QTensor]]:
    """Per-channel symmetric int8 quantization of every large weight of a
    ``Whisper`` module (or its state dict): a dict by state-dict name whose
    eligible entries are ``{"q": int8, "s": float32}`` (CPU tensors) and
    whose others are the f32 tensors themselves.  See the module docstring
    for the channels."""
    tree = to_jax_params(module_or_sd, dims)
    q_tree, s_tree = {}, {}

    def walk(node, q_out, s_out):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, q_out.setdefault(k, {}), s_out.setdefault(k, {}))
                continue
            got = _quantize_leaf(np.asarray(v), min_size)
            q_out[k] = v if got is None else got[0]
            # the scale broadcast over the leaf (a view), mapped back by name
            s_out[k] = np.broadcast_to(np.float32(1) if got is None else got[1],
                                       np.shape(v))

    walk(tree, q_tree, s_tree)
    q_sd = from_jax_params(q_tree, dims)
    scales = from_jax_params(s_tree, dims)
    out: Dict[str, Any] = {}
    for name, q in q_sd.items():
        if q.dtype == torch.int8:
            out[name] = {"q": q, "s": _squeeze_constant(scales[name])}
        else:
            out[name] = q
    return out


def dequantize_params(qparams: Dict[str, Any], dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params` (modulo rounding): every ``{"q",
    "s"}`` entry becomes ``q * s`` in ``dtype``; the others pass through.
    Traceable: the int8 export program calls it on its own buffers."""
    return {k: (v["q"].to(dtype) * v["s"]).to(dtype) if is_quantized(v) else v
            for k, v in qparams.items()}


def quantization_error(module_or_sd, qparams, dims: ModelDimensions) -> Tuple[float, float]:
    """(max elementwise abs error, max per-array relative error) between the
    weights and their quantized form, over the JAX package's arrays (a
    stacked block array is one array), as its ``quantization_error``."""
    ref = to_jax_params(module_or_sd, dims)
    deq = to_jax_params(dequantize_params(qparams), dims)
    max_abs = max_rel = 0.0

    def walk(a, b):
        nonlocal max_abs, max_rel
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
                continue
            x, y = np.asarray(a[k], np.float32), np.asarray(b[k], np.float32)
            if x.shape != y.shape:
                raise ValueError("tree mismatch")
            err = float(np.max(np.abs(x - y))) if x.size else 0.0
            max_abs = max(max_abs, err)
            denom = float(np.max(np.abs(x))) if x.size else 1.0
            if denom > 0:
                max_rel = max(max_rel, err / denom)

    walk(ref, deq)
    return max_abs, max_rel
