"""Weights across frameworks: the JAX parameter tree -> the port's state dict.

The JAX package stores its parameters as a tree of arrays with every
transformer block stacked on a leading layer axis, Linear weights ``(in,
out)`` and conv weights ``(O, I, K)`` (``qasr_ijcnlp_tpu/models/whisper.py``).
:func:`from_jax_params` maps that tree, given as numpy arrays, onto the
reference (OpenAI) state-dict names and layouts that the port's modules use.
It mirrors ``qasr_ijcnlp_tpu/models/convert.py`` ``to_torch_state_dict``
without importing it, so the port never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .dims import ModelDimensions


def _tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.float32 and np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True))


def _linear(out, prefix, p):
    out[f"{prefix}.weight"] = _tensor(np.asarray(p["w"]).T)
    if "b" in p:
        out[f"{prefix}.bias"] = _tensor(p["b"])


def _ln(out, prefix, p):
    out[f"{prefix}.weight"] = _tensor(p["g"])
    out[f"{prefix}.bias"] = _tensor(p["b"])


def _block(out, prefix, bp):
    for name in ("attn", "cross_attn"):
        if name in bp:
            for lin in ("query", "key", "value", "out"):
                _linear(out, f"{prefix}.{name}.{lin}", bp[name][lin])
            _ln(out, f"{prefix}.{name}_ln", bp[f"{name}_ln"])
    _linear(out, f"{prefix}.mlp.0", bp["mlp"]["fc"])
    _linear(out, f"{prefix}.mlp.2", bp["mlp"]["proj"])
    _ln(out, f"{prefix}.mlp_ln", bp["mlp_ln"])


def _layer(tree, i):
    """Slice layer ``i`` out of a stacked block tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def from_jax_params(tree: Dict[str, Any], dims: ModelDimensions) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    enc = tree["encoder"]
    for name in ("conv1", "conv2"):
        out[f"encoder.{name}.weight"] = _tensor(enc[name]["w"])
        out[f"encoder.{name}.bias"] = _tensor(enc[name]["b"])
    out["encoder.positional_embedding"] = _tensor(enc["pos"])
    for i in range(dims.n_audio_layer):
        _block(out, f"encoder.blocks.{i}", _layer(enc["blocks"], i))
    _ln(out, "encoder.ln_post", enc["ln_post"])

    dec = tree["decoder"]
    out["decoder.token_embedding.weight"] = _tensor(dec["tok_emb"])
    out["decoder.positional_embedding"] = _tensor(dec["pos_emb"])
    for i in range(dims.n_text_layer):
        _block(out, f"decoder.blocks.{i}", _layer(dec["blocks"], i))
    _ln(out, "decoder.ln", dec["ln"])
    return out
