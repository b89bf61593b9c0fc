"""Weights across frameworks and on disk.

The port's modules use the reference (OpenAI) state-dict names and layouts,
so an official ``.pt`` checkpoint (``{"dims": {...}, "model_state_dict":
{...}}``) is the port's own state dict: :func:`load_torch_checkpoint`,
:func:`save_torch_checkpoint`, :func:`from_torch_state_dict` and
:func:`to_torch_state_dict` (the names of ``qasr_ijcnlp_tpu/models/
convert.py``) only cast fp16 weights to fp32 and fill a missing sinusoidal
encoder position table.

The JAX package stores its parameters as a tree of arrays with every
transformer block stacked on a leading layer axis, Linear weights ``(in,
out)`` and conv weights ``(O, I, K)`` (``qasr_ijcnlp_tpu/models/whisper.py``).
:func:`from_jax_params` maps that tree, given as numpy arrays, onto the
state-dict names and layouts.  It mirrors the JAX package's
``to_torch_state_dict`` without importing it, so the port never imports JAX.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Tuple, Union

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


def from_torch_state_dict(sd: Dict[str, Any], dims: ModelDimensions) -> Dict[str, torch.Tensor]:
    """An official ``model_state_dict`` -> the port's state dict: CPU
    tensors, floating ones as fp32 (fp16 official weights load as fp32), the
    sinusoidal encoder positions filled in where the dict has none."""
    from .whisper import sinusoids

    out = {k: _tensor(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in sd.items()}
    if "encoder.positional_embedding" not in out:
        out["encoder.positional_embedding"] = torch.from_numpy(
            sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    return out


def to_torch_state_dict(module_or_sd, dims: ModelDimensions) -> Dict[str, torch.Tensor]:
    """The official-layout state dict of a ``Whisper`` module or of a state
    dict: CPU fp32 tensors, reference-loadable."""
    sd = module_or_sd.state_dict() if hasattr(module_or_sd, "state_dict") else module_or_sd
    return {k: v.detach().to("cpu", torch.float32).contiguous().clone()
            for k, v in sd.items()}


def load_torch_checkpoint(path_or_bytes: Union[str, bytes]
                          ) -> Tuple[Dict[str, torch.Tensor], ModelDimensions]:
    """An official-format .pt checkpoint -> (state dict, dims)."""
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else path_or_bytes
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    dims = ModelDimensions.from_dict(ckpt["dims"])
    return from_torch_state_dict(ckpt["model_state_dict"], dims), dims


def save_torch_checkpoint(path: str, state_dict, dims: ModelDimensions) -> None:
    """Write an official-format .pt checkpoint loadable by the reference."""
    torch.save({"dims": dims.to_dict(),
                "model_state_dict": to_torch_state_dict(state_dict, dims)}, path)
