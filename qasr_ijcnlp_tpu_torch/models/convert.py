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
state-dict names and layouts, classical or quantum stem alike (a quantum
encoder holds ``qconv1``/``qconv2``: ``pre_w`` (in, out) becomes
``qconv1.pre.weight`` (out, in), and so on); :func:`from_jax_encoder` maps
an encoder tree alone, :func:`from_jax_head` a task head (the MLP and LSTM
character heads, the classifier).  It mirrors the JAX package's
``to_torch_state_dict`` without importing it, so the port never imports JAX.
:func:`to_jax_encoder` and :func:`to_jax_head` go the other way, to numpy
trees in the JAX layout (the JAX package's checkpoint pickles hold such
trees).
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


def _quantum_conv(out, prefix, p):
    _linear(out, f"{prefix}.pre", {"w": p["pre_w"], "b": p["pre_b"]})
    _linear(out, f"{prefix}.post", {"w": p["post_w"], "b": p["post_b"]})
    out[f"{prefix}.qweights"] = _tensor(p["qweights"])


def from_jax_encoder(enc: Dict[str, Any], dims: ModelDimensions,
                     prefix: str = "encoder") -> Dict[str, torch.Tensor]:
    """A JAX encoder tree (numpy leaves), classical or quantum stem, -> the
    port's encoder state dict under ``prefix`` ("" for the encoder module's
    own names)."""
    out: Dict[str, torch.Tensor] = {}
    pre = f"{prefix}." if prefix else ""
    if "qconv1" in enc:
        for name in ("qconv1", "qconv2"):
            _quantum_conv(out, f"{pre}{name}", enc[name])
    else:
        for name in ("conv1", "conv2"):
            out[f"{pre}{name}.weight"] = _tensor(enc[name]["w"])
            out[f"{pre}{name}.bias"] = _tensor(enc[name]["b"])
    out[f"{pre}positional_embedding"] = _tensor(enc["pos"])
    for i in range(dims.n_audio_layer):
        _block(out, f"{pre}blocks.{i}", _layer(enc["blocks"], i))
    _ln(out, f"{pre}ln_post", enc["ln_post"])
    return out


def from_jax_params(tree: Dict[str, Any], dims: ModelDimensions) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict."""
    out = from_jax_encoder(tree["encoder"], dims)
    dec = tree["decoder"]
    out["decoder.token_embedding.weight"] = _tensor(dec["tok_emb"])
    out["decoder.positional_embedding"] = _tensor(dec["pos_emb"])
    for i in range(dims.n_text_layer):
        _block(out, f"decoder.blocks.{i}", _layer(dec["blocks"], i))
    _ln(out, "decoder.ln", dec["ln"])
    return out


def from_jax_head(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX task-head tree (numpy leaves) -> the state dict of the port's
    head module: each ``{"w", "b"}`` Linear becomes ``weight`` (its
    transpose) and ``bias``, list items are numbered, other arrays
    (``char_emb``, ``pos``) keep their names.  The MLP and LSTM character
    heads (``models.asr``) and the classifier (``models.classifier``)."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict) and "w" in tree and set(tree) <= {"w", "b"}:
        out[f"{prefix}weight"] = _tensor(np.asarray(tree["w"]).T)
        if "b" in tree:
            out[f"{prefix}bias"] = _tensor(tree["b"])
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(from_jax_head(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(from_jax_head(v, f"{prefix}{i}."))
    else:
        out[prefix.rstrip(".")] = _tensor(tree)
    return out


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _state(module_or_sd) -> Dict[str, torch.Tensor]:
    return module_or_sd.state_dict() if hasattr(module_or_sd, "state_dict") else module_or_sd


def to_jax_head(module_or_sd) -> Any:
    """The inverse of :func:`from_jax_head`: a head module (or its state
    dict) -> a numpy tree in the JAX layout."""
    sd = _state(module_or_sd)
    tree: Dict[str, Any] = {}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "weight" and t.dim() == 2:
            node["w"] = _np(t).T.copy()
        elif leaf == "bias" and ".".join(path + ["weight"]) in sd:
            node["b"] = _np(t)
        else:
            node[leaf] = _np(t)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _linear_np(sd, prefix):
    p = {"w": _np(sd[f"{prefix}.weight"]).T.copy()}
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln_np(sd, prefix):
    return {"g": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def _block_np(sd, prefix):
    return {
        "attn": {lin: _linear_np(sd, f"{prefix}.attn.{lin}")
                 for lin in ("query", "key", "value", "out")},
        "attn_ln": _ln_np(sd, f"{prefix}.attn_ln"),
        "mlp": {"fc": _linear_np(sd, f"{prefix}.mlp.0"),
                "proj": _linear_np(sd, f"{prefix}.mlp.2")},
        "mlp_ln": _ln_np(sd, f"{prefix}.mlp_ln"),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def to_jax_encoder(module_or_sd, dims: ModelDimensions) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_encoder` (prefix ""): an encoder
    module (or its state dict), classical or quantum, -> a numpy tree in
    the JAX layout, blocks stacked on a leading layer axis."""
    sd = _state(module_or_sd)
    enc: Dict[str, Any] = {}
    if "qconv1.qweights" in sd:
        for name in ("qconv1", "qconv2"):
            pre, post = _linear_np(sd, f"{name}.pre"), _linear_np(sd, f"{name}.post")
            enc[name] = {"pre_w": pre["w"], "pre_b": pre["b"], "post_w": post["w"],
                         "post_b": post["b"], "qweights": _np(sd[f"{name}.qweights"])}
    else:
        for name in ("conv1", "conv2"):
            enc[name] = {"w": _np(sd[f"{name}.weight"]), "b": _np(sd[f"{name}.bias"])}
    enc["pos"] = _np(sd["positional_embedding"])
    enc["blocks"] = _stack([_block_np(sd, f"blocks.{i}") for i in range(dims.n_audio_layer)])
    enc["ln_post"] = _ln_np(sd, "ln_post")
    return enc


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
