"""The loaded-model handle the decode and transcribe layers consume.

Port of ``qasr_ijcnlp_tpu/models/registry.py`` ``WhisperModel``: the
official model names, their alignment-head tables, and the handle's
reference API (``embed_audio``, ``logits``, ``forward``, ``decode``,
``detect_language``, ``transcribe``), ``load_model`` and ``save_model``.
Weights come from an official-format ``.pt`` file, from
:func:`..models.whisper.init_params` or from :func:`..models.convert.
from_jax_params`.  A model name resolves only to a file already in the
cache directory whose SHA-256 matches the official one: the port opens no
network connection.
"""

from __future__ import annotations

import base64
import copy
import gzip
import hashlib
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from . import whisper as _model
from .convert import load_torch_checkpoint, save_torch_checkpoint
from .dims import ModelDimensions, dims_for

# Official model names -> the SHA-256 of their public checkpoint files (data
# table; reference whisper/__init__.py:17-32, the hash is the second-to-last
# part of each download URL).  The port opens no network connection.
_MODELS = {
    "tiny.en": "d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03",
    "tiny": "65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9",
    "base.en": "25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead",
    "base": "ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e",
    "small.en": "f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872",
    "small": "9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794",
    "medium.en": "d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f",
    "medium": "345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1",
    "large-v1": "e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a",
    "large-v2": "81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524",
    "large-v3": "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb",
    "large": "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb",
    "large-v3-turbo": "aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a",
    "turbo": "aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a",
}
# The checkpoint file of each name is ``{name}.pt``, except for the aliases.
_MODEL_FILES = {"large": "large-v3.pt", "turbo": "large-v3-turbo.pt"}

# base85+gzip (n_text_layer, n_text_head) boolean masks of the cross-attention
# heads used for word-level timing (data table; reference __init__.py:36-51).
_ALIGNMENT_HEADS = {
    "tiny.en": b"ABzY8J1N>@0{>%R00Bk>$p{7v037`oCl~+#00",
    "tiny": b"ABzY8bu8Lr0{>%RKn9Fp%m@SkK7Kt=7ytkO",
    "base.en": b"ABzY8;40c<0{>%RzzG;p*o+Vo09|#PsxSZm00",
    "base": b"ABzY8KQ!870{>%RzyTQH3`Q^yNP!>##QT-<FaQ7m",
    "small.en": b"ABzY8>?_)10{>%RpeA61k&I|OI3I$65C{;;pbCHh0B{qLQ;+}v00",
    "small": b"ABzY8DmU6=0{>%Rpa?J`kvJ6qF(V^F86#Xh7JUGMK}P<N0000",
    "medium.en": b"ABzY8usPae0{>%R7<zz_OvQ{)4kMa0BMw6u5rT}kRKX;$NfYBv00*Hl@qhsU00",
    "medium": b"ABzY8B0Jh+0{>%R7}kK1fFL7w6%<-Pf*t^=N)Qr&0RR9",
    "large-v1": b"ABzY8r9j$a0{>%R7#4sLmoOs{s)o3~84-RPdcFk!JR<kSfC2yj",
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
    "large-v3": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large-v3-turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
    "turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
}


def _as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("float32", "bfloat16")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


class WhisperModel:
    """A model on one device: dims, the ``Whisper`` module and its device."""

    def __init__(self, dims: ModelDimensions, module: _model.Whisper,
                 name: str = "custom", compute_dtype="float32"):
        self.dims = dims
        self.module = module
        self.name = name
        # The encoder's dtype in ``embed_audio`` (the alignment's re-encode).
        self.compute_dtype = _as_dtype(compute_dtype)
        # (n_text_layer, n_text_head) bool; None: ``default_alignment_heads``
        self.alignment_heads: Optional[np.ndarray] = None
        self._decoders: Dict[torch.dtype, _model.TextDecoder] = {}
        self._task_cache: Dict = {}

    @classmethod
    def from_state_dict(cls, state_dict: Dict[str, torch.Tensor], dims: ModelDimensions,
                        device: Union[str, torch.device] = "cuda",
                        name: str = "custom", compute_dtype="float32") -> "WhisperModel":
        """The model on ``device``: the card unless the caller asks for the
        CPU."""
        with torch.device("meta"):
            module = _model.Whisper(dims)
        module.load_state_dict(state_dict, strict=True, assign=True)
        module = module.to(device).eval().requires_grad_(False)
        return cls(dims, module, name=name, compute_dtype=compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.module.decoder.positional_embedding.device

    @property
    def is_multilingual(self) -> bool:
        return _model.is_multilingual(self.dims)

    @property
    def num_languages(self) -> int:
        return _model.num_languages(self.dims)

    def decoder_for(self, dtype: torch.dtype) -> _model.TextDecoder:
        """The text decoder with its block Linear weights in ``dtype``, cast
        once and kept.  The reference casts its fp32 parameters per op;
        casting once gives the same values without re-casting every weight
        at every decode step.  LayerNorms and the embeddings stay fp32 (the
        embedding sum is formed in fp32 before the cast)."""
        if dtype == torch.float32:
            return self.module.decoder
        dec = self._decoders.get(dtype)
        if dec is None:
            dec = copy.deepcopy(self.module.decoder)
            for mod in dec.blocks.modules():
                if isinstance(mod, nn.Linear):
                    for p in mod.parameters(recurse=False):
                        p.data = p.data.to(dtype)
            self._decoders[dtype] = dec
        return dec

    def set_alignment_heads(self, dump: bytes):
        array = np.frombuffer(
            gzip.decompress(base64.b85decode(dump)), dtype=bool
        ).copy()
        self.alignment_heads = array.reshape(
            self.dims.n_text_layer, self.dims.n_text_head
        )

    def default_alignment_heads(self) -> np.ndarray:
        # Last half of the decoder layers (reference model.py:270-276).
        heads = np.zeros((self.dims.n_text_layer, self.dims.n_text_head), bool)
        heads[self.dims.n_text_layer // 2:] = True
        return heads

    @torch.inference_mode()
    def embed_audio(self, mel):
        mel = torch.as_tensor(mel).to(self.device)
        return _model.dispatch_encoder_apply(self.module.encoder, mel, self.dims,
                                             self.compute_dtype)

    @torch.inference_mode()
    def logits(self, tokens, audio_features):
        tokens = torch.as_tensor(tokens).to(self.device)
        return _model.decoder_apply(self.module.decoder, tokens,
                                    torch.as_tensor(audio_features).to(self.device),
                                    self.dims, self.compute_dtype)

    @torch.inference_mode()
    def forward(self, mel, tokens):
        return _model.forward(self.module, torch.as_tensor(mel).to(self.device),
                              torch.as_tensor(tokens).to(self.device), self.dims,
                              self.compute_dtype)

    __call__ = forward

    def decode(self, mel, options=None, **kwargs):
        from ..decode import DecodingOptions, decode as _decode

        return _decode(self, mel, options or DecodingOptions(), **kwargs)

    def detect_language(self, mel, tokenizer=None):
        from ..decode import detect_language as _dl

        return _dl(self, mel, tokenizer)

    def transcribe(self, audio, **kwargs):
        from ..transcribe import transcribe as _tr

        return _tr(self, audio, **kwargs)


def available_models() -> List[str]:
    return list(_MODELS.keys())


def _file_sha256(path: str) -> str:
    # 1-MB chunks: a large-v3 checkpoint is ~3 GB
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 20)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def _cached_checkpoint(name: str, root: str) -> str:
    """The cached checkpoint of official model ``name`` under ``root``; its
    SHA-256 must be the official one.  Nothing is downloaded."""
    path = os.path.join(root, _MODEL_FILES.get(name, f"{name}.pt"))
    if not os.path.isfile(path):
        raise RuntimeError(
            f"Model {name}: no checkpoint at {path}, and this package does not "
            f"download; place the official file there or pass its path")
    if _file_sha256(path) != _MODELS[name]:
        raise RuntimeError(f"Model {name}: {path} does not have the official SHA-256")
    return path


def load_model(
    name: str,
    download_root: Optional[str] = None,
    compute_dtype="float32",
    init_if_missing: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> WhisperModel:
    """A Whisper model by official name (a cached, SHA-256-checked file) or
    by checkpoint path, on ``device``: the card unless the caller asks for
    the CPU.

    ``init_if_missing=True`` gives a random initialization with the
    official dims (seed 0) when no checkpoint loads, flagged in
    ``model.name``, with the default alignment heads.
    """
    if download_root is None:
        default = os.path.join(os.path.expanduser("~"), ".cache")
        download_root = os.path.join(os.getenv("XDG_CACHE_HOME", default), "whisper")

    try:
        if name in _MODELS:
            path = _cached_checkpoint(name, download_root)
            alignment_dump = _ALIGNMENT_HEADS[name]
        elif os.path.isfile(name):
            path = name
            alignment_dump = None
        else:
            raise RuntimeError(
                f"Model {name} not found; available models = {available_models()}"
            )
        state_dict, dims = load_torch_checkpoint(path)
    except Exception:
        if not init_if_missing:
            raise
        dims = dims_for(name) if name in _MODELS else dims_for("tiny")
        state_dict = _model.init_params(torch.Generator().manual_seed(0), dims)
        model = WhisperModel.from_state_dict(
            state_dict, dims, device, name=f"{name} (random-init)",
            compute_dtype=compute_dtype)
        model.alignment_heads = model.default_alignment_heads()
        return model

    model = WhisperModel.from_state_dict(state_dict, dims, device, name=name,
                                         compute_dtype=compute_dtype)
    if alignment_dump is not None:
        model.set_alignment_heads(alignment_dump)
    else:
        model.alignment_heads = model.default_alignment_heads()
    return model


def save_model(model: WhisperModel, path: str) -> None:
    """Save in the official .pt format (loadable by the reference).

    Only classical-stem models map onto the official layout; a quantum-stem
    model (``qconv1``/``qconv2`` in place of ``conv1``/``conv2``) has no
    official format."""
    if not hasattr(model.module.encoder, "conv1"):
        raise ValueError(
            "save_model exports the official .pt layout, which has no "
            "quantum stem; save quantum models with "
            "train.checkpoint.save_pytree instead"
        )
    save_torch_checkpoint(path, model.module, model.dims)
