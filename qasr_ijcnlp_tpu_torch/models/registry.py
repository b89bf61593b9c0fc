"""The loaded-model handle the decode layer consumes.

Port of ``qasr_ijcnlp_tpu/models/registry.py`` ``WhisperModel``.  Loading
official checkpoints by name (``load_model``) waits for checkpoint files;
weights come from :func:`..models.whisper.init_params` or
:func:`..models.convert.from_jax_params`.
"""

from __future__ import annotations

import copy
from typing import Dict, Union

import torch
from torch import nn

from . import whisper as _model
from .dims import ModelDimensions


class WhisperModel:
    """A model on one device: dims, the ``Whisper`` module and its device."""

    def __init__(self, dims: ModelDimensions, module: _model.Whisper,
                 name: str = "custom"):
        self.dims = dims
        self.module = module
        self.name = name
        self._decoders: Dict[torch.dtype, _model.TextDecoder] = {}
        self._task_cache: Dict = {}

    @classmethod
    def from_state_dict(cls, state_dict: Dict[str, torch.Tensor], dims: ModelDimensions,
                        device: Union[str, torch.device] = "cuda",
                        name: str = "custom") -> "WhisperModel":
        """The model on ``device``: the card unless the caller asks for the
        CPU."""
        with torch.device("meta"):
            module = _model.Whisper(dims)
        module.load_state_dict(state_dict, strict=True, assign=True)
        module = module.to(device).eval().requires_grad_(False)
        return cls(dims, module, name=name)

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

    def decode(self, mel, options=None, **kwargs):
        from .. import decode as _decode

        options = options or _decode.DecodingOptions()
        return _decode.decode(self, mel, options, **kwargs)

    def detect_language(self, mel, tokenizer=None):
        from ..decode import detect_language as _dl

        return _dl(self, mel, tokenizer)
