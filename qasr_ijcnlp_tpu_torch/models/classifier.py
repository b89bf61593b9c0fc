"""Speech-command classification head: encoder -> mean-pool -> Linear.

Port of ``qasr_ijcnlp_tpu/models/classifier.py``: the mean over the 1500
encoder frames, then one Linear to ``num_classes`` logits.
"""

from __future__ import annotations

import torch
from torch import nn

from .asr import _init_linear_


def init_classifier_head(generator: torch.Generator, enc_dim: int,
                         num_classes: int) -> nn.Linear:
    """The head on the CPU: torch's default Linear distribution, drawn from
    ``generator``."""
    return _init_linear_(nn.Linear(enc_dim, num_classes), generator)


def classifier_apply(head: nn.Linear, audio_emb):
    """(B, Ta, D) encoder output -> (B, num_classes) logits."""
    pooled = audio_emb.mean(dim=1)
    pooled = pooled.to(torch.promote_types(pooled.dtype, head.weight.dtype))
    return pooled @ head.weight.t() + head.bias
