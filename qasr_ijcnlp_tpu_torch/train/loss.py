"""Cross-entropy with ignore-index masking, the evaluation loss.

Port of ``qasr_ijcnlp_tpu/train/loss.py``: the ignore-index is a mask
multiply and the shift is the caller's, so the loss is shape-agnostic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_ce(logits, targets, ignore_index: int):
    mask = (targets != ignore_index).float()
    safe = targets.masked_fill(targets == ignore_index, 0).long()
    V = logits.shape[-1]
    ce = F.cross_entropy(logits.float().reshape(-1, V), safe.reshape(-1), reduction="none")
    return ce.reshape(targets.shape), mask


def masked_cross_entropy(logits, targets, ignore_index: int = -100):
    """Mean CE over non-ignored positions (an fp32 scalar); logits (B, T,
    V), targets (B, T)."""
    ce, mask = _masked_ce(logits, targets, ignore_index)
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


def masked_cross_entropy_sum(logits, targets, ignore_index: int = -100):
    """(sum of CE over non-ignored positions, count): summing the pairs of
    several batches and dividing at the end gives the mean over all of
    them exactly."""
    ce, mask = _masked_ce(logits, targets, ignore_index)
    return (ce * mask).sum(), mask.sum()


def shifted_token_loss(logits, tokens, ignore_index: int = -100):
    """Next-token CE: logits[:, :-1] predict tokens[:, 1:]."""
    return masked_cross_entropy(logits[:, :-1], tokens[:, 1:], ignore_index)


def shifted_token_loss_sum(logits, tokens, ignore_index: int = -100):
    """(sum, count) form of :func:`shifted_token_loss`."""
    return masked_cross_entropy_sum(logits[:, :-1], tokens[:, 1:], ignore_index)
