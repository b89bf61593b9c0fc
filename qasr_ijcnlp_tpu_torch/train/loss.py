"""Cross-entropy with ignore-index masking, the evaluation loss.

Port of ``qasr_ijcnlp_tpu/train/loss.py``: the ignore-index is a mask
multiply and the shift is the caller's, so the loss is shape-agnostic.

Under a mesh (``mesh=``, a ``parallel.Mesh``) each data rank holds its own
rows and the mean is the JAX package's over the global batch: every rank
divides its CE sum by the valid count summed over the data ranks, and the
loss is the sum of those shares over the data ranks (``parallel.psum``,
whose backward leaves each rank the gradient of its own share, which the
train step sums).  The mean of the ranks' means would weigh a row by its
rank's count of valid targets, which differs where rows are padded with
the ignore index.
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


def masked_cross_entropy(logits, targets, ignore_index: int = -100, mesh=None):
    """Mean CE over non-ignored positions (an fp32 scalar); logits (B, T,
    V), targets (B, T); with ``mesh``, over every data rank's rows."""
    ce, mask = _masked_ce(logits, targets, ignore_index)
    return global_mean((ce * mask).sum(), mask.sum(), mesh)


def global_mean(total, count, mesh=None):
    """``total / max(count, 1)`` with both summed over the data ranks of
    ``mesh``: each rank's share ``total / count_all`` summed by
    ``parallel.psum`` (the count carries no gradient)."""
    from ..parallel import DATA_AXIS, axis_size, psum

    if axis_size(mesh, DATA_AXIS) == 1:
        return total / count.clamp_min(1.0)
    count = psum(count.detach().float(), mesh, DATA_AXIS)
    return psum(total / count.clamp_min(1.0), mesh, DATA_AXIS)


def masked_cross_entropy_sum(logits, targets, ignore_index: int = -100):
    """(sum of CE over non-ignored positions, count): summing the pairs of
    several batches and dividing at the end gives the mean over all of
    them exactly."""
    ce, mask = _masked_ce(logits, targets, ignore_index)
    return (ce * mask).sum(), mask.sum()


def shifted_token_loss(logits, tokens, ignore_index: int = -100, mesh=None):
    """Next-token CE: logits[:, :-1] predict tokens[:, 1:]."""
    return masked_cross_entropy(logits[:, :-1], tokens[:, 1:], ignore_index, mesh)


def shifted_token_loss_sum(logits, tokens, ignore_index: int = -100):
    """(sum, count) form of :func:`shifted_token_loss`."""
    return masked_cross_entropy_sum(logits[:, :-1], tokens[:, 1:], ignore_index)
