"""Training steps written out in plain PyTorch: next-token cross-entropy of
the Whisper in :mod:`.whisper` and optax's AdamW after
``clip_by_global_norm``, in float32 with TF32 off.

The loss is the mean over every target of the batch; the gradient is
accumulated over blocks of ``rows`` rows (each block's summed loss divided
by the batch's count), so the batch need not fit at once.  What a step
returns is what the benchmark compares: the loss, each leaf's norm of the
clipped gradient the optimizer takes, and the parameters, updated in place.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .whisper import FP32, Precision, decoder, encoder, exact_fp32


def loss_and_grads(w: Dict[str, torch.Tensor], dims: Dict, mel: torch.Tensor,
                   tokens: torch.Tensor, rows: int, prec: Precision = FP32):
    """(mean next-token CE, {name: gradient}) of a batch, in blocks of rows."""
    names = list(w)
    leaves = [w[n].detach().requires_grad_(True) for n in names]
    params = dict(zip(names, leaves))
    count = tokens[:, 1:].numel()
    total = 0.0
    grads = [torch.zeros_like(t) for t in leaves]
    with exact_fp32():
        for i in range(0, tokens.shape[0], rows):
            m, t = mel[i:i + rows], tokens[i:i + rows]
            logits = decoder(params, t, encoder(params, m, dims, prec), dims, prec)
            ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                 t[:, 1:].reshape(-1), reduction="sum")
            for g, d in zip(grads, torch.autograd.grad(ce / count, leaves)):
                g += d
            total += float(ce.detach())
    return total / count, dict(zip(names, grads))


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps, wd))``."""

    def __init__(self, w: Dict[str, torch.Tensor], lr: float, weight_decay: float, b1: float,
                 b2: float, eps: float, clip_norm: float):
        self.lr, self.wd, self.b1, self.b2, self.eps, self.clip = (
            lr, weight_decay, b1, b2, eps, clip_norm)
        self.mu = {n: torch.zeros_like(t) for n, t in w.items()}
        self.nu = {n: torch.zeros_like(t) for n, t in w.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Update ``w`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        if norm >= self.clip:
            grads = {n: g / norm * self.clip for n, g in grads.items()}
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for n, g in grads.items():
            self.mu[n] = (1 - self.b1) * g + self.b1 * self.mu[n]
            self.nu[n] = (1 - self.b2) * g * g + self.b2 * self.nu[n]
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.eps)
            w[n] -= self.lr * (u + self.wd * w[n])
        return grads


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def reference_steps(w: Dict[str, torch.Tensor], dims: Dict, batches: List, hyper: Dict,
                    rows: int, prec: Precision = FP32) -> Dict:
    """``len(batches)`` steps from the weights ``w`` (updated in place):
    each step's loss, the leaf norms of the first clipped gradient, and the
    leaf norms of the parameters' change over all the steps."""
    start = {n: t.clone() for n, t in w.items()}
    opt = AdamW(w, **hyper)
    losses, first = [], None
    for mel, tokens in batches:
        loss, grads = loss_and_grads(w, dims, mel, tokens, rows, prec)
        clipped = opt.step(w, grads)
        losses.append(loss)
        if first is None:
            first = leaf_norms(clipped)
        del grads, clipped
    change = leaf_norms({n: w[n] - start[n] for n in w})
    return {"losses": losses, "grad_norms": first, "change_norms": change}
