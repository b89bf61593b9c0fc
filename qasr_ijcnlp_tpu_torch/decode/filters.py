"""Batched logit filters for the decode loop.

Port of ``qasr_ijcnlp_tpu/decode/filters.py``: the reference's per-row
filters (SuppressBlank, SuppressTokens, ApplyTimestampRules) as batched mask
arithmetic.  The timestamp grammar is derived from per-row state (last and
penultimate sampled token, running max timestamp) instead of re-scanning
each row's history.  ``cur_len`` is a host int where every row sits at
one length (the loops run in Python), or a (B,) tensor of per-row lengths
(speculative decode and the decode engine, where rows commit different
numbers of tokens), as the JAX filters take a scalar or a (B,) array.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = float("-inf")


class FilterConfig(NamedTuple):
    """Static configuration of the filter stack (hashable: masks are bytes,
    one uint8 per vocab entry, nonzero = masked)."""

    n_vocab: int
    sample_begin: int
    eot: int
    timestamp_begin: int  # == n_vocab for no-timestamp models
    no_timestamps: Optional[int]
    suppress_blank: bool
    suppress_mask: Optional[bytes]
    blank_mask: Optional[bytes]  # " " and eot
    apply_timestamp_rules: bool
    max_initial_timestamp_index: Optional[int]


def build_config(
    tokenizer,
    n_vocab: int,
    sample_begin: int,
    suppress_tokens,
    suppress_blank: bool,
    without_timestamps: bool,
    max_initial_timestamp_index: Optional[int],
) -> FilterConfig:
    suppress_mask = None
    if suppress_tokens:
        m = np.zeros(n_vocab, np.uint8)
        m[np.asarray(list(suppress_tokens), np.int64)] = 1
        suppress_mask = m.tobytes()
    blank_mask = None
    if suppress_blank:
        m = np.zeros(n_vocab, np.uint8)
        ids = [t for t in tokenizer.encode(" ") + [tokenizer.eot] if t < n_vocab]
        m[ids] = 1
        blank_mask = m.tobytes()
    return FilterConfig(
        n_vocab=n_vocab,
        sample_begin=sample_begin,
        eot=tokenizer.eot,
        timestamp_begin=min(tokenizer.timestamp_begin, n_vocab),
        no_timestamps=tokenizer.no_timestamps,
        suppress_blank=suppress_blank,
        suppress_mask=suppress_mask,
        blank_mask=blank_mask,
        # With a vocab-truncated head (custom dims only) the "first sampled
        # token must be a timestamp" rule would mask the whole vocab.
        apply_timestamp_rules=(
            not without_timestamps and tokenizer.timestamp_begin < n_vocab
        ),
        max_initial_timestamp_index=max_initial_timestamp_index,
    )


class _Masks(NamedTuple):
    blank: Optional[torch.Tensor]
    suppress: Optional[torch.Tensor]
    vocab_ids: torch.Tensor


@functools.lru_cache(maxsize=32)
def _masks(cfg: FilterConfig, device: torch.device) -> _Masks:
    def mask(b):
        if b is None:
            return None
        return torch.from_numpy(np.frombuffer(b, np.uint8).astype(bool)).to(device)

    return _Masks(mask(cfg.blank_mask), mask(cfg.suppress_mask),
                  torch.arange(cfg.n_vocab, device=device))


def apply_filters(
    cfg: FilterConfig,
    logits: torch.Tensor,  # (B, V) fp32
    cur_len,  # tokens written so far: a host int, or (B,) per row
    last_tok: torch.Tensor,  # (B,) last written token
    prev_tok: torch.Tensor,  # (B,) second-to-last written token
    max_ts: torch.Tensor,  # (B,) running max timestamp token (0 if none)
    masks: Optional[_Masks] = None,
) -> torch.Tensor:
    """``masks``: ``_masks(cfg, device)`` made by the caller (a traced loop
    body, which may not build them)."""
    m = masks if masks is not None else _masks(cfg, logits.device)
    at_begin = cur_len == cfg.sample_begin
    if isinstance(at_begin, torch.Tensor):
        def fill_at_begin(x, vocab_mask):  # per row
            return x.masked_fill(at_begin[:, None] & vocab_mask[None], NEG_INF)
    else:
        def fill_at_begin(x, vocab_mask):
            return x.masked_fill(vocab_mask, NEG_INF) if at_begin else x

    if m.blank is not None:
        logits = fill_at_begin(logits, m.blank)
    if m.suppress is not None:
        logits = logits.masked_fill(m.suppress, NEG_INF)

    if cfg.apply_timestamp_rules:
        ts_begin = cfg.timestamp_begin
        vocab_ids = m.vocab_ids
        is_ts_region = vocab_ids >= ts_begin
        is_text_region = vocab_ids < cfg.eot

        if cfg.no_timestamps is not None:
            logits = logits.clone()
            logits[:, cfg.no_timestamps] = NEG_INF

        n_sampled = cur_len - cfg.sample_begin
        last_was_ts = (last_tok >= ts_begin) & (n_sampled >= 1)
        penult_was_ts = (prev_tok >= ts_begin) | (n_sampled < 2)

        # Timestamps come in pairs: after a lone timestamp the next token
        # must not be a timestamp; after a completed pair it must not be text.
        mask_ts = last_was_ts & penult_was_ts
        mask_text = last_was_ts & ~penult_was_ts
        logits = logits.masked_fill(mask_ts[:, None] & is_ts_region[None], NEG_INF)
        logits = logits.masked_fill(mask_text[:, None] & is_text_region[None], NEG_INF)

        # Monotonic timestamps: nothing below the running max; open segments
        # may repeat the same timestamp, closed ones must advance.
        have_ts = max_ts > 0
        floor = torch.where(mask_text, max_ts, max_ts + 1)
        ts_too_small = is_ts_region[None] & (vocab_ids[None] < floor[:, None])
        logits = logits.masked_fill(have_ts[:, None] & ts_too_small, NEG_INF)

        # The first sampled token must be a timestamp, bounded by max_initial.
        logits = fill_at_begin(logits, vocab_ids < ts_begin)
        if cfg.max_initial_timestamp_index is not None:
            last_allowed = ts_begin + cfg.max_initial_timestamp_index
            logits = fill_at_begin(logits, vocab_ids > last_allowed)

        # If the total timestamp probability beats every text token, force a
        # timestamp.
        logprobs = _log_softmax(logits)
        ts_lse = _masked_logsumexp(logprobs, is_ts_region[None])
        max_text = logprobs.masked_fill(is_ts_region[None], NEG_INF).amax(-1)
        force_ts = ts_lse > max_text
        logits = logits.masked_fill(force_ts[:, None] & ~is_ts_region[None], NEG_INF)

    return logits


def _log_softmax(x):
    # -inf-safe (every row keeps a finite entry); always fp32.
    x = x.float()
    shifted = x - x.amax(-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))


def _masked_logsumexp(logprobs, mask):
    vals = logprobs.masked_fill(~mask, NEG_INF)
    m = vals.amax(-1)
    finite = torch.isfinite(m)
    safe_m = torch.where(finite, m, torch.zeros_like(m))
    e = torch.exp(logprobs - safe_m[:, None])
    s = torch.where(mask, e, torch.zeros_like(e)).sum(-1)
    return torch.where(finite, safe_m + torch.log(s), torch.full_like(m, NEG_INF))
