"""Greedy / temperature-sampling decode loop.

Port of ``qasr_ijcnlp_tpu/decode/loop.py`` ``greedy_decode``.  The JAX loop
is one ``lax.while_loop`` under ``jit``; here it is a Python loop over
:func:`..models.whisper.decoder_step` with device-resident token buffer,
scores and filter state.  The only host read inside the loop is the
all-finished check, made every ``unroll`` steps to bound host syncs (the
JAX loop checks its exit predicate at the same granularity).

Two options change the kernels the loop runs, as in the reference:
``LoopConfig.kv_int8`` stores the cross K/V as int8 (the int8 attention
kernel K9 in every step), and the opt-in fused step
(``ops.decoder_step.set_fused_decoder_step(True)``) replaces every
single-token step by one fused kernel launch per decoder layer (K10) where
``fused_cache_applicable`` admits the cache; the prompt pass stays on the
unfused ``decoder_step``.  Beam search is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models import whisper as model
from ..models.dims import ModelDimensions
from ..ops import round_up
from ..ops.decoder_step import (
    fused_cache_applicable, fused_decoder_step, fused_step_enabled, to_fused_cache,
)
from .filters import FilterConfig, apply_filters


class LoopConfig(NamedTuple):
    dims: ModelDimensions
    filters: FilterConfig
    sample_begin: int  # == len(initial_tokens)
    sot_index: int
    sample_len: int
    eot: int
    timestamp_begin: int
    no_speech: Optional[int]
    compute_dtype: torch.dtype = torch.float32
    # Store the cross K/V int8-quantized (ops/decode_attn.py); opt-in, not
    # fp-token-exact.
    kv_int8: bool = False
    # Steps between host checks of the all-finished exit.
    unroll: int = 4


def _prompt_pass(decoder, cfg: LoopConfig, audio_features, initial_tokens,
                 cross_decoder=None):
    """Encoder features -> cross K/V + prompt logits + no-speech probs.

    The self cache is bounded to the reachable length (prompt + samples +
    the unroll overshoot of the JAX loop), rounded up to 16, as in the
    reference: every step reads the whole buffer.  The cross K/V are
    projected with ``cross_decoder`` (default ``decoder``), which must hold
    fp32 weights when ``cfg.kv_int8``."""
    B = initial_tokens.shape[0]
    reach = cfg.sample_begin + cfg.sample_len + cfg.unroll + 1
    ctx = min(cfg.dims.n_text_ctx, round_up(reach, 16))
    cache = model.init_kv_cache(
        cfg.dims, B, cfg.compute_dtype, audio_features.device,
        cross_batch=audio_features.shape[0], ctx=ctx, cross_int8=cfg.kv_int8,
    )
    cache = model.precompute_cross_kv(
        cross_decoder if cross_decoder is not None else decoder, audio_features,
        cache, n_head=cfg.dims.n_text_head,
    )
    logits_all, cache = model.decoder_step(
        decoder, initial_tokens, cache, cfg.dims, cfg.compute_dtype
    )
    if cfg.no_speech is not None:
        probs_at_sot = torch.softmax(logits_all[:, cfg.sot_index].float(), dim=-1)
        no_speech_probs = probs_at_sot[:, cfg.no_speech]
    else:
        no_speech_probs = torch.full((B,), float("nan"), device=logits_all.device)
    return cache, logits_all[:, -1], no_speech_probs


def greedy_decode(
    decoder,
    cfg: LoopConfig,
    audio_features: torch.Tensor,  # (B, Ta, D)
    initial_tokens: torch.Tensor,  # (B, sample_begin) int64
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    cross_decoder=None,
) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """Returns (tokens_buf (B, reach), final_len, sum_logprobs (B,),
    no_speech_probs (B,)), all on the decode device.  ``cross_decoder``
    holds the fp32 weights the int8 cross K/V are projected with
    (``cfg.kv_int8``; default ``decoder``)."""
    B = initial_tokens.shape[0]
    n_ctx = cfg.dims.n_text_ctx
    eot = cfg.eot
    dev = audio_features.device

    cache, logits, no_speech_probs = _prompt_pass(
        decoder, cfg, audio_features, initial_tokens, cross_decoder
    )
    # The opt-in fused step (the reference's decode/loop.py gate): read when
    # the loop starts, and only for a cache the kernel takes.
    if fused_step_enabled() and fused_cache_applicable(cache, cfg.dims, B):
        cache = to_fused_cache(cache, cfg.dims)
        step_fn = fused_decoder_step
    else:
        step_fn = model.decoder_step
    buf = torch.full((B, n_ctx + 1), eot, dtype=torch.long, device=dev)
    buf[:, : cfg.sample_begin] = initial_tokens
    cur_len = cfg.sample_begin
    sum_logprobs = torch.zeros(B, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    last = torch.full((B,), -1, dtype=torch.long, device=dev)
    prev = torch.full((B,), -1, dtype=torch.long, device=dev)
    max_ts = torch.zeros(B, dtype=torch.long, device=dev)

    for i in range(cfg.sample_len):
        if cur_len > n_ctx:
            break
        if i and i % cfg.unroll == 0 and bool(finished.all()):
            break
        filtered = apply_filters(cfg.filters, logits, cur_len, last, prev, max_ts)
        if temperature == 0:
            next_tok = filtered.argmax(-1)
        else:
            probs = torch.softmax(filtered.float() / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        # Only the chosen token's logprob is needed: gather + row logsumexp.
        f32 = filtered.float()
        m32 = f32.amax(-1)
        lse = m32 + torch.log(torch.exp(f32 - m32[:, None]).sum(-1))
        cur_lp = f32.gather(1, next_tok[:, None])[:, 0] - lse
        commit = ~finished
        sum_logprobs = sum_logprobs + cur_lp * commit
        next_tok = torch.where(commit, next_tok, torch.full_like(next_tok, eot))
        buf[:, cur_len] = next_tok
        finished = finished | (next_tok == eot)
        prev, last = last, next_tok
        max_ts = torch.where(next_tok >= cfg.timestamp_begin,
                             torch.maximum(max_ts, next_tok), max_ts)
        cur_len += 1
        if i + 1 < cfg.sample_len and cur_len <= n_ctx:
            step_logits, cache = step_fn(
                decoder, next_tok[:, None], cache, cfg.dims, cfg.compute_dtype
            )
            logits = step_logits[:, 0]

    reach = min(cfg.sample_begin + cfg.sample_len + 1, n_ctx + 1)
    return buf[:, :reach], cur_len, sum_logprobs, no_speech_probs
