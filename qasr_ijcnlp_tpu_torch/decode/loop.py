"""Greedy / temperature-sampling and beam-search decode loops.

Port of ``qasr_ijcnlp_tpu/decode/loop.py`` ``greedy_decode`` and
``beam_decode``.  The JAX loops are ``lax.while_loop``s under ``jit``; here
they are Python loops over :func:`..models.whisper.decoder_step` with
device-resident token buffers, scores and filter state.  The only host read
inside a loop is its exit check, made every ``unroll`` steps to bound host
syncs.  Greedy rows that finished commit eot, so the steps past the exit
change nothing.  Beam search has no such fixed point (with ``patience`` < 1
the finished set is topped up from the live beams), so its exit predicate is
also evaluated on the device before every step, as the JAX loop's
``lax.cond`` does, and a step taken after it turned false commits nothing.

Both loops take hypothesis rows in groups of G (beam size, best-of count)
over audio features of one row per audio (group-major, row i G + g): the
cross cache is stored once per audio and never repeated.

Two options change the kernels the loop runs, as in the reference:
``LoopConfig.kv_int8`` stores the cross K/V as int8 (the int8 attention
kernel K9 in every step), and the opt-in fused step
(``ops.decoder_step.set_fused_decoder_step(True)``) replaces every
single-token step by one fused kernel launch per decoder layer (K10) where
``fused_cache_applicable`` admits the cache and no mesh is pinned
(``LoopConfig.mesh``, the reference's rule); the prompt pass stays on the
unfused ``decoder_step``.  That gate refuses a grouped cache, so beam and
best-of decode never run K10.

:func:`greedy_decode_program` is the JAX package's ``_greedy_decode_jit``
(``sample=False, encode=True``) as one traceable function, for
``torch.export`` (``export.py``): the encoder, the prompt pass and a
device-side ``while_loop`` whose body takes ``unroll`` tokens, with no host
read.  It never takes the fused step, as JAX's export never does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch._higher_order_ops import while_loop

from ..models import whisper as model
from ..models.dims import ModelDimensions
from ..ops import round_up
from ..ops.decoder_step import (
    fused_cache_applicable, fused_decoder_step, fused_step_enabled, to_fused_cache,
)
from ..profiling import count, span
from .filters import FilterConfig, _log_softmax, _masks, apply_filters


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
    # The mesh (``parallel.Mesh``) the encoder runs on; with one the fused
    # step (K10) is off, as in the reference.
    mesh: Optional[object] = None


def _prompt_pass(decoder, cfg: LoopConfig, audio_features, initial_tokens,
                 cross_decoder=None, ctx: Optional[int] = None):
    """Encoder features -> cross K/V + prompt logits + no-speech probs.

    The self cache is bounded to the reachable length (prompt + samples +
    the unroll overshoot of the JAX loop), rounded up to 16, as in the
    reference: every step reads the whole buffer; ``ctx`` overrides it (the
    decode engine sizes its pool once).  The cross K/V are projected with
    ``cross_decoder`` (default ``decoder``), which must hold fp32 weights
    when ``cfg.kv_int8``."""
    B = initial_tokens.shape[0]
    if ctx is None:
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
    audio_features: torch.Tensor,  # (B_audio, Ta, D)
    initial_tokens: torch.Tensor,  # (B_audio * G, sample_begin) int64
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

    with span("decode.prompt"):
        cache, logits, no_speech_probs = _prompt_pass(
            decoder, cfg, audio_features, initial_tokens, cross_decoder
        )
    with span("decode.loop"):
        # The opt-in fused step (the reference's decode/loop.py gate): read when
        # the loop starts, and only for a cache the kernel takes.
        if (fused_step_enabled() and cfg.mesh is None
                and fused_cache_applicable(cache, cfg.dims, B)):
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
                count("decode.token_steps")
                step_logits, cache = step_fn(
                    decoder, next_tok[:, None], cache, cfg.dims, cfg.compute_dtype
                )
                logits = step_logits[:, 0]

    reach = min(cfg.sample_begin + cfg.sample_len + 1, n_ctx + 1)
    return buf[:, :reach], cur_len, sum_logprobs, no_speech_probs


def _encode_audio(encoder, mel, cfg: LoopConfig):
    """The encoder inside the greedy program (JAX ``_encode_audio``): the
    quantum or classical variant by the encoder's own stem."""
    return model.dispatch_encoder_apply(encoder, mel, cfg.dims, cfg.compute_dtype)


def greedy_decode_program(
    encoder,
    decoder,
    cfg: LoopConfig,
    mel: torch.Tensor,  # (B, n_mels, 2 n_audio_ctx)
    initial_tokens: torch.Tensor,  # (B, sample_begin) int64
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy decode of ``mel`` in one traceable function: returns
    (tokens_buf (B, reach), cur_len (0-d), sum_logprobs (B,),
    no_speech_probs (B,)), meaning what JAX's ``_greedy_decode_jit`` returns.

    The loop is ``torch._higher_order_ops.while_loop`` with JAX's exit:
    steps left, some row unfinished, context left.  Its body takes
    ``cfg.unroll`` tokens; a token past ``sample_len`` or the context inside
    a body commits nothing, and ``cur_len`` advances by ``unroll`` a body,
    so the final ``cur_len`` is JAX's.  Positions are the 0-d tensor
    ``cur_len``, through ``decoder_step``'s per-row path.  The body may not
    write its carried inputs in place, so it works on a copy of the self
    cache (ctx rows a layer) and writes the buffer with ``torch.where``,
    which, as JAX's scatter, drops a write past the last column."""
    B = initial_tokens.shape[0]
    n_ctx = cfg.dims.n_text_ctx
    eot = cfg.eot
    dev = mel.device
    L = cfg.dims.n_text_layer

    audio_features = _encode_audio(encoder, mel, cfg)
    cache, logits, no_speech_probs = _prompt_pass(decoder, cfg, audio_features, initial_tokens)
    cross = {k: cache[k] for k in ("cross_k", "cross_v")}
    masks = _masks(cfg.filters, dev)
    W = n_ctx + 1
    cols = torch.arange(W, device=dev)
    buf = torch.full((B, W), eot, dtype=torch.long, device=dev)
    buf[:, : cfg.sample_begin] = initial_tokens
    state = (
        torch.zeros((), dtype=torch.long, device=dev),  # i
        torch.full((), cfg.sample_begin, dtype=torch.long, device=dev),  # cur_len
        buf,
        torch.zeros(B, device=dev),  # sum_logprobs
        torch.zeros(B, dtype=torch.bool, device=dev),  # finished
        logits.clone(memory_format=torch.contiguous_format),  # fresh strides at B = 1 too
        torch.full((B,), -1, dtype=torch.long, device=dev),  # last
        torch.full((B,), -1, dtype=torch.long, device=dev),  # prev
        torch.zeros(B, dtype=torch.long, device=dev),  # max_ts
        *cache["self_k"], *cache["self_v"],
    )

    def cond(i, cur_len, buf, sum_lp, finished, *rest):
        return (i < cfg.sample_len) & ~finished.all() & (cur_len <= n_ctx)

    def body(i, cur_len, buf, sum_lp, finished, logits, last, prev, max_ts, *kv):
        kv = [t.clone() for t in kv]
        cache_j = {**cross, "self_k": kv[:L], "self_v": kv[L:], "idx": 0}
        for j in range(cfg.unroll):
            active = ((i + j) < cfg.sample_len) & (cur_len <= n_ctx)
            rows = cur_len.expand(B)
            filtered = apply_filters(cfg.filters, logits, rows, last, prev, max_ts, masks)
            next_tok = filtered.argmax(-1)
            f32 = filtered.float()
            m32 = f32.amax(-1)
            lse = m32 + torch.log(torch.exp(f32 - m32[:, None]).sum(-1))
            cur_lp = f32.gather(1, next_tok[:, None])[:, 0] - lse
            commit = ~finished & active
            sum_lp = sum_lp + cur_lp * commit
            next_tok = torch.where(commit, next_tok, torch.full_like(next_tok, eot))
            buf = torch.where(cols[None, :] == cur_len, next_tok[:, None], buf)
            finished = finished | (next_tok == eot)
            prev, last = last, next_tok
            max_ts = torch.where(next_tok >= cfg.timestamp_begin,
                                 torch.maximum(max_ts, next_tok), max_ts)
            step_logits, cache_j = model.decoder_step(
                decoder, next_tok[:, None], cache_j, cfg.dims, cfg.compute_dtype,
                offsets=rows)
            logits = step_logits[:, 0].clone(memory_format=torch.contiguous_format)
            cur_len = cur_len + 1
        return (i + cfg.unroll, cur_len, buf, sum_lp, finished, logits, last, prev, max_ts,
                *cache_j["self_k"], *cache_j["self_v"])

    _, cur_len, buf, sum_lp, *_ = while_loop(cond, body, state)
    reach = min(cfg.sample_begin + cfg.sample_len + 1, n_ctx + 1)
    return buf[:, :reach], cur_len, sum_lp, no_speech_probs


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last dim: the k largest, equal values in
    index order (``torch.topk`` promises no order among ties, and CPU and
    CUDA break them differently; beams start at -inf and suppressed tokens
    are -inf, so ties are common)."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


class BeamState(NamedTuple):
    buf: torch.Tensor  # (B K, W) tokens
    sum_logprobs: torch.Tensor  # (B K,)
    fin_toks: torch.Tensor  # (B, C, W)
    fin_scores: torch.Tensor  # (B, C)
    fin_count: torch.Tensor  # (B,)
    last: torch.Tensor  # (B K,) filter state
    prev: torch.Tensor
    max_ts: torch.Tensor


def beam_transition(cfg: LoopConfig, K: int, C: int, logits: torch.Tensor,
                    cur_len, st: BeamState):
    """One beam-search selection step over B groups of K rows (JAX
    ``_beam_transition``; reference BeamSearchDecoder.update).  ``logits``
    (B K, V) are the decoder outputs for the tokens at ``cur_len - 1``;
    ``cur_len`` is a host int (every group at one position, the batch beam
    loop) or a (B K,) tensor constant within each group (the decode
    engine's beam pool, each group at its own position).  Returns (the new
    state, ``flat_src`` (B K,): the parent row of each new row, for the
    caller's self-cache gather, and the (B K,) tokens just written at
    ``cur_len``)."""
    BK = logits.shape[0]
    B = BK // K
    eot = cfg.eot
    dev = logits.device
    buf = st.buf
    W = buf.shape[1]

    filtered = apply_filters(cfg.filters, logits, cur_len, st.last, st.prev, st.max_ts)
    cand = st.sum_logprobs[:, None] + _log_softmax(filtered)  # (BK, V)
    top_lp, top_id = _top_k(cand, K + 1)
    top_lp = top_lp.reshape(B, K * (K + 1))
    top_id = top_id.reshape(B, K * (K + 1))
    parent = torch.arange(K, device=dev).repeat_interleave(K + 1).expand(B, -1)

    # jnp.argsort is stable: equal scores keep their candidate order.
    order = torch.sort(-top_lp, dim=-1, stable=True).indices
    s_lp = top_lp.gather(1, order)
    s_id = top_id.gather(1, order)
    s_parent = parent.gather(1, order)
    s_eot = s_id == eot

    # The reference's scan: walk candidates in score order, eot to the
    # finished set, others to the next beams, until K non-eot are saved.
    noneot = (~s_eot).long()
    noneot_excl = noneot.cumsum(-1) - noneot
    processed = noneot_excl < K

    # The K continuing beams: candidate -> slot (K = dropped).  Every slot is
    # filled: a beam's K + 1 candidates hold at most one eot.
    slot = torch.where(~s_eot & processed, noneot_excl, torch.full_like(noneot_excl, K))

    def scatter(vals, fill):
        out = torch.full((B, K + 1), fill, dtype=vals.dtype, device=dev)
        return out.scatter_(1, slot, vals)[:, :K]

    new_lp = scatter(s_lp, float("-inf"))
    new_tok = scatter(s_id, eot).reshape(-1)
    new_parent = scatter(s_parent, 0)

    flat_src = (torch.arange(B, device=dev)[:, None] * K + new_parent).reshape(-1)
    new_buf = buf[flat_src]
    per_row = isinstance(cur_len, torch.Tensor)
    if per_row:  # group-constant, so invariant under the parent gather
        new_buf.scatter_(1, cur_len[:, None], new_tok[:, None])
    else:
        new_buf[:, cur_len] = new_tok
    prev = st.last[flat_src]
    max_ts = st.max_ts[flat_src]
    max_ts = torch.where(new_tok >= cfg.timestamp_begin, torch.maximum(max_ts, new_tok), max_ts)

    # Finished candidates, bounded by C: a running rank per audio gives each
    # eligible one its own slot; the rest go to slot C, which is dropped.
    elig = (s_eot & processed).long()
    dest = st.fin_count[:, None] + elig.cumsum(-1) - elig
    dest = torch.where((elig == 1) & (dest < C), dest, torch.full_like(dest, C))
    # each candidate's parent prefix, (B, K(K+1), W)
    cand_bufs = buf.reshape(B, K, W)[torch.arange(B, device=dev)[:, None], s_parent]
    if per_row:
        cur_g = cur_len.reshape(B, K)[:, 0]
        cand_bufs.scatter_(2, cur_g[:, None, None].expand(B, cand_bufs.shape[1], 1), eot)
    else:
        cand_bufs[:, :, cur_len] = eot
    fin_toks = torch.cat([st.fin_toks, st.fin_toks.new_zeros(B, 1, W)], 1)
    fin_toks = fin_toks.scatter_(1, dest[:, :, None].expand(-1, -1, W), cand_bufs)[:, :C]
    fin_scores = torch.cat([st.fin_scores, st.fin_scores.new_zeros(B, 1)], 1)
    fin_scores = fin_scores.scatter_(1, dest, s_lp)[:, :C]
    fin_count = torch.clamp_max(st.fin_count + elig.sum(-1), C)

    new = BeamState(new_buf, new_lp.reshape(-1), fin_toks, fin_scores, fin_count,
                    new_tok, prev, max_ts)
    return new, flat_src, new_tok


def beam_decode(
    decoder,
    cfg: LoopConfig,
    audio_features: torch.Tensor,  # (B, Ta, D)
    initial_tokens: torch.Tensor,  # (B K, sample_begin) int64
    beam_size: int,
    max_candidates: int,
    cross_decoder=None,
):
    """Beam search with a bounded finished set of ``max_candidates`` per
    audio.  Returns (beams (B, K, reach), beam_scores (B, K), finished
    tokens (B, C, reach), finished scores (B, C), finished count (B,),
    no_speech_probs (B,)), all on the decode device.

    Exit: the JAX loop's predicate (steps left, not every audio's finished
    set full, context left).  The finished-set clause is read on the device
    before each step and freezes the state when false, and on the host every
    ``unroll`` steps to end the loop.  After the last transition no decoder
    step runs (JAX runs one and never reads it).  After every transition the
    self cache of every layer is gathered to the new rows' parents, into
    fresh buffers; the cross cache, one row per audio, never is."""
    K, C = beam_size, max_candidates
    BK = initial_tokens.shape[0]
    B = BK // K
    n_ctx = cfg.dims.n_text_ctx
    eot = cfg.eot
    dev = audio_features.device

    with span("decode.prompt"):
        cache, logits, no_speech_all = _prompt_pass(
            decoder, cfg, audio_features, initial_tokens, cross_decoder
        )
    with span("decode.loop"):
        buf = torch.full((BK, n_ctx + 1), eot, dtype=torch.long, device=dev)
        buf[:, : cfg.sample_begin] = initial_tokens
        # Only beam 0 of each audio starts live; duplicates would dominate topk.
        start = torch.full((K,), float("-inf"), device=dev)
        start[0] = 0.0
        W = n_ctx + 1
        st = BeamState(
            buf=buf,
            sum_logprobs=start.repeat(B),
            fin_toks=torch.full((B, C, W), eot, dtype=torch.long, device=dev),
            fin_scores=torch.full((B, C), float("-inf"), device=dev),
            fin_count=torch.zeros(B, dtype=torch.long, device=dev),
            last=torch.full((BK,), -1, dtype=torch.long, device=dev),
            prev=torch.full((BK,), -1, dtype=torch.long, device=dev),
            max_ts=torch.zeros(BK, dtype=torch.long, device=dev),
        )
        cur_len = cfg.sample_begin
        for i in range(cfg.sample_len):
            if cur_len > n_ctx:
                break
            if i and i % cfg.unroll == 0 and bool((st.fin_count >= C).all()):
                break
            live = ~(st.fin_count >= C).all()
            new, flat_src, new_tok = beam_transition(cfg, K, C, logits, cur_len, st)
            st = BeamState(*(torch.where(live, a, b) for a, b in zip(new, st)))
            cur_len += 1
            if i + 1 < cfg.sample_len and cur_len <= n_ctx:
                cache = {**cache,
                         "self_k": [k.index_select(0, flat_src) for k in cache["self_k"]],
                         "self_v": [v.index_select(0, flat_src) for v in cache["self_v"]]}
                count("decode.token_steps")
                step_logits, cache = model.decoder_step(
                    decoder, new_tok[:, None], cache, cfg.dims, cfg.compute_dtype
                )
                logits = step_logits[:, 0]

    reach = min(cfg.sample_begin + cfg.sample_len + 1, n_ctx + 1)
    return (st.buf.reshape(B, K, W)[:, :, :reach], st.sum_logprobs.reshape(B, K),
            st.fin_toks[:, :, :reach], st.fin_scores, st.fin_count, no_speech_all[::K])
