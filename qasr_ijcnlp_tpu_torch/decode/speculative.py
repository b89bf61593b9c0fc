"""Speculative greedy decoding: a draft proposes, the target verifies, and
the tokens equal the target's own greedy decode.

Port of ``qasr_ijcnlp_tpu/decode/speculative.py``.  Each round the draft
proposes ``gamma`` tokens (single-token steps, then one more step that only
fills its cache with the last proposal), or, with no draft model,
:func:`_lookup_propose` copies them from the row's own history; the target
then runs ONE decoder step over the slab [anchor, proposals] of width
gamma + 1, and :func:`_verify_chain` commits the filtered argmax of each
slab position while the proposals match it, and the correction (or bonus)
token at the first mismatch.  Between 1 and gamma + 1 tokens commit per
round and row.  The next token is always the filtered argmax of the
target's logits under the same filter-state progression as the greedy
loop, so a wrong proposal costs time, never a different token.

Both models keep fixed-size caches with per-row write positions
(``decoder_step(offsets=...)``): rows accept different numbers of
proposals, and a rewind is a smaller offset.  The round loop runs on the
host, as the port's greedy loop does; the per-row state (committed count,
finished, filter state, token buffer, offsets) stays on the device, and the
host reads one value per round: the loop's exit predicate, which the JAX
``while_loop`` evaluates once per round as well.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..models import whisper as model
from .filters import apply_filters
from .loop import LoopConfig, _prompt_pass


def _check_events(events, device: torch.device):
    if events is not None and device.type != "cuda":
        raise ValueError("events are CUDA events: pass them only for a decode on the card")


def _mark(events):
    if events is None:
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _argmax_commit(cfg: LoopConfig, logits, cur, last, prev, max_ts):
    """Filtered argmax and its log-probability (the greedy loop's gather
    plus row logsumexp)."""
    filtered = apply_filters(cfg.filters, logits, cur, last, prev, max_ts)
    tok = filtered.argmax(-1)
    f32 = filtered.float()
    m32 = f32.amax(-1)
    lse = m32 + torch.log(torch.exp(f32 - m32[:, None]).sum(-1))
    return tok, f32.gather(1, tok[:, None])[:, 0] - lse


def _set_at(buf, idx, val):
    """buf[b, idx[b]] = val[b] for every row b, in place."""
    buf.scatter_(1, idx[:, None], val[:, None])


def _prefix_state(cfg: LoopConfig, t_logits, initial_tokens):
    """Token buffer and filter state after committing the first sampled
    token (the greedy loop's first step on the prompt logits): (buf,
    n_com, finished, sum_lp, last, prev, max_ts)."""
    B = initial_tokens.shape[0]
    dev = t_logits.device
    buf = torch.full((B, cfg.dims.n_text_ctx + 1), cfg.eot, dtype=torch.long, device=dev)
    buf[:, : cfg.sample_begin] = initial_tokens
    neg1 = torch.full((B,), -1, dtype=torch.long, device=dev)
    zero = torch.zeros(B, dtype=torch.long, device=dev)
    tok0, lp0 = _argmax_commit(cfg, t_logits.float(), cfg.sample_begin, neg1, neg1, zero)
    buf[:, cfg.sample_begin] = tok0
    n_com = torch.full((B,), cfg.sample_begin + 1, dtype=torch.long, device=dev)
    max_ts = torch.where(tok0 >= cfg.timestamp_begin, tok0, zero)
    return buf, n_com, tok0 == cfg.eot, lp0, tok0, neg1, max_ts


def _verify_chain(cfg: LoopConfig, T_logits, props: List[torch.Tensor], buf, n_com,
                  finished, sum_lp, last, prev, max_ts):
    """Commit filtered argmaxes along the slab while the proposals match.

    T_logits[:, j] is conditioned on slab[:, :j + 1], a valid next-token
    distribution only while every proposal before it was committed (``ok``).
    The filter state advances per committed token.  Updates ``buf`` in
    place; returns (buf, cur, finished, sum_lp, last, prev, max_ts)."""
    n_ctx = cfg.dims.n_text_ctx
    ok = torch.ones_like(finished)
    cur = n_com
    for j in range(len(props) + 1):
        active = (cur - cfg.sample_begin < cfg.sample_len) & (cur <= n_ctx)
        e, lp = _argmax_commit(cfg, T_logits[:, j].float(), cur, last, prev, max_ts)
        commit = ok & ~finished & active
        sum_lp = sum_lp + lp * commit
        at = cur.clamp_max(n_ctx)
        _set_at(buf, at, torch.where(commit, e, buf.gather(1, at[:, None])[:, 0]))
        finished = finished | (commit & (e == cfg.eot))
        prev = torch.where(commit, last, prev)
        last = torch.where(commit, e, last)
        max_ts = torch.where(commit & (e >= cfg.timestamp_begin), torch.maximum(max_ts, e),
                             max_ts)
        cur = cur + commit
        ok = commit & (props[j] == e) if j < len(props) else torch.zeros_like(ok)
    return buf, cur, finished, sum_lp, last, prev, max_ts


def _lookup_propose(buf, f, anchor, prev, gamma: int) -> List[torch.Tensor]:
    """Model-free draft ("prompt lookup"): the ``gamma`` tokens that
    followed the latest earlier occurrence of the (prev, anchor) bigram in
    the row's own buffer before position ``f``, else of the anchor alone,
    else the anchor repeated."""
    B, W = buf.shape
    idxs = torch.arange(W, device=buf.device)
    valid = idxs[None, :] < f[:, None]
    eq_a = (buf == anchor[:, None]) & valid
    prev_col = torch.cat([torch.full((B, 1), -1, dtype=buf.dtype, device=buf.device),
                          buf[:, :-1]], 1)
    eq_big = eq_a & (prev_col == prev[:, None])

    def latest(m):
        return torch.where(m, idxs[None, :], torch.full_like(buf, -1)).amax(1)

    jb, ju = latest(eq_big), latest(eq_a)
    j = torch.where(jb >= 0, jb, ju)
    found = j >= 0
    start = torch.where(found, j + 1, torch.zeros_like(j))
    return [torch.where(found, buf.gather(1, (start + t).clamp_max(W - 1)[:, None])[:, 0],
                        anchor)
            for t in range(gamma)]


def _live(cfg: LoopConfig, n_com, finished):
    return ~finished & (n_com - cfg.sample_begin < cfg.sample_len) & (
        n_com <= cfg.dims.n_text_ctx)


def _rounds(cfg: LoopConfig, state, round_fn) -> Tuple[tuple, int]:
    """The JAX ``while_loop``: ``round_fn`` while any row is live and fewer
    than sample_len rounds ran (every live round commits a token per live
    row, so the bound only backs the predicate up).  One host read per
    round."""
    rounds = 0
    while rounds < cfg.sample_len and bool(_live(cfg, state[1], state[2]).any()):
        state = round_fn(state)
        rounds += 1
    return state, rounds


def spec_greedy_decode(
    decoder_t, decoder_d, cfg: LoopConfig, cfg_draft: LoopConfig,
    xa_t: torch.Tensor, xa_d: torch.Tensor, initial_tokens: torch.Tensor,
    gamma: int = 4, cross_decoder=None, events=None,
):
    """Speculative greedy decode with a draft model.  ``xa_t`` / ``xa_d``:
    each model's encoder output for the same audio; ``cross_decoder``: the
    target's fp32 decoder for an int8 cross cache (``cfg.kv_int8``; the
    draft's cache is fp).  ``events``: a list to which each round appends
    its (start, drafted, verified) CUDA events, so draft and verify time
    can be read afterwards without a host sync inside the loop (card
    only).  Returns (tokens_buf (B, reach), final_len (B,), sum_logprobs,
    no_speech_probs, rounds): ``greedy_decode``'s values plus the number
    of verify rounds."""
    _check_events(events, xa_t.device)
    dt, dt_d = cfg.compute_dtype, cfg_draft.compute_dtype
    k = gamma + 1
    # A slab anchored on the last in-budget token writes K/V up to gamma
    # positions past it: lend the cache the slab width where it is larger.
    cache_t, t_logits, no_speech = _prompt_pass(
        decoder_t, cfg._replace(unroll=max(cfg.unroll, k)), xa_t, initial_tokens,
        cross_decoder)
    cache_d, _, _ = _prompt_pass(
        decoder_d, cfg_draft._replace(unroll=max(cfg_draft.unroll, k)), xa_d,
        initial_tokens)
    buf, n_com, finished, sum_lp, last, prev, max_ts = _prefix_state(
        cfg, t_logits, initial_tokens)

    def round_fn(state):
        buf, n_com, finished, sum_lp, last, prev, max_ts, cache_t, cache_d = state
        e0 = _mark(events)
        f = n_com - 1  # both caches hold the committed prefix but its last token
        anchor = buf.gather(1, f[:, None])[:, 0]
        tok, d_last, d_prev, d_max, d_cur = anchor, last, prev, max_ts, n_com
        props = []
        for j in range(gamma):
            d_logits, cache_d = model.decoder_step(
                decoder_d, tok[:, None], cache_d, cfg_draft.dims, dt_d, offsets=f + j)
            p, _ = _argmax_commit(cfg_draft, d_logits[:, 0].float(), d_cur, d_last,
                                  d_prev, d_max)
            props.append(p)
            d_prev, d_last = d_last, p
            d_max = torch.where(p >= cfg.timestamp_begin, torch.maximum(d_max, p), d_max)
            d_cur = d_cur + 1
            tok = p
        # The last proposal's K/V, so the draft cache covers f + gamma.
        _, cache_d = model.decoder_step(
            decoder_d, tok[:, None], cache_d, cfg_draft.dims, dt_d, offsets=f + gamma)
        slab = torch.stack([anchor] + props, 1)
        e1 = _mark(events)
        T_logits, cache_t = model.decoder_step(decoder_t, slab, cache_t, cfg.dims, dt,
                                               offsets=f)
        out = _verify_chain(cfg, T_logits, props, buf, n_com, finished, sum_lp, last,
                            prev, max_ts)
        if events is not None:
            events.append((e0, e1, _mark(events)))
        return (*out, cache_t, cache_d)

    state, rounds = _rounds(
        cfg, (buf, n_com, finished, sum_lp, last, prev, max_ts, cache_t, cache_d),
        round_fn)
    reach = min(cfg.sample_begin + cfg.sample_len + 1, cfg.dims.n_text_ctx + 1)
    return state[0][:, :reach], state[1], state[3], no_speech, rounds


def lookup_greedy_decode(
    decoder_t, cfg: LoopConfig, xa_t: torch.Tensor, initial_tokens: torch.Tensor,
    gamma: int = 4, cross_decoder=None, events=None,
):
    """Speculative greedy decode with no draft model: proposals from
    :func:`_lookup_propose` over the row's own tokens, verified as in
    :func:`spec_greedy_decode`, whose ``events`` it takes and whose values
    it returns."""
    _check_events(events, xa_t.device)
    k = gamma + 1
    cache_t, t_logits, no_speech = _prompt_pass(
        decoder_t, cfg._replace(unroll=max(cfg.unroll, k)), xa_t, initial_tokens,
        cross_decoder)
    buf, n_com, finished, sum_lp, last, prev, max_ts = _prefix_state(
        cfg, t_logits, initial_tokens)

    def round_fn(state):
        buf, n_com, finished, sum_lp, last, prev, max_ts, cache_t = state
        e0 = _mark(events)
        f = n_com - 1
        anchor = buf.gather(1, f[:, None])[:, 0]
        props = _lookup_propose(buf, f, anchor, prev, gamma)
        slab = torch.stack([anchor] + props, 1)
        e1 = _mark(events)
        T_logits, cache_t = model.decoder_step(decoder_t, slab, cache_t, cfg.dims,
                                               cfg.compute_dtype, offsets=f)
        out = _verify_chain(cfg, T_logits, props, buf, n_com, finished, sum_lp, last,
                            prev, max_ts)
        if events is not None:
            events.append((e0, e1, _mark(events)))
        return (*out, cache_t)

    state, rounds = _rounds(
        cfg, (buf, n_com, finished, sum_lp, last, prev, max_ts, cache_t), round_fn)
    reach = min(cfg.sample_begin + cfg.sample_len + 1, cfg.dims.n_text_ctx + 1)
    return state[0][:, :reach], state[1], state[3], no_speech, rounds
