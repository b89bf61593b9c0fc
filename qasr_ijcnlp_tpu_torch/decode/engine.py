"""Continuous-batching decode engine: a fixed pool of slots on the device.

Port of ``qasr_ijcnlp_tpu/decode/engine.py``.  The micro-batcher
(``serving.BatchingTranscriber``) decodes each batch to its end before the
next starts, so one long utterance holds up every request behind it.  This
engine keeps a pool of ``slots`` rows on the device; each step advances
every occupied slot by ``unroll`` tokens (or ``unroll`` prompt-lookup
rounds of 1 to gamma + 1 tokens), and a worker thread refills finished
slots from the queue while the others are mid-decode.  Each slot sits at
its own position in its own cache rows (``decoder_step(offsets=...)``), so
admission is a scatter of the new requests' cross K/V, prompt cache and
state into free rows.

Each request's tokens equal the plain ``decode`` of that request alone:
greedy pools run the greedy loop's filtered argmax with per-row filter
state; beam pools (``options.beam_size``) run groups of K rows through the
batch loop's ``beam_transition`` and freeze each group on exactly the solo
beam loop's exit predicate.  With ``language=None`` on a multilingual model
admission also detects each request's language (one sot forward).

The state functions build new per-row tensors and the worker keeps them
only when a call returns; admission writes whole rows of free slots and
the greedy steps write each row's self cache in place only at positions
the row will write again.  So a call that raises leaves the pool whole:
the worker fails the requests that call served and goes on serving.

With a ``mesh`` (``parallel.Mesh``) the pool is data-parallel: every rank
of the mesh builds the engine (a collective call), each data rank holds
``slots / n_data`` rows of the pool, and the mesh's leader (rank 0) takes
the requests.  The ranks run in lockstep: each iteration the leader
broadcasts its plan (the requests it admits, each into a free slot of the
global pool, spread over the data ranks, or the stop), every rank admits
the requests that fall in its rows and steps its own rows, and the results
of the rows that finished are gathered to the leader, which answers the
requests.  Lockstep rather than routing each request to a rank's own
queue: one broadcast and one gather an iteration keep every rank's
collectives in one order (a model axis > 1 shards the admission's encoder,
so the ranks of a model group must admit together), and a request's rows
never move.  The collectives run on a fork of the mesh's groups of the
engine's own (``Mesh.fork``), so they never interleave with another
component's.
"""

from __future__ import annotations

import atexit
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels, parallel
from ..audio import wire_log_mel, wire_pcm16
from ..models import whisper as model
from ..ops import round_up
from .loop import BeamState, LoopConfig, _prompt_pass, beam_transition
from .speculative import _argmax_commit, _lookup_propose, _set_at, _verify_chain


class _EngineState(NamedTuple):
    """The greedy slot pool; every tensor's first dim is the slot."""

    self_k: list  # per layer (slots, H, tmax, Dh)
    self_v: list
    cross_k: list  # per layer (slots, H, Ta, Dh) fp, or int8 codes (slots, H, Tp, Dh)
    cross_v: list
    buf: torch.Tensor  # (slots, n_text_ctx + 1) committed tokens, eot-filled tail
    cur: torch.Tensor  # (slots,) committed count, prompt included
    finished: torch.Tensor  # (slots,) bool
    last: torch.Tensor
    prev: torch.Tensor
    max_ts: torch.Tensor
    sum_lp: torch.Tensor
    no_speech: torch.Tensor  # (slots,) captured at admission
    lang: torch.Tensor  # (slots,) detected language token, -1 for a fixed language
    cross_sk: tuple = ()  # int8 pools: per layer (slots, H, Tp) scales
    cross_sv: tuple = ()


class _BeamState(NamedTuple):
    """The beam slot pool: G request groups of K hypothesis rows.  Row
    tensors are (G K, ...) group-major, request tensors (G, ...); the cross
    K/V is stored once per group, as in the batch beam loop."""

    self_k: list  # per layer (G K, H, tmax, Dh)
    self_v: list
    cross_k: list  # per layer (G, H, Ta, Dh)
    cross_v: list
    buf: torch.Tensor  # (G K, W)
    cur: torch.Tensor  # (G,) write position, one per group
    done: torch.Tensor  # (G,) bool: retired or free
    sum_lp: torch.Tensor  # (G K,)
    fin_toks: torch.Tensor  # (G, C, W)
    fin_scores: torch.Tensor  # (G, C)
    fin_count: torch.Tensor  # (G,)
    last: torch.Tensor  # (G K,)
    prev: torch.Tensor
    max_ts: torch.Tensor
    no_speech: torch.Tensor  # (G,)
    lang: torch.Tensor  # (G,)


def _admit_frontend(model_obj, cfg: LoopConfig, payload, init_tokens, scales,
                    audio_frontend: bool, lang_mask, detect: bool):
    """Admission's shared preamble: the log-mel of the dequantized int16
    audio (K1, with ``audio_frontend``), the encoder, and with ``detect``
    each request's language (one sot forward) written into the prompt's
    language slot.  Returns (xa, init_tokens, lang_tok); lang_tok is -1 for
    a fixed language."""
    dims = cfg.dims
    mels = wire_log_mel(payload, scales, dims.n_mels) if audio_frontend else payload
    xa = model.dispatch_encoder_apply(model_obj.module.encoder, mels, dims, cfg.compute_dtype,
                                      mesh=cfg.mesh)
    if not detect:
        return xa, init_tokens, torch.full_like(init_tokens[:, 0], -1)
    sot = init_tokens[:, cfg.sot_index:cfg.sot_index + 1]
    logits = model.decoder_apply(model_obj.decoder_for(cfg.compute_dtype), sot, xa, dims,
                                 cfg.compute_dtype)[:, 0].float()
    lang_tok = logits.masked_fill(~lang_mask, float("-inf")).argmax(-1)
    init_tokens = init_tokens.clone()
    init_tokens[:, cfg.sot_index + 1] = lang_tok
    return xa, init_tokens, lang_tok


def _cache_of(state) -> Dict:
    cache = {"self_k": list(state.self_k), "self_v": list(state.self_v), "idx": 0}
    if getattr(state, "cross_sk", ()):
        cache.update(cross_k8=list(state.cross_k), cross_sk=list(state.cross_sk),
                     cross_v8=list(state.cross_v), cross_sv=list(state.cross_sv))
    else:
        cache.update(cross_k=list(state.cross_k), cross_v=list(state.cross_v))
    return cache


def _engine_step(decoder, cfg: LoopConfig, state: _EngineState, unroll: int,
                 gamma: int = 0) -> _EngineState:
    """Every slot up to ``unroll`` tokens on, or with ``gamma`` by
    ``unroll`` prompt-lookup rounds of 1 to gamma + 1 tokens; finished
    slots commit nothing.  No host read."""
    n_ctx, sb = cfg.dims.n_text_ctx, cfg.sample_begin
    cache = _cache_of(state)
    buf = state.buf.clone()
    cur, finished = state.cur, state.finished
    last, prev, max_ts, sum_lp = state.last, state.prev, state.max_ts, state.sum_lp
    for _ in range(unroll):
        feed_at = (cur - 1).clamp_min(0)
        anchor = buf.gather(1, feed_at[:, None])[:, 0]
        if gamma:
            props = _lookup_propose(buf, feed_at, anchor, prev, gamma)
            logits, cache = model.decoder_step(
                decoder, torch.stack([anchor] + props, 1), cache, cfg.dims,
                cfg.compute_dtype, offsets=feed_at)
            buf, cur, finished, sum_lp, last, prev, max_ts = _verify_chain(
                cfg, logits, props, buf, cur, finished, sum_lp, last, prev, max_ts)
            # out of budget without eot retires too (the greedy loop's exit)
            finished = finished | ~((cur - sb < cfg.sample_len) & (cur <= n_ctx))
            continue
        logits, cache = model.decoder_step(decoder, anchor[:, None], cache, cfg.dims,
                                           cfg.compute_dtype, offsets=feed_at)
        e, lp = _argmax_commit(cfg, logits[:, 0].float(), cur, last, prev, max_ts)
        commit = ~finished & (cur - sb < cfg.sample_len) & (cur <= n_ctx)
        sum_lp = sum_lp + lp * commit
        at = cur.clamp_max(n_ctx)
        _set_at(buf, at, torch.where(commit, e, buf.gather(1, at[:, None])[:, 0]))
        finished = finished | (commit & (e == cfg.eot)) | ~commit
        prev = torch.where(commit, last, prev)
        last = torch.where(commit, e, last)
        max_ts = torch.where(commit & (e >= cfg.timestamp_begin), torch.maximum(max_ts, e),
                             max_ts)
        cur = cur + commit
    return state._replace(buf=buf, cur=cur, finished=finished, last=last, prev=prev,
                          max_ts=max_ts, sum_lp=sum_lp)


def _engine_admit(model_obj, decoder, cross_decoder, cfg: LoopConfig, state: _EngineState,
                  ids: torch.Tensor, payload, init_tokens, tmax: int, scales=None,
                  audio_frontend: bool = False, lang_mask=None, detect: bool = False):
    """Encode and prompt-pass A requests and write them into the distinct
    free slots ``ids`` (A,), in place."""
    xa, init_tokens, lang_tok = _admit_frontend(model_obj, cfg, payload, init_tokens,
                                                scales, audio_frontend, lang_mask, detect)
    sub, last_logits, no_speech = _prompt_pass(decoder, cfg, xa, init_tokens,
                                               cross_decoder, ctx=tmax)
    A, sb = init_tokens.shape
    neg1 = torch.full_like(lang_tok, -1)
    tok0, lp0 = _argmax_commit(cfg, last_logits.float(), sb, neg1, neg1,
                               torch.zeros_like(neg1))
    row = torch.full((A, state.buf.shape[1]), cfg.eot, dtype=torch.long, device=ids.device)
    row[:, :sb] = init_tokens
    row[:, sb] = tok0
    names = [("self_k", "self_k"), ("self_v", "self_v")]
    names += ([("cross_k", "cross_k8"), ("cross_sk", "cross_sk"), ("cross_v", "cross_v8"),
               ("cross_sv", "cross_sv")] if state.cross_sk else
              [("cross_k", "cross_k"), ("cross_v", "cross_v")])
    for pool_name, sub_name in names:
        for big, s in zip(getattr(state, pool_name), sub[sub_name]):
            big.index_copy_(0, ids, s.to(big.dtype))
    state.buf.index_copy_(0, ids, row)
    state.cur.index_fill_(0, ids, sb + 1)
    state.finished.index_copy_(0, ids, tok0 == cfg.eot)
    state.last.index_copy_(0, ids, tok0)
    state.prev.index_fill_(0, ids, -1)
    state.max_ts.index_copy_(0, ids, torch.where(tok0 >= cfg.timestamp_begin, tok0,
                                                 torch.zeros_like(tok0)))
    state.sum_lp.index_copy_(0, ids, lp0)
    state.no_speech.index_copy_(0, ids, no_speech.float())
    state.lang.index_copy_(0, ids, lang_tok)


def _beam_live(cfg: LoopConfig, C: int, cur, fin_count):
    """The solo beam loop's continue predicate per group: freezing each
    group on exactly this makes its result that of decoding it alone."""
    return ((cur - cfg.sample_begin < cfg.sample_len) & (fin_count < C)
            & (cur <= cfg.dims.n_text_ctx))


def _beam_engine_step(decoder, cfg: LoopConfig, state: _BeamState, unroll: int, K: int,
                      C: int) -> _BeamState:
    """Every live group up to ``unroll`` beam transitions on.  Done and
    free groups run through the batched forward and transition too, but
    ``torch.where`` keeps their state and their self-cache gather is the
    identity."""
    cache = _cache_of(state)
    buf, cur, done, sum_lp = state.buf, state.cur, state.done, state.sum_lp
    fin_toks, fin_scores, fin_count = state.fin_toks, state.fin_scores, state.fin_count
    last, prev, max_ts = state.last, state.prev, state.max_ts
    idr = torch.arange(buf.shape[0], device=buf.device)
    for _ in range(unroll):
        may = ~done
        cur_rows = cur.repeat_interleave(K)
        may_rows = may.repeat_interleave(K)
        # Each row's last selected token; its K/V lands at cur - 1 here, one
        # step after its selection, as in the batch loop.
        feed_at = (cur_rows - 1).clamp_min(0)
        logits, cache = model.decoder_step(decoder, buf.gather(1, feed_at[:, None]), cache,
                                           cfg.dims, cfg.compute_dtype, offsets=feed_at)
        new, flat_src, _ = beam_transition(
            cfg, K, C, logits[:, 0], cur_rows,
            BeamState(buf, sum_lp, fin_toks, fin_scores, fin_count, last, prev, max_ts))
        src = torch.where(may_rows, flat_src, idr)
        cache = {**cache, "self_k": [k.index_select(0, src) for k in cache["self_k"]],
                 "self_v": [v.index_select(0, src) for v in cache["self_v"]]}
        rows = may_rows[:, None]
        buf = torch.where(rows, new.buf, buf)
        sum_lp = torch.where(may_rows, new.sum_logprobs, sum_lp)
        last = torch.where(may_rows, new.last, last)
        prev = torch.where(may_rows, new.prev, prev)
        max_ts = torch.where(may_rows, new.max_ts, max_ts)
        fin_toks = torch.where(may[:, None, None], new.fin_toks, fin_toks)
        fin_scores = torch.where(may[:, None], new.fin_scores, fin_scores)
        fin_count = torch.where(may, new.fin_count, fin_count)
        cur = torch.where(may, cur + 1, cur)
        done = done | (may & ~_beam_live(cfg, C, cur, fin_count))
    return state._replace(self_k=cache["self_k"], self_v=cache["self_v"], buf=buf, cur=cur,
                          done=done, sum_lp=sum_lp, fin_toks=fin_toks,
                          fin_scores=fin_scores, fin_count=fin_count, last=last, prev=prev,
                          max_ts=max_ts)


def _beam_admit(model_obj, decoder, cfg: LoopConfig, state: _BeamState, gids: torch.Tensor,
                payload, init_tokens, tmax: int, K: int, C: int, scales=None,
                audio_frontend: bool = False, lang_mask=None, detect: bool = False):
    """Encode and prompt-pass A requests, run their first beam transition
    on the prompt logits (so every group in the pool is "forward, then
    transition"), and write the K-row groups into the free groups ``gids``
    (A,), in place."""
    xa, init_tokens, lang_tok = _admit_frontend(model_obj, cfg, payload, init_tokens,
                                                scales, audio_frontend, lang_mask, detect)
    init_rep = init_tokens.repeat_interleave(K, 0)
    sub, last_logits, no_speech_all = _prompt_pass(decoder, cfg, xa, init_rep, ctx=tmax)
    A, sb = init_tokens.shape
    dev, eot = gids.device, cfg.eot
    W = state.buf.shape[1]
    buf = torch.full((A * K, W), eot, dtype=torch.long, device=dev)
    buf[:, :sb] = init_rep
    start = torch.full((K,), float("-inf"), device=dev)
    start[0] = 0.0  # only beam 0 starts live, as in the batch loop
    st = BeamState(
        buf=buf, sum_logprobs=start.repeat(A),
        fin_toks=torch.full((A, C, W), eot, dtype=torch.long, device=dev),
        fin_scores=torch.full((A, C), float("-inf"), device=dev),
        fin_count=torch.zeros(A, dtype=torch.long, device=dev),
        last=torch.full((A * K,), -1, dtype=torch.long, device=dev),
        prev=torch.full((A * K,), -1, dtype=torch.long, device=dev),
        max_ts=torch.zeros(A * K, dtype=torch.long, device=dev))
    st, flat_src, _ = beam_transition(cfg, K, C, last_logits, sb, st)
    cur_new = torch.full((A,), sb + 1, dtype=torch.long, device=dev)
    rids = (gids[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
    for big, s in zip(state.self_k, sub["self_k"]):
        big.index_copy_(0, rids, s.index_select(0, flat_src))
    for big, s in zip(state.self_v, sub["self_v"]):
        big.index_copy_(0, rids, s.index_select(0, flat_src))
    for big, s in zip(state.cross_k, sub["cross_k"]):
        big.index_copy_(0, gids, s)
    for big, s in zip(state.cross_v, sub["cross_v"]):
        big.index_copy_(0, gids, s)
    state.buf.index_copy_(0, rids, st.buf)
    state.cur.index_copy_(0, gids, cur_new)
    state.done.index_copy_(0, gids, ~_beam_live(cfg, C, cur_new, st.fin_count))
    state.sum_lp.index_copy_(0, rids, st.sum_logprobs)
    state.fin_toks.index_copy_(0, gids, st.fin_toks)
    state.fin_scores.index_copy_(0, gids, st.fin_scores)
    state.fin_count.index_copy_(0, gids, st.fin_count)
    state.last.index_copy_(0, rids, st.last)
    state.prev.index_copy_(0, rids, st.prev)
    state.max_ts.index_copy_(0, rids, st.max_ts)
    state.no_speech.index_copy_(0, gids, no_speech_all[::K].float())
    state.lang.index_copy_(0, gids, lang_tok)


@dataclass
class _Request:
    payload: np.ndarray  # (n_mels, T) mel, or int16 audio (audio_frontend)
    scale: float = 1.0
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None


class DecodeEngine:
    """Host orchestrator: a worker thread admits queued requests into free
    slots and steps the pool; ``submit`` blocks until its slot retires.
    Thread-safe.  The pool lives on the model's device."""

    def __init__(self, model_obj, options=None, slots: int = 8, unroll: int = 4,
                 admit_width: int = 2, audio_frontend: bool = False, lookup_gamma: int = 0,
                 mesh=None, metrics=None):
        """``audio_frontend``: ``submit`` takes raw 16 kHz audio (padded to
        30 s and quantized to int16 against its peak on the host) and
        admission computes the log-mel on the device; without it ``submit``
        takes an (n_mels, T) mel.  ``lookup_gamma`` > 0 makes each step a
        prompt-lookup speculative round (up to gamma + 1 tokens per slot per
        forward, token-exact).  ``metrics``: a ``serving.ServerMetrics``-like
        registry (``inc``/``set``) for the ``engine_*`` counters.  ``mesh``:
        a data-parallel pool over the mesh (see the module); ``slots`` must
        be a multiple of its data extent, beam pools take none, and a model
        axis > 1 shards the model (``WhisperModel.shard``)."""
        from . import DecodingOptions, DecodingTask

        options = options or DecodingOptions(language="en", without_timestamps=True)
        self._detect = False
        if options.language is None:
            # Multilingual models detect each request's language at
            # admission ("en" only shapes the prompt); English-only
            # vocabularies have no language slot.
            self._detect = model_obj.is_multilingual
            options = replace(options, language="en")
        if options.temperature != 0 or options.best_of:
            raise ValueError("DecodeEngine decodes at temperature 0 (greedy or beam); "
                             "best_of requires sampling")
        self.beam = options.beam_size or 0
        if self.beam and lookup_gamma:
            raise ValueError("lookup_gamma speculative rounds are greedy-only")
        if self.beam and options.kv_int8:
            raise ValueError("kv_int8 beam pools are unsupported (grouped int8 "
                             "cross-attention)")
        if self.beam and mesh is not None and mesh.size > 1:
            raise ValueError("beam engine pools do not shard over a mesh")
        self.mesh = None
        n_data = 1
        if mesh is not None and mesh.size > 1:
            n_data = mesh.shape[parallel.DATA_AXIS]
            if slots % n_data:
                raise ValueError(f"slots ({slots}) must be a multiple of the mesh's data "
                                 f"axis ({n_data})")
            if mesh.shape[parallel.MODEL_AXIS] > 1:
                model_obj.shard(mesh)
            self.mesh = mesh.fork()
        if model_obj.device.type == "cuda":
            _kernels.library()  # built here, never by two threads at first use
        self.model = model_obj
        self.device = model_obj.device
        self.task = task = DecodingTask(model_obj, options, mesh=self.mesh)
        self.cfg = task.loop_cfg._replace(unroll=unroll)
        self.tokenizer = task.tokenizer
        self.slots = slots
        self.local_slots = slots // n_data  # this rank's rows of the pool
        self.unroll = unroll
        self.admit_width = min(admit_width, slots)
        self.admit_calls = 0  # admission batches so far
        self.step_calls = 0  # step calls so far, each of ``unroll`` decoder steps
        # Stage times: on the card CUDA events around each admission, step
        # and retirement (no sync; summed as they complete), else the host
        # clock.  See ``stage_seconds``.
        self._stage_totals = {"admit": 0.0, "step": 0.0, "retire": 0.0}
        self._stage_events: Deque[tuple] = deque()
        self._stage_lock = threading.Lock()
        self.audio_frontend = audio_frontend
        self.metrics = metrics
        self.lookup_gamma = lookup_gamma
        self._decoder = model_obj.decoder_for(self.cfg.compute_dtype)
        self._cross_decoder = model_obj.module.decoder if options.kv_int8 else None
        self._lang_mask = None
        self._lang_codes: Dict[int, str] = {}
        if self._detect:
            mask = torch.zeros(model_obj.dims.n_vocab, dtype=torch.bool, device=self.device)
            mask[list(self.tokenizer.all_language_tokens)] = True
            self._lang_mask = mask
            self._lang_codes = dict(zip(self.tokenizer.all_language_tokens,
                                        self.tokenizer.all_language_codes))
        # lookup rounds write K/V up to gamma past the last committable position
        reach = task.sample_begin + task.sample_len + max(unroll, lookup_gamma + 1) + 1
        self.tmax = min(model_obj.dims.n_text_ctx, round_up(reach, 16))
        if self.beam:
            self.max_cands = max(round(self.beam * (options.patience or 1.0)), 1)
        self.state = self._fresh_state()
        self._init = torch.tensor(task.initial_tokens, dtype=torch.long)
        self._occupant: List[Optional[_Request]] = [None] * slots
        self._busy = [False] * self.local_slots  # mesh pools: this rank's rows in use
        self._queue: List[_Request] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run if self.mesh is None else self._run_mesh, daemon=True)
        self._worker.start()
        atexit.register(self.close)

    def _fresh_state(self):
        """An empty pool: every slot free."""
        dims, dev, slots = self.model.dims, self.device, self.local_slots
        dt = self.cfg.compute_dtype
        H = dims.n_text_head
        Dh = dims.n_text_state // H
        W = dims.n_text_ctx + 1
        sb1 = self.cfg.sample_begin + 1
        L = dims.n_text_layer
        longs = lambda n, v: torch.full((n,), v, dtype=torch.long, device=dev)
        rows = slots * (self.beam or 1)
        proto = model.init_kv_cache(dims, rows, dt, dev, cross_batch=slots, ctx=self.tmax,
                                    cross_int8=self.cfg.kv_int8)
        fp_cross = lambda: [torch.zeros(slots, H, dims.n_audio_ctx, Dh, dtype=dt, device=dev)
                            for _ in range(L)]
        if self.beam:
            C = self.max_cands
            return _BeamState(
                self_k=proto["self_k"], self_v=proto["self_v"], cross_k=fp_cross(),
                cross_v=fp_cross(), buf=torch.full((rows, W), self.cfg.eot,
                                                   dtype=torch.long, device=dev),
                cur=longs(slots, sb1), done=torch.ones(slots, dtype=torch.bool, device=dev),
                sum_lp=torch.zeros(rows, device=dev),
                fin_toks=torch.full((slots, C, W), self.cfg.eot, dtype=torch.long,
                                    device=dev),
                fin_scores=torch.full((slots, C), float("-inf"), device=dev),
                fin_count=longs(slots, 0), last=longs(rows, -1), prev=longs(rows, -1),
                max_ts=longs(rows, 0), no_speech=torch.full((slots,), float("nan"),
                                                            device=dev),
                lang=longs(slots, -1))
        if self.cfg.kv_int8:
            cross = dict(cross_k=proto["cross_k8"], cross_sk=tuple(proto["cross_sk"]),
                         cross_v=proto["cross_v8"], cross_sv=tuple(proto["cross_sv"]))
        else:
            cross = dict(cross_k=fp_cross(), cross_v=fp_cross())
        return _EngineState(
            self_k=proto["self_k"], self_v=proto["self_v"], **cross,
            buf=torch.full((slots, W), self.cfg.eot, dtype=torch.long, device=dev),
            cur=longs(slots, sb1), finished=torch.ones(slots, dtype=torch.bool, device=dev),
            last=longs(slots, -1), prev=longs(slots, -1), max_ts=longs(slots, 0),
            sum_lp=torch.zeros(slots, device=dev),
            no_speech=torch.full((slots,), float("nan"), device=dev), lang=longs(slots, -1))

    # -- client side ----------------------------------------------------------

    def submit(self, x, timeout: float = 600.0) -> dict:
        """Blocking request: a (n_mels, T) mel, or with ``audio_frontend``
        raw 16 kHz audio (float in [-1, 1] or int16)."""
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        if self.mesh is not None and not self.mesh.is_leader:
            raise RuntimeError("a data-parallel engine takes its requests on the mesh's "
                               f"leader (rank {self.mesh.leader})")
        if self.audio_frontend:
            req = _Request(*wire_pcm16(x))
        else:
            req = _Request(payload=np.asarray(x, np.float32))
        with self._lock:
            # under the lock close() drains with: a request appended after
            # the drain would hang its waiter
            if self._stop.is_set():
                raise RuntimeError("engine is closed")
            self._queue.append(req)
        self._wake.set()
        if not req.event.wait(timeout):
            raise TimeoutError("decode timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def join(self, timeout: Optional[float] = None):
        """Wait for the worker to end: on a follower rank of a mesh pool,
        until the leader closes the engine."""
        self._worker.join(timeout)

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        atexit.unregister(self.close)
        self._wake.set()
        self._worker.join(timeout=600)
        with self._lock:
            for req in self._queue:
                req.error = "engine shutting down"
                req.event.set()
            self._queue.clear()
        for i, req in enumerate(self._occupant):
            if req is not None:
                req.error = "engine shutting down"
                req.event.set()
                self._occupant[i] = None

    # -- worker ---------------------------------------------------------------

    def _admit_some(self):
        free = [i for i, r in enumerate(self._occupant) if r is None]
        while free:
            with self._lock:
                take = self._queue[: min(len(free), self.admit_width)]
                del self._queue[: len(take)]
            if not take:
                return
            ids, free = free[: len(take)], free[len(take):]
            try:
                self._admit_rows(ids, [r.payload for r in take], [r.scale for r in take])
            except Exception as e:  # fail these requests (dequeued: nobody else
                # will wake them) and keep serving
                for req in take:
                    req.error = f"{type(e).__name__}: {e}"
                    req.event.set()
                return
            self.admit_calls += 1
            for slot, req in zip(ids, take):
                self._occupant[slot] = req
            if self.metrics is not None:
                self.metrics.inc("engine_admitted_total", len(take))
                self.metrics.inc("engine_admit_dispatches_total")

    def _admit_rows(self, ids: List[int], payloads, scales):
        """Encode and prompt-pass requests into this rank's free rows ``ids``."""
        dev = self.device
        payload = torch.from_numpy(np.stack(payloads)).to(dev)
        kw = dict(scales=torch.tensor(scales, device=dev), audio_frontend=self.audio_frontend,
                  lang_mask=self._lang_mask, detect=self._detect)
        init = self._init.to(dev).repeat(len(ids), 1)
        sids = torch.tensor(ids, device=dev)
        if self.beam:
            _beam_admit(self.model, self._decoder, self.cfg, self.state, sids, payload, init,
                        self.tmax, self.beam, self.max_cands, **kw)
        else:
            _engine_admit(self.model, self._decoder, self._cross_decoder, self.cfg,
                          self.state, sids, payload, init, self.tmax, **kw)

    def _result(self, ids: List[int], score: float, no_speech: float, lang: int) -> dict:
        return {"text": self.tokenizer.decode(ids).strip(), "tokens": [int(t) for t in ids],
                "avg_logprob": score / (len(ids) + 1), "no_speech_prob": float(no_speech),
                "language": self._lang_codes.get(int(lang),
                                                 self.task.options.language or "en")}

    def _retire(self, slot: int, result: dict):
        req = self._occupant[slot]
        req.result = result
        req.event.set()
        self._occupant[slot] = None
        if self.metrics is not None:
            self.metrics.inc("engine_retired_total")
            self.metrics.inc("engine_committed_tokens_total", len(result["tokens"]) + 1)

    def _retire_finished_beam(self):
        from . import _cut_at_eot, finalize_beam_group, rank_group

        done = self.state.done.cpu().numpy()
        retire = [g for g, r in enumerate(self._occupant) if r is not None and done[g]]
        if not retire:
            return
        st = self.state
        buf, sum_lp, fin_toks, fin_scores, fin_count, no_speech, lang = (
            t.cpu().numpy() for t in (st.buf, st.sum_lp, st.fin_toks, st.fin_scores,
                                      st.fin_count, st.no_speech, st.lang))
        K, eot, sb = self.beam, self.cfg.eot, self.cfg.sample_begin
        for g in retire:
            # the batch task's finalize and ranker (decode/__init__.py)
            seqs, scores = finalize_beam_group(
                fin_toks[g], fin_scores[g], int(fin_count[g]), buf[g * K:(g + 1) * K],
                sum_lp[g * K:(g + 1) * K], K, eot)
            sliced = [_cut_at_eot(np.asarray(seq), sb, eot) for seq in seqs]
            best = rank_group(sliced, scores, self.task.options.length_penalty)
            self._retire(g, self._result(sliced[best], scores[best], no_speech[g], lang[g]))

    def _finished_results(self, busy: List[bool]) -> Dict[int, dict]:
        """The results of the greedy rows in use (``busy``) that finished."""
        finished = self.state.finished.cpu().numpy()
        done = [i for i, b in enumerate(busy) if b and finished[i]]
        if not done:
            return {}
        st = self.state
        buf, cur, sum_lp, no_speech, lang = (
            t.cpu().numpy() for t in (st.buf, st.cur, st.sum_lp, st.no_speech, st.lang))
        eot, sb = self.cfg.eot, self.cfg.sample_begin
        out = {}
        for slot in done:
            s = buf[slot][sb:int(cur[slot])]
            hits = np.nonzero(s == eot)[0]
            ids = s[: hits[0]].tolist() if hits.size else s.tolist()
            out[slot] = self._result(ids, float(sum_lp[slot]), no_speech[slot], lang[slot])
        return out

    def _retire_finished(self):
        if self.beam:
            return self._retire_finished_beam()
        busy = [r is not None for r in self._occupant]
        for slot, result in self._finished_results(busy).items():
            self._retire(slot, result)

    def _step(self):
        if self.beam:
            self.state = _beam_engine_step(self._decoder, self.cfg, self.state, self.unroll,
                                           self.beam, self.max_cands)
        else:
            self.state = _engine_step(self._decoder, self.cfg, self.state, self.unroll,
                                      self.lookup_gamma)
        self.step_calls += 1

    @property
    def stage_seconds(self) -> dict:
        """Seconds spent so far in admission, steps and retirement.  On the
        card each stage's time is the device stream's span between events
        recorded when the worker enters and leaves the stage: the device
        work the stage queued, plus any time the device waited for the host
        inside the stage.  Reading it waits for the recorded work."""
        with self._stage_lock:
            self._fold_stages(wait=True)
            return dict(self._stage_totals)

    def _fold_stages(self, wait: bool):
        while self._stage_events:
            stage, start, end = self._stage_events[0]
            if not wait and not end.query():
                return
            end.synchronize()
            self._stage_totals[stage] += start.elapsed_time(end) / 1e3
            self._stage_events.popleft()

    def _timed(self, stage: str, fn):
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            self._stage_totals[stage] += time.perf_counter() - t0
            return
        stream = torch.cuda.current_stream(self.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        fn()
        end.record(stream)
        with self._stage_lock:
            self._stage_events.append((stage, start, end))
            self._fold_stages(wait=False)

    def _run(self):
        with torch.inference_mode():  # per thread
            while not self._stop.is_set():
                with self._lock:
                    idle = not self._queue and all(r is None for r in self._occupant)
                if idle:
                    if self.metrics is not None:
                        self.metrics.set("engine_slots_occupied", 0)
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                    continue
                try:
                    self._timed("admit", self._admit_some)
                    occupied = sum(r is not None for r in self._occupant)
                    if self.metrics is not None:
                        self.metrics.set("engine_slots_occupied", occupied)
                    if occupied:
                        self._timed("step", self._step)
                        if self.metrics is not None:
                            self.metrics.inc("engine_step_dispatches_total")
                        self._timed("retire", self._retire_finished)
                except Exception as e:  # fail the live requests, keep serving
                    for i, req in enumerate(self._occupant):
                        if req is not None:
                            req.error = f"{type(e).__name__}: {e}"
                            req.event.set()
                            self._occupant[i] = None

    # -- data-parallel pool (mesh) ---------------------------------------------

    def _plan(self) -> dict:
        """The leader's plan for one iteration: the stop, or the queued
        requests it admits, each into a free slot of the global pool, the
        free slots taken across the data ranks in turn."""
        if self._stop.is_set():
            return {"stop": True}
        free = [g for g, r in enumerate(self._occupant) if r is None]
        free.sort(key=lambda g: (g % self.local_slots, g // self.local_slots))
        with self._lock:
            take = self._queue[:len(free)]
            del self._queue[:len(take)]
        admit = []
        for g, req in zip(free, take):
            self._occupant[g] = req
            admit.append((g, req.payload, req.scale))
        if admit and self.metrics is not None:
            self.metrics.inc("engine_admitted_total", len(admit))
        return {"stop": False, "admit": admit}

    def _mesh_iteration(self, plan: dict) -> Dict[int, dict]:
        """One lockstep iteration on every rank: admit the plan's requests
        that fall in this rank's rows (in batches of ``admit_width``), step
        this rank's rows, and gather every data rank's finished rows to
        every rank, as {global slot: result or {"error": ...}}."""
        base = self.mesh.index(parallel.DATA_AXIS) * self.local_slots
        mine = [(g - base, payload, scale) for g, payload, scale in plan["admit"]
                if base <= g < base + self.local_slots]
        report: Dict[int, dict] = {}
        for i in range(0, len(mine), self.admit_width):
            chunk = mine[i:i + self.admit_width]
            try:
                self._timed("admit", lambda: self._admit_rows(*map(list, zip(*chunk))))
            except Exception as e:  # fail these requests, keep serving
                report.update({base + r[0]: {"error": f"{type(e).__name__}: {e}"}
                               for r in chunk})
                continue
            self.admit_calls += 1
            for r in chunk:
                self._busy[r[0]] = True
        if any(self._busy):
            try:
                self._timed("step", self._step)
                done = self._finished_results(self._busy)
            except Exception as e:  # fail this rank's live rows, keep serving
                done = {i: {"error": f"{type(e).__name__}: {e}"}
                        for i, b in enumerate(self._busy) if b}
            for i, result in done.items():
                self._busy[i] = False
                report[base + i] = result
        merged: Dict[int, dict] = {}
        for part in parallel.gather_objects(report, self.mesh, parallel.DATA_AXIS):
            merged.update(part)
        return merged

    def _run_mesh(self):
        """The worker of a data-parallel pool: the leader plans, every rank
        follows the broadcast plan; the leader answers the requests."""
        leader = self.mesh.is_leader
        with torch.inference_mode():
            while True:
                if leader:
                    with self._lock:
                        idle = not self._queue and all(r is None for r in self._occupant)
                    if idle and not self._stop.is_set():
                        # a plan still goes out every 0.1 s: the followers
                        # wait in the broadcast
                        self._wake.wait(timeout=0.1)
                        self._wake.clear()
                plan = parallel.broadcast_object(self._plan() if leader else None, self.mesh)
                if plan["stop"]:
                    return
                results = self._mesh_iteration(plan)
                if not leader:
                    continue
                for g, result in results.items():
                    req = self._occupant[g]
                    self._occupant[g] = None
                    if "error" in result:
                        req.error = result["error"]
                        req.event.set()
                    else:
                        req.result = result
                        req.event.set()
                        if self.metrics is not None:
                            self.metrics.inc("engine_retired_total")
                            self.metrics.inc("engine_committed_tokens_total",
                                             len(result["tokens"]) + 1)
                if self.metrics is not None:
                    self.metrics.set("engine_slots_occupied",
                                     sum(r is not None for r in self._occupant))
