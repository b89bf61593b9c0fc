"""Decoding API: options, results, language detection and decode().

Port of ``qasr_ijcnlp_tpu/decode/__init__.py``: greedy and temperature
sampling, best-of (``best_of`` sampled rows per audio, ranked), beam search
(``beam_size``, ``patience``, ``length_penalty``), each with the int8 cross
cache of ``kv_int8``, and speculative greedy decoding (``draft=Draft(model
or None, gamma)``, :mod:`.speculative`), which runs where the JAX package
runs it: at temperature 0 with no beam or best-of, a draft model only on a
mel input of known language (its encoder needs the mel), prompt lookup on
any input.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..audio import CHUNK_LENGTH
from ..models import whisper as model
from ..tokenizer import Tokenizer, get_tokenizer
from ..utils import compression_ratio
from . import loop as _loop
from .filters import build_config


class Draft:
    """A draft model and the speculation width ``gamma`` for speculative
    greedy decoding (:mod:`.speculative`); ``model=None`` drafts by prompt
    lookup (proposals copied from the row's own tokens).  A plain class
    with identity hash and equality, so options carrying one stay hashable
    for the model's task cache."""

    __slots__ = ("model", "gamma")

    def __init__(self, model=None, gamma: int = 4):
        if gamma < 1:
            raise ValueError("draft gamma must be >= 1")
        self.model = model
        self.gamma = int(gamma)


@dataclass(frozen=True)
class DecodingOptions:
    """Mirror of the reference options (whisper decoding.py)."""

    task: str = "transcribe"
    language: Optional[str] = None

    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None

    length_penalty: Optional[float] = None

    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None

    suppress_tokens: Optional[Union[str, Iterable[int]]] = "-1"
    suppress_blank: bool = True

    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0

    # On CUDA "fp16" selects bfloat16; float32 elsewhere.
    fp16: bool = True

    kv_int8: bool = False
    # Speculative greedy decoding: token-exact against plain greedy.
    draft: Optional[Draft] = None
    prompt_bucket: Optional[int] = None


@dataclass(frozen=True)
class DecodingResult:
    audio_features: Optional[torch.Tensor]
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


def _compute_dtype(fp16: bool, device: torch.device) -> torch.dtype:
    if fp16 and device.type == "cuda":
        return torch.bfloat16
    return torch.float32


def _audio_features(model_obj, mel: torch.Tensor, fp16: bool, mesh=None) -> torch.Tensor:
    """The encoder's output for ``mel``; ``mesh`` shards its trunk over the
    mesh's model axis (the rows are the caller's)."""
    dims = model_obj.dims
    if tuple(mel.shape[-2:]) == (dims.n_audio_ctx, dims.n_audio_state):
        return mel  # already encoded
    return model.dispatch_encoder_apply(
        model_obj.module.encoder, mel, dims, _compute_dtype(fp16, mel.device), mesh=mesh
    )


def detect_language(
    model_obj, mel, tokenizer: Optional[Tokenizer] = None
) -> Tuple[np.ndarray, List[Dict[str, float]]]:
    """Most probable language token + per-language probabilities."""
    if tokenizer is None:
        tokenizer = get_tokenizer(
            model_obj.is_multilingual, num_languages=model_obj.num_languages
        )
    if (
        tokenizer.language is None
        or tokenizer.language_token not in tokenizer.sot_sequence
    ):
        raise ValueError(
            "This model doesn't have language tokens so it can't perform lang id"
        )
    mel = torch.as_tensor(mel).to(model_obj.device)
    single = mel.dim() == 2
    if single:
        mel = mel[None]
    # With a pinned mesh every rank computes every row (the model axis
    # shards the encoder); only ``decode`` splits the rows over ``data``.
    xa = _audio_features(model_obj, mel, fp16=True, mesh=getattr(model_obj, "mesh", None))

    x = torch.full((xa.shape[0], 1), tokenizer.sot, dtype=torch.long, device=xa.device)
    logits = model.decoder_apply(model_obj.module.decoder, x, xa, model_obj.dims)[:, 0]
    mask = torch.zeros(model_obj.dims.n_vocab, dtype=torch.bool, device=xa.device)
    mask[list(tokenizer.all_language_tokens)] = True
    logits = logits.masked_fill(~mask, float("-inf"))
    language_tokens = logits.argmax(-1).cpu().numpy()
    probs = torch.softmax(logits, dim=-1).cpu().numpy()
    language_probs = [
        {
            c: float(probs[i, j])
            for j, c in zip(tokenizer.all_language_tokens, tokenizer.all_language_codes)
        }
        for i in range(mel.shape[0])
    ]
    if single:
        return language_tokens[0], language_probs[0]
    return language_tokens, language_probs


def _cut_at_eot(seq: np.ndarray, sample_begin: int, eot: int) -> List[int]:
    """Sampled-region tokens up to (excluding) the first eot."""
    s = seq[sample_begin:]
    hits = np.nonzero(s == eot)[0]
    return s[: hits[0]].tolist() if hits.size else s.tolist()


def finalize_beam_group(fin_toks_g, fin_scores_g, fin_count_g: int,
                        beams_g, beam_scores_g, K: int, eot: int):
    """Reference BeamSearchDecoder.finalize for one audio: the bounded
    finished set, topped up with the best unfinished beams (eot appended)
    when fewer than K finished."""
    seqs = [list(fin_toks_g[c]) for c in range(fin_count_g)]
    scores = [float(fin_scores_g[c]) for c in range(fin_count_g)]
    if len(seqs) < K:
        for j in np.argsort(beam_scores_g)[::-1]:
            seqs.append(list(beams_g[j]) + [eot])
            scores.append(float(beam_scores_g[j]))
            if len(seqs) >= K:
                break
    return seqs, scores


def rank_group(sliced: List[List[int]], scores: List[float],
               length_penalty: Optional[float]) -> int:
    """MaximumLikelihoodRanker for one group (reference decoding.py):
    index of the best candidate under the length penalty."""

    def _score(lp, length):
        if length_penalty is None:
            penalty = length
        else:
            penalty = ((5 + length) / 6) ** length_penalty
        return lp / penalty

    return int(np.argmax([_score(p, len(t)) for p, t in zip(scores, sliced)]))


class DecodingTask:
    """Host-side planner: resolves options to a loop config, runs the loop,
    post-processes to DecodingResults.

    ``mesh`` (default: the model's, ``WhisperModel.shard``) makes ``run``
    data-parallel: every rank of the mesh calls it with the same whole
    batch; the batch is padded to the data extent (``parallel.
    pad_batch_to_mesh``), each data rank decodes its rows (the encoder's
    trunk sharded over the model axis), and the per-row results are
    gathered, so every rank returns the list the unsharded decode of the
    whole batch gives, in the batch's order (token for token at f32 greedy
    and beam; sampling draws each rank's rows from its own generator)."""

    def __init__(self, model_obj, options: DecodingOptions, mesh=None):
        self.model = model_obj
        if mesh is None:
            mesh = getattr(model_obj, "mesh", None)
        language = options.language or "en"
        self.tokenizer = get_tokenizer(
            model_obj.is_multilingual,
            num_languages=model_obj.num_languages,
            language=language,
            task=options.task,
        )
        self.options = self._verify_options(options)
        # hypothesis rows per audio
        self.n_group: int = options.beam_size or options.best_of or 1

        self.n_ctx: int = model_obj.dims.n_text_ctx
        self.sample_len: int = options.sample_len or model_obj.dims.n_text_ctx // 2

        self.sot_sequence = self.tokenizer.sot_sequence
        if self.options.without_timestamps:
            self.sot_sequence = self.tokenizer.sot_sequence_including_notimestamps

        self.initial_tokens: Tuple[int, ...] = self._get_initial_tokens()
        self.sample_begin: int = len(self.initial_tokens)
        self.sot_index: int = self.initial_tokens.index(self.tokenizer.sot)

        max_initial_timestamp_index = None
        if not options.without_timestamps and options.max_initial_timestamp:
            precision = CHUNK_LENGTH / model_obj.dims.n_audio_ctx
            max_initial_timestamp_index = round(
                options.max_initial_timestamp / precision
            )

        filters = build_config(
            self.tokenizer,
            model_obj.dims.n_vocab,
            self.sample_begin,
            self._get_suppress_tokens() if options.suppress_tokens else (),
            options.suppress_blank,
            options.without_timestamps,
            max_initial_timestamp_index,
        )
        n_vocab = model_obj.dims.n_vocab
        no_speech = self.tokenizer.no_speech
        self.loop_cfg = _loop.LoopConfig(
            dims=model_obj.dims,
            filters=filters,
            sample_begin=self.sample_begin,
            sot_index=self.sot_index,
            sample_len=self.sample_len,
            eot=self.tokenizer.eot,
            timestamp_begin=min(self.tokenizer.timestamp_begin, n_vocab),
            no_speech=no_speech if no_speech is not None and no_speech < n_vocab else None,
            compute_dtype=_compute_dtype(options.fp16, model_obj.device),
            kv_int8=options.kv_int8,
            mesh=mesh,
        )

        draft = options.draft
        self.use_lookup_draft = draft is not None and draft.model is None
        self.draft_cfg = None
        if draft is not None and draft.model is not None:
            dd, td = draft.model.dims, model_obj.dims
            if dd.n_vocab != td.n_vocab or dd.n_mels != td.n_mels:
                raise ValueError(
                    f"draft model (vocab {dd.n_vocab}, {dd.n_mels} mels) is incompatible "
                    f"with the target (vocab {td.n_vocab}, {td.n_mels} mels); draft and "
                    "target must share the tokenizer and mel frontend")
            # The target's filters and prompt; the draft's cross cache fp and
            # its own mesh.
            self.draft_cfg = self.loop_cfg._replace(
                dims=dd, kv_int8=False, mesh=getattr(draft.model, "mesh", None))
        # Verify rounds of the last speculative run (committed tokens /
        # rounds is the mean accepted slab length).
        self.last_spec_rounds: Optional[int] = None

    def _verify_options(self, options: DecodingOptions) -> DecodingOptions:
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling (T=0) is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        if options.length_penalty is not None and not (
            0 <= options.length_penalty <= 1
        ):
            raise ValueError("length_penalty (alpha) should be a value between 0 and 1")
        return options

    def _get_initial_tokens(self) -> Tuple[int, ...]:
        tokens = list(self.sot_sequence)

        if prefix := self.options.prefix:
            prefix_tokens = (
                self.tokenizer.encode(" " + prefix.strip())
                if isinstance(prefix, str)
                else prefix
            )
            if self.sample_len is not None:
                max_prefix_len = self.n_ctx // 2 - self.sample_len
                prefix_tokens = prefix_tokens[-max_prefix_len:]
            tokens = tokens + list(prefix_tokens)

        if prompt := self.options.prompt:
            prompt_tokens = (
                self.tokenizer.encode(" " + prompt.strip())
                if isinstance(prompt, str)
                else list(prompt)
            )
            prompt_tokens = prompt_tokens[-(self.n_ctx // 2 - 1) :]
            if bucket := self.options.prompt_bucket:
                keep = (len(prompt_tokens) // bucket) * bucket
                prompt_tokens = prompt_tokens[-keep:] if keep else []
            if prompt_tokens:
                tokens = [self.tokenizer.sot_prev] + prompt_tokens + tokens
        if len(tokens) > self.n_ctx:
            raise ValueError(
                f"initial tokens (sot sequence + prefix/prompt) are "
                f"{len(tokens)} long, exceeding the decoder context "
                f"{self.n_ctx}; shorten prefix/prompt or pass a sample_len "
                f"below n_text_ctx//2 so the prefix budget is positive"
            )
        return tuple(tokens)

    def _get_suppress_tokens(self) -> Tuple[int, ...]:
        suppress_tokens = self.options.suppress_tokens
        if isinstance(suppress_tokens, str):
            suppress_tokens = [int(t) for t in suppress_tokens.split(",")]
        if -1 in suppress_tokens:
            suppress_tokens = [t for t in suppress_tokens if t >= 0]
            suppress_tokens.extend(self.tokenizer.non_speech_tokens)
        elif suppress_tokens is None or len(suppress_tokens) == 0:
            suppress_tokens = []
        else:
            # copy: never mutate the caller's options
            suppress_tokens = list(suppress_tokens)

        suppress_tokens.extend(
            [
                self.tokenizer.transcribe,
                self.tokenizer.translate,
                self.tokenizer.sot,
                self.tokenizer.sot_prev,
                self.tokenizer.sot_lm,
            ]
        )
        if self.tokenizer.no_speech is not None:
            suppress_tokens.append(self.tokenizer.no_speech)
        return tuple(sorted(set(t for t in suppress_tokens if t < self.model.dims.n_vocab)))

    def run(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
            spec_events: Optional[list] = None) -> List[DecodingResult]:
        """Decode ``mel`` (or encoder features).  ``spec_events``: a list
        that a speculative decode on the card fills with each verify round's
        CUDA events (``speculative.spec_greedy_decode``'s ``events``).
        Under a mesh with data ranks, data-parallel (see the class)."""
        from .. import parallel

        mesh = self.loop_cfg.mesh
        if parallel.axis_size(mesh, parallel.DATA_AXIS) == 1:
            return self._run(mel, generator, spec_events)
        padded, real = parallel.pad_batch_to_mesh(mel, mesh)
        results = self._run(parallel.shard_batch(padded, mesh), generator, spec_events)
        feats = parallel.all_gather(torch.stack([r.audio_features for r in results]), mesh,
                                    parallel.DATA_AXIS, 0)
        parts = parallel.gather_objects([replace(r, audio_features=None) for r in results],
                                        mesh, parallel.DATA_AXIS)
        rows = [r for part in parts for r in part][:real]
        return [replace(r, audio_features=feats[i]) for i, r in enumerate(rows)]

    def _run(self, mel, generator, spec_events) -> List[DecodingResult]:
        """``run`` on this rank's rows."""
        tokenizer = self.tokenizer
        n_audio = mel.shape[0]
        opts = self.options
        dims = self.model.dims
        # The JAX package encodes inside the decode program when the input
        # is a mel of known language; only then can a draft model encode it.
        is_mel = tuple(mel.shape[-2:]) != (dims.n_audio_ctx, dims.n_audio_state)
        draft_mel = mel if is_mel and opts.language is not None and \
            opts.task != "lang_id" else None

        audio_features = _audio_features(self.model, mel, opts.fp16, self.loop_cfg.mesh)

        languages = [opts.language] * n_audio
        language_probs = None
        init = np.tile(np.asarray(self.initial_tokens, np.int64), (n_audio, 1))
        if opts.language is None or opts.task == "lang_id":
            lang_tokens, language_probs = detect_language(
                self.model, audio_features, tokenizer
            )
            languages = [max(p, key=p.get) for p in language_probs]
            if opts.language is None:
                init[:, self.sot_index + 1] = np.asarray(lang_tokens)
        if opts.task == "lang_id":
            return [
                DecodingResult(
                    audio_features=audio_features[i],
                    language=languages[i],
                    language_probs=language_probs[i],
                )
                for i in range(n_audio)
            ]

        # Hypothesis rows are group-major (audio i, group g) = row i G + g; the
        # audio features keep one row per audio.
        init_rep = np.repeat(init, self.n_group, axis=0)
        init_rep = torch.from_numpy(init_rep).to(audio_features.device)
        if opts.beam_size is not None:
            tokens_lists, logprob_lists, no_speech = self._run_beam(audio_features, init_rep)
        else:
            tokens_lists, logprob_lists, no_speech = self._run_greedy(
                audio_features, init_rep, generator, draft_mel, spec_events)

        eot = tokenizer.eot
        sliced = [[_cut_at_eot(np.asarray(seq), self.sample_begin, eot) for seq in group]
                  for group in tokens_lists]
        selected = self._rank(sliced, logprob_lists)
        tokens = [g[i] for i, g in zip(selected, sliced)]
        texts = [tokenizer.decode(t).strip() for t in tokens]
        sum_logprobs = [lp[i] for i, lp in zip(selected, logprob_lists)]
        avg_logprobs = [lp / (len(t) + 1) for t, lp in zip(tokens, sum_logprobs)]
        return [
            DecodingResult(
                audio_features=audio_features[i],
                language=languages[i],
                tokens=tokens[i],
                text=texts[i],
                avg_logprob=avg_logprobs[i],
                no_speech_prob=float(no_speech[i]),
                temperature=opts.temperature,
                compression_ratio=compression_ratio(texts[i]),
            )
            for i in range(n_audio)
        ]

    def _rank(self, tokens: List[List[List[int]]], sum_logprobs: List[List[float]]):
        return [rank_group(s, p, self.options.length_penalty)
                for s, p in zip(tokens, sum_logprobs)]

    def _decoders(self):
        """(the compute-dtype decoder, the fp32 decoder the int8 cross K/V
        are projected with, or None)."""
        return (self.model.decoder_for(self.loop_cfg.compute_dtype),
                self.model.module.decoder if self.options.kv_int8 else None)

    def _run_greedy(self, audio_features, init_rep, generator, draft_mel=None,
                    spec_events=None):
        G = self.n_group
        decoder, cross_decoder = self._decoders()
        greedy = self.options.temperature == 0 and G == 1
        gamma = self.options.draft.gamma if self.options.draft is not None else 0
        if greedy and self.use_lookup_draft:
            from .speculative import lookup_greedy_decode

            buf, _, sum_lp, no_speech, self.last_spec_rounds = lookup_greedy_decode(
                decoder, self.loop_cfg, audio_features, init_rep, gamma, cross_decoder,
                spec_events)
        elif greedy and self.draft_cfg is not None and draft_mel is not None:
            from .speculative import spec_greedy_decode

            dm = self.options.draft.model
            dt = self.draft_cfg.compute_dtype
            xa_d = model.dispatch_encoder_apply(dm.module.encoder, draft_mel.to(dm.device),
                                                dm.dims, dt, mesh=self.draft_cfg.mesh)
            buf, _, sum_lp, no_speech, self.last_spec_rounds = spec_greedy_decode(
                decoder, dm.decoder_for(dt), self.loop_cfg, self.draft_cfg, audio_features,
                xa_d, init_rep, gamma, cross_decoder, spec_events)
        else:
            buf, _, sum_lp, no_speech = _loop.greedy_decode(
                decoder, self.loop_cfg, audio_features, init_rep,
                float(self.options.temperature), generator, cross_decoder=cross_decoder,
            )
        # one device -> host copy for the whole batch
        buf, sum_lp = buf.cpu().numpy(), sum_lp.cpu().numpy()
        no_speech = no_speech[::G].cpu().numpy()
        n_audio = buf.shape[0] // G
        tokens_lists = [[buf[i * G + g] for g in range(G)] for i in range(n_audio)]
        logprob_lists = [[float(sum_lp[i * G + g]) for g in range(G)] for i in range(n_audio)]
        return tokens_lists, logprob_lists, no_speech

    def _run_beam(self, audio_features, init_rep):
        K = self.options.beam_size
        C = max(round(K * (self.options.patience or 1.0)), 1)
        decoder, cross_decoder = self._decoders()
        out = _loop.beam_decode(decoder, self.loop_cfg, audio_features, init_rep, K, C,
                                cross_decoder=cross_decoder)
        beams, beam_scores, fin_toks, fin_scores, fin_count, no_speech = (
            t.cpu().numpy() for t in out)
        tokens_lists, logprob_lists = [], []
        for b in range(beams.shape[0]):
            seqs, scores = finalize_beam_group(
                fin_toks[b], fin_scores[b], int(fin_count[b]), beams[b], beam_scores[b], K,
                self.tokenizer.eot)
            tokens_lists.append(seqs)
            logprob_lists.append(scores)
        return tokens_lists, logprob_lists, no_speech


def _get_task(model_obj, options: DecodingOptions) -> DecodingTask:
    """Reuse tasks across calls with identical options (the filter masks are
    vocab-sized); list-valued prompts are unhashable and build fresh."""
    cache = model_obj._task_cache
    try:
        task = cache.get(options)
    except TypeError:
        return DecodingTask(model_obj, options)
    if task is None:
        task = DecodingTask(model_obj, options)
        if len(cache) < 64:
            cache[options] = task
    return task


@torch.inference_mode()
def decode(
    model_obj,
    mel,
    options: DecodingOptions = DecodingOptions(),
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30-second mel segment(s) (reference decoding.py decode).

    ``generator`` drives temperature sampling (and best-of) on the model's
    device."""
    mel = torch.as_tensor(mel).to(model_obj.device)
    if single := mel.dim() == 2:
        mel = mel[None]
    if kwargs:
        options = replace(options, **kwargs)
    result = _get_task(model_obj, options).run(mel, generator)
    return result[0] if single else result
