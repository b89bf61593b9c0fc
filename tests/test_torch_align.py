"""Port word timing (qasr_ijcnlp_tpu_torch/align/) vs the JAX package's.

DTW and the median filter must be exactly equal; the teacher-forced
cross-QK pass and the alignment matrix within 1e-5; find_alignment's words
equal, probabilities within 1e-3 and times by the rule of
tests/test_align.py (median |diff| <= 0.02 s, >= 70% within 0.04 s); the
host heuristics equal on fabricated inputs.  The model is LF_DIMS
(n_audio_ctx 1500) with JAX weights moved through numpy.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import align as jalign
from qasr_ijcnlp_tpu.models import whisper as jwhisper
from qasr_ijcnlp_tpu.models.dims import dims_for as jdims_for
from qasr_ijcnlp_tpu.models.registry import (
    WhisperModel as JModel, _ALIGNMENT_HEADS as J_HEADS,
)
from qasr_ijcnlp_tpu.tokenizer import get_tokenizer as jget_tokenizer
from qasr_ijcnlp_tpu.transcribe import _HallucinationSkipper as JSkipper
from qasr_ijcnlp_tpu_torch import align
from qasr_ijcnlp_tpu_torch.models import whisper as twhisper
from qasr_ijcnlp_tpu_torch.models.dims import dims_for
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel, _ALIGNMENT_HEADS
from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer
from qasr_ijcnlp_tpu_torch.transcribe import _HallucinationSkipper
from tests.torch_port_common import LF_DIMS, lf_models, one_torch_thread  # noqa: F401

TEXT = " my fellow americans, ask not what your country can do for you."


@pytest.fixture(scope="module")
def models():
    return lf_models(0)


@pytest.fixture(scope="module")
def toks():
    kw = dict(num_languages=99, language="en", task="transcribe")
    return jget_tokenizer(True, **kw), get_tokenizer(True, **kw)


def _times_rule(ours, theirs):
    ours_t = np.array([[w.start, w.end] for w in ours])
    ref_t = np.array([[w.start, w.end] for w in theirs])
    diff = np.abs(ours_t - ref_t)
    assert np.median(diff) <= 0.02, diff
    assert np.mean(diff <= 0.04) >= 0.7, diff


@pytest.mark.parametrize("kind", ["random", "integer"])
@pytest.mark.parametrize("shape", [(1, 7), (7, 1), (45, 120), (200, 1500)])
def test_dtw_equal(shape, kind):
    rng = np.random.default_rng(sum(shape))
    if kind == "random":
        x = rng.standard_normal(shape).astype(np.float32)
    else:  # integer-valued: ties everywhere, so the tie rule decides
        x = rng.integers(0, 3, shape).astype(np.float32)
    np.testing.assert_array_equal(align.dtw(x), jalign.dtw(x))


@pytest.mark.parametrize("width", [3, 5, 7, 9, 11, 13])
def test_median_filter_equal(width):
    rng = np.random.default_rng(width)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    x[0, 1, 5] = x[1, 2, 0] = x[2, 4, 39] = np.nan
    x[2, 0, 10:14] = np.nan
    ours = align.median_filter(torch.from_numpy(x), width).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jalign.median_filter(x, width)))
    short = x[..., : width // 2]  # no wider than half the filter: passes through
    np.testing.assert_array_equal(align.median_filter(short, width).numpy(), short)


def _inputs(toks, seed=3):
    jt, _ = toks
    text = jt.encode(TEXT)
    tokens = [*jt.sot_sequence, jt.no_timestamps, *text, jt.eot]
    xa = np.random.default_rng(seed).standard_normal((1, 1500, 128)).astype(np.float32)
    return text, tokens, xa


def test_decoder_apply_with_cross_qk(models, toks):
    jm, tm = models
    _, tokens, xa = _inputs(toks)
    jl, jqk = jwhisper.decoder_apply_with_cross_qk(
        jm.params["decoder"], jnp.asarray([tokens]), jnp.asarray(xa), LF_DIMS)
    with torch.inference_mode():
        tl, tqk = twhisper.decoder_apply_with_cross_qk(
            tm.module.decoder, torch.tensor([tokens]), torch.from_numpy(xa), LF_DIMS)
    assert tqk.shape == (2, 1, 2, len(tokens), 1500) and tqk.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tqk.numpy(), np.asarray(jqk), atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_frames", [3000, 1234, 9])
def test_alignment_matrix(models, toks, num_frames):
    jm, tm = models
    jt, _ = toks
    _, tokens, xa = _inputs(toks)
    heads = tm.default_alignment_heads()
    head_idx = np.flatnonzero(heads.reshape(-1)).astype(np.int32)
    T_pad = -(-len(tokens) // 32) * 32
    tok_arr = np.full((1, T_pad), jt.eot, np.int32)
    tok_arr[0, :len(tokens)] = tokens
    _, jw = jalign._cross_qk_tensors(jm.params, jnp.asarray(tok_arr), jnp.asarray(xa),
                                     jnp.asarray(head_idx), LF_DIMS, jt.eot)
    want = jalign._alignment_matrix(jw, jnp.float32(1.0), 7, num_frames // 2, len(tokens))
    with torch.inference_mode():
        _, qk = twhisper.decoder_apply_with_cross_qk(
            tm.module.decoder, torch.tensor([tokens]), torch.from_numpy(xa), LF_DIMS)
        w = qk[:, 0].reshape(4, len(tokens), 1500)[torch.from_numpy(head_idx).long()]
        got = align._alignment_matrix(w, 1.0, 7, num_frames // 2, len(tokens))
    assert got.shape == (len(tokens), num_frames // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("features", ["mel", "audio_features"])
@pytest.mark.parametrize("num_frames", [3000, 1900])
def test_find_alignment(models, toks, num_frames, features):
    jm, tm = models
    jt, tt = toks
    text = jt.encode(TEXT)
    mel = np.random.default_rng(4).standard_normal((80, 3000)).astype(np.float32)
    kw = {}
    if features == "audio_features":
        kw["audio_features"] = np.asarray(jm.embed_audio(jnp.asarray(mel[None])))[0]
    theirs = jalign.find_alignment(jm, jt, text, jnp.asarray(mel), num_frames, **kw)
    if kw:
        kw["audio_features"] = torch.from_numpy(kw["audio_features"])
    ours = align.find_alignment(tm, tt, text, torch.from_numpy(mel), num_frames, **kw)
    assert len(ours) > 5
    assert [w.word for w in ours] == [w.word for w in theirs]
    assert [w.tokens for w in ours] == [w.tokens for w in theirs]
    np.testing.assert_allclose([w.probability for w in ours],
                               [w.probability for w in theirs], atol=1e-3, rtol=0)
    _times_rule(ours, theirs)


def test_find_alignment_reencodes_non_f32_features(models, toks):
    """bf16 features are not reused: the mel is encoded again in the
    model's compute dtype, giving the f32 path's alignment."""
    _, tm = models
    _, tt = toks
    text = tt.encode(TEXT)
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal((80, 3000)).astype(
        np.float32))
    f32 = align.find_alignment(tm, tt, text, mel, 3000)
    bf16 = align.find_alignment(tm, tt, text, mel, 3000,
                                audio_features=tm.embed_audio(mel[None])[0].bfloat16())
    assert [(w.word, w.start, w.end, w.probability) for w in bf16] == \
        [(w.word, w.start, w.end, w.probability) for w in f32]


def _timings(pkg, spec):
    return [pkg.WordTiming(w, list(t), s, e, p) for w, t, s, e, p in spec]


ALIGNMENT = [
    (" “", [1], 0.0, 0.1, 0.5), (" Hello", [2], 0.1, 0.5, 0.9), (",", [3], 0.5, 0.6, 0.4),
    (" (", [4], 0.6, 0.7, 0.3), (" world", [5], 0.7, 2.6, 0.8), (".", [6], 2.6, 2.7, 0.9),
    (" Next", [7], 2.7, 5.9, 0.7), (" one", [8], 5.9, 6.2, 0.1), ("!", [9], 6.2, 6.3, 0.6),
    ("”", [10], 6.3, 6.4, 0.5), (" end", [11], 6.4, 6.4, 0.8),
]


def test_merge_punctuations_equal():
    pre, app = "\"'“¿([{-", "\"'.。,，!！?？:：”)]}、"
    ours, theirs = _timings(align, ALIGNMENT), _timings(jalign, ALIGNMENT)
    align.merge_punctuations(ours, pre, app)
    jalign.merge_punctuations(theirs, pre, app)
    assert [vars(w) for w in ours] == [vars(w) for w in theirs]
    assert any(w.word == "" for w in ours)


@pytest.mark.parametrize("seek,last_speech", [(0, 0.0), (1000, 8.0), (2500, 30.5)])
def test_add_word_timestamps_reconciliation_equal(monkeypatch, toks, seek, last_speech):
    """Punctuation folding, the duration clip, the first word after a pause
    and the segment-bound reconciliation, on one fabricated alignment."""
    jt, tt = toks
    monkeypatch.setattr(align, "find_alignment",
                        lambda *a, **k: _timings(align, ALIGNMENT))
    monkeypatch.setattr(jalign, "find_alignment",
                        lambda *a, **k: _timings(jalign, ALIGNMENT))
    segments = [
        {"seek": seek, "start": seek / 100 + 0.0, "end": seek / 100 + 2.0,
         "tokens": [1, 2, 3, 4, 5, 6, jt.eot]},
        {"seek": seek, "start": seek / 100 + 2.5, "end": seek / 100 + 7.5,
         "tokens": [7, 8, 9, 10, 11]},
    ]
    ours, theirs = copy.deepcopy(segments), copy.deepcopy(segments)
    align.add_word_timestamps(segments=ours, model_obj=None, tokenizer=tt, mel=None,
                              num_frames=3000, last_speech_timestamp=last_speech)
    jalign.add_word_timestamps(segments=theirs, model_obj=None, tokenizer=jt, mel=None,
                               num_frames=3000, last_speech_timestamp=last_speech)
    assert ours == theirs
    assert all(seg["words"] for seg in ours)


def _seg(start, end, words):
    return {"start": start, "end": end, "words": [
        {"word": w, "start": s, "end": e, "probability": p} for w, s, e, p in words]}


SKIP_SEGMENTS = [
    [_seg(0.5, 3.0, [(" a", 0.5, 0.55, 0.05), (" b", 0.55, 3.0, 0.1)]),
     _seg(9.0, 12.0, [(" fine", 9.0, 9.5, 0.9), (" words", 9.5, 10.0, 0.9)])],
    [_seg(4.0, 5.0, [(" x", 4.0, 4.05, 0.9)]), _seg(5.0, 6.0, [(" y", 5.0, 9.5, 0.9)]),
     _seg(20.0, 21.0, [(" z", 20.0, 20.1, 0.1)])],
    [_seg(1.0, 2.0, [(" ok", 1.0, 1.4, 0.9), (" good", 1.4, 2.0, 0.8)])],
]


@pytest.mark.parametrize("case", range(len(SKIP_SEGMENTS)))
@pytest.mark.parametrize("window_start", [0.0, 30.0])
def test_hallucination_skipper_equal(case, window_start):
    segs = [{**s, "start": s["start"] + window_start, "end": s["end"] + window_start,
             "words": [{**w, "start": w["start"] + window_start,
                        "end": w["end"] + window_start} for w in s["words"]]}
            for s in SKIP_SEGMENTS[case]]
    kw = dict(threshold=2.0, window_start=window_start, window_end=window_start + 30.0,
              previous_seek=int(window_start * 100), segment_size=3000,
              segment_duration=30.0, content_duration=65.0, content_frames=6500)
    ours, theirs = _HallucinationSkipper(**kw), JSkipper(**kw)
    for last_speech in (0.0, window_start + 0.5):
        assert ours.trailing_silence_seek(copy.deepcopy(segs)) == \
            theirs.trailing_silence_seek(copy.deepcopy(segs))
        assert ours.leading_anomaly_seek(copy.deepcopy(segs)) == \
            theirs.leading_anomaly_seek(copy.deepcopy(segs))
        assert ours.drop_surrounded_anomaly(copy.deepcopy(segs), last_speech) == \
            theirs.drop_surrounded_anomaly(copy.deepcopy(segs), last_speech)


@pytest.mark.parametrize("name", sorted(_ALIGNMENT_HEADS))
def test_set_alignment_heads_equal(name):
    assert _ALIGNMENT_HEADS[name] == J_HEADS[name]
    ours = WhisperModel(dims_for(name), None)
    theirs = JModel({}, jdims_for(name))
    ours.set_alignment_heads(_ALIGNMENT_HEADS[name])
    theirs.set_alignment_heads(J_HEADS[name])
    np.testing.assert_array_equal(ours.alignment_heads, theirs.alignment_heads)
    np.testing.assert_array_equal(ours.default_alignment_heads(),
                                  theirs.default_alignment_heads())


def test_model_handle_equal(models, toks):
    """embed_audio, logits and forward of the handle vs the JAX handle's."""
    jm, tm = models
    _, tokens, _ = _inputs(toks)
    mel = np.random.default_rng(6).standard_normal((1, 80, 3000)).astype(np.float32)
    feats = tm.embed_audio(torch.from_numpy(mel))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jm.embed_audio(jnp.asarray(mel))),
                               atol=1e-4, rtol=0)
    tok = np.asarray([tokens])
    np.testing.assert_allclose(tm.logits(tok, feats).numpy(),
                               np.asarray(jm.logits(jnp.asarray(tok), jnp.asarray(
                                   feats.numpy()))), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tm(mel, tok).numpy(),
                               np.asarray(jm(jnp.asarray(mel), jnp.asarray(tok))),
                               atol=1e-4, rtol=0)
    assert tm.compute_dtype == torch.float32
