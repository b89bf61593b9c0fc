"""Port long-form transcription (qasr_ijcnlp_tpu_torch/transcribe/) vs the
JAX package's.

On seeded speech-like PCM of 65 s (three windows, the last one partial) the
port's transcript must equal JAX's: segments, tokens, text, seek and words
equal, every float within 1e-4.  Cases: the sequential seek loop with
previous-text conditioning and an initial prompt, ``batch_windows`` with
``clip_timestamps``, and language detection, each with word timestamps on
and off, at temperature 0 with the thresholds off.  The temperature
ladder, the no-speech skip and the prompt reset run in both packages on one
scripted stub model; the writers must write the same bytes.
"""

import copy
import io
import json

import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import transcribe as jtranscribe
from qasr_ijcnlp_tpu.decode import DecodingResult as JResult
from qasr_ijcnlp_tpu.transcribe.writers import get_writer as jget_writer
from qasr_ijcnlp_tpu_torch import transcribe as ttranscribe
from qasr_ijcnlp_tpu_torch.decode import DecodingResult
from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer
from qasr_ijcnlp_tpu_torch.transcribe.writers import get_writer
from tests.torch_port_common import (  # noqa: F401
    LF_DIMS, lf_models, one_torch_thread, speechlike_pcm,
)

GREEDY = dict(temperature=0.0, compression_ratio_threshold=None, logprob_threshold=None,
              no_speech_threshold=None, fp16=False)
# (transcribe options, seconds of the PCM fixture).  Each prompt length
# costs the JAX side a decode compile, so only the sequential case
# conditions on the previous text; detection needs no third window.
CASES = {
    "sequential": (dict(language="en", condition_on_previous_text=True,
                        initial_prompt="hello there"), 65),
    "batched_clips": (dict(language="en", batch_windows=2, clip_timestamps="3,40,45"), 65),
    "detect_language": (dict(language=None, condition_on_previous_text=False), 35),
}
FLOATS = ("start", "end", "temperature", "avg_logprob", "compression_ratio",
          "no_speech_prob")


@pytest.fixture(scope="module")
def models():
    return lf_models(0)


@pytest.fixture(scope="module")
def pcm():
    return speechlike_pcm(65.0)


def assert_same_transcript(ours, theirs):
    assert ours["language"] == theirs["language"]
    assert ours["text"] == theirs["text"]
    assert len(ours["segments"]) == len(theirs["segments"])
    for a, b in zip(ours["segments"], theirs["segments"]):
        assert set(a) == set(b)
        for key in ("id", "seek", "tokens", "text"):
            assert a[key] == b[key], key
        for key in FLOATS:
            assert a[key] == pytest.approx(b[key], abs=1e-4), key
        assert len(a.get("words", [])) == len(b.get("words", []))
        for wa, wb in zip(a.get("words", []), b.get("words", [])):
            assert wa["word"] == wb["word"]
            for key in ("start", "end", "probability"):
                assert wa[key] == pytest.approx(wb[key], abs=1e-4), key


@pytest.mark.parametrize("words", [False, True], ids=["no_words", "words"])
@pytest.mark.parametrize("case", CASES)
def test_transcribe_equal(models, pcm, case, words):
    jm, tm = models
    options, seconds = CASES[case]
    kw = dict(GREEDY, word_timestamps=words, **options)
    pcm = pcm[: 16000 * seconds]
    theirs = jtranscribe.transcribe(jm, pcm, **copy.deepcopy(kw))
    ours = tm.transcribe(pcm, **copy.deepcopy(kw))
    assert len(ours["segments"]) >= 3
    if words:
        assert any(seg["words"] for seg in ours["segments"])
    windows = len({seg["seek"] for seg in ours["segments"]})
    assert windows >= (3 if seconds > 60 else 2)
    assert_same_transcript(ours, theirs)


def test_seeded_generator_repeats(models, pcm):
    """Sampling rungs draw from the caller's generator: one seed, one
    transcript."""
    _, tm = models
    kw = dict(GREEDY, temperature=0.8, language="en")
    a = tm.transcribe(pcm[: 16000 * 35], generator=torch.Generator().manual_seed(3), **kw)
    b = tm.transcribe(pcm[: 16000 * 35], generator=torch.Generator().manual_seed(3), **kw)
    assert a == b
    assert all(seg["temperature"] == 0.8 for seg in a["segments"])


def test_engine_raises(models, pcm):
    """``engine=`` (once refused) runs the t = 0 rung through a decode
    engine whose options match: the same tokens and text as without it
    (tests/test_torch_engine.py holds the rest)."""
    from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine

    _, tm = models
    kw = dict(GREEDY, language="en", sample_len=6)
    plain = tm.transcribe(pcm[:16000], **kw)
    engine = DecodeEngine(tm, ttranscribe.DecodingOptions(language="en", fp16=False,
                                                          sample_len=6), slots=1)
    try:
        ours = tm.transcribe(pcm[:16000], engine=engine, **kw)
        assert engine.admit_calls == 1
    finally:
        engine.close()
    assert ours["text"] == plain["text"]
    assert [s["tokens"] for s in ours["segments"]] == [s["tokens"] for s in plain["segments"]]


# -- the ladder, the no-speech skip and the prompt reset on a stub model -------------

class StubModel:
    """A model whose ``decode`` returns scripted results, one per call, and
    records each call's (temperature, prompt)."""

    def __init__(self, result_cls, script):
        self.dims = LF_DIMS
        self.is_multilingual = True
        self.num_languages = 99
        self.device = torch.device("cpu")
        self.result_cls = result_cls
        self.script = list(script)
        self.calls = []

    def decode(self, mel, options, **_):
        tokens, avg_logprob, ratio, no_speech = self.script[len(self.calls)]
        self.calls.append((float(options.temperature), list(options.prompt or [])))
        return self.result_cls(audio_features=None, language="en", tokens=list(tokens),
                               text="", avg_logprob=avg_logprob, no_speech_prob=no_speech,
                               temperature=options.temperature, compression_ratio=ratio)


def _script():
    tok = get_tokenizer(True, num_languages=99, language="en", task="transcribe")
    ts = tok.timestamp_begin
    text = tok.encode(" hello world")
    seg = [ts, *text, ts + 1000]  # single timestamp ending: the window advances whole
    ok, repeat, unsure = (seg, -0.3, 1.2, 0.1), (seg, -0.3, 3.0, 0.1), (seg, -2.0, 1.2, 0.1)
    silence = (seg, -1.5, 1.2, 0.9)
    return [
        repeat, unsure, ok,  # window 0: two failed rungs, accepted at 0.4
        silence,  # window 1: accepted as silence at t 0, then skipped
        repeat, unsure, repeat, ok,  # window 2: accepted at 0.6 -> prompt reset
        ok,  # window 3: an empty prompt after the reset
        ok,  # window 4 (500 frames)
    ]


def test_ladder_skip_and_prompt_reset_equal():
    pcm = speechlike_pcm(125.0, seed=9)
    kw = dict(temperature=(0.0, 0.2, 0.4, 0.6, 0.8), language="en",
              initial_prompt="once upon a time")
    ours_model = StubModel(DecodingResult, _script())
    theirs_model = StubModel(JResult, _script())
    ours = ttranscribe.transcribe(ours_model, pcm, **kw)
    theirs = jtranscribe.transcribe(theirs_model, pcm, **kw)
    assert ours_model.calls == theirs_model.calls
    assert [t for t, _ in ours_model.calls] == [0.0, 0.2, 0.4, 0.0, 0.0, 0.2, 0.4, 0.6,
                                                0.0, 0.0]
    assert ours_model.calls[3][1] == ours_model.calls[4][1] != []
    assert ours_model.calls[8][1] == []
    assert ours == theirs
    assert [seg["seek"] for seg in ours["segments"]] == [0, 6000, 9000, 12000]


# -- writers ------------------------------------------------------------------------

def _result(with_words=True):
    words = [
        [(" Hello", 0.0, 0.4, 0.9), (" world,", 0.4, 0.8, 0.8), (" this", 1.2, 1.5, 0.95),
         (" is", 1.5, 1.6, 0.97), (" a", 1.6, 1.65, 0.99), (" test.", 1.65, 2.2, 0.85)],
        [(" Second", 6.0, 6.5, 0.9), (" segment", 6.5, 7.1, 0.92),
         (" here.", 7.1, 7.4, 0.88)],
        [(" Tab\there", 3601.0, 3601.5, 0.5), (" ünïcode", 3601.5, 3602.25, 0.6)],
    ]
    texts = [" Hello world, this is a test.", " Second segment here.",
             " Tab\there ünïcode"]
    spans = [(0.0, 2.2), (6.0, 7.4), (3601.0, 3602.25)]
    segments = []
    for i, (text, (start, end), ws) in enumerate(zip(texts, spans, words)):
        seg = {"id": i, "seek": 0, "start": start, "end": end, "text": text,
               "tokens": [1, 2, 3], "temperature": 0.0, "avg_logprob": -0.3,
               "compression_ratio": 1.2, "no_speech_prob": 0.01}
        if with_words:
            seg["words"] = [{"word": w, "start": s, "end": e, "probability": p}
                            for w, s, e, p in ws]
        segments.append(seg)
    return {"text": "".join(texts), "segments": segments, "language": "en"}


WRITER_OPTS = [
    {},
    {"highlight_words": True},
    {"max_line_width": 12, "max_line_count": 2},
    {"max_words_per_line": 2},
    {"max_line_width": 10, "max_line_count": 1, "highlight_words": True},
]


@pytest.mark.parametrize("with_words", [True, False])
@pytest.mark.parametrize("opts", range(len(WRITER_OPTS)))
@pytest.mark.parametrize("fmt", ["txt", "vtt", "srt", "tsv", "json"])
def test_writer_bytes_equal(tmp_path, fmt, opts, with_words):
    result = _result(with_words)
    ours, theirs = io.StringIO(), io.StringIO()
    get_writer(fmt, str(tmp_path)).write_result(copy.deepcopy(result), file=ours,
                                                **WRITER_OPTS[opts])
    jget_writer(fmt, str(tmp_path)).write_result(copy.deepcopy(result), file=theirs,
                                                 **WRITER_OPTS[opts])
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue()


@pytest.mark.parametrize("opts", range(len(WRITER_OPTS)))
def test_writer_all_files_equal(tmp_path, opts):
    (tmp_path / "ours").mkdir()
    (tmp_path / "theirs").mkdir()
    result = _result()
    get_writer("all", str(tmp_path / "ours"))(copy.deepcopy(result), "dir/talk.flac",
                                               WRITER_OPTS[opts])
    jget_writer("all", str(tmp_path / "theirs"))(copy.deepcopy(result), "dir/talk.flac",
                                                 WRITER_OPTS[opts])
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == [f"talk.{ext}" for ext in ("json", "srt", "tsv", "txt", "vtt")]
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()
    assert json.loads((tmp_path / "ours" / "talk.json").read_text()) == result
