"""Port decode() (qasr_ijcnlp_tpu_torch/decode/) vs JAX decode(), and the
slice as a whole: PCM -> log-mel -> encoder -> greedy decode -> text.

Greedy decode at f32 must be token-exact and text-equal, with and without
timestamps.  A subprocess checks that the port runs a request and a short
long-form transcription without importing JAX or the JAX package.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import audio as jaudio
from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions, decode as jdecode
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
import qasr_ijcnlp_tpu_torch as port
from tests.torch_port_common import DIMS, jax_params, torch_model

EOT = 50257
BENCH = dict(language="en", without_timestamps=True, sample_len=12,
             suppress_tokens=[EOT], suppress_blank=False)


@pytest.fixture(scope="module")
def models():
    params = jax_params(0)
    jm = JModel(jax.tree.map(jnp.asarray, params), DIMS)
    return jm, torch_model(params)


@pytest.fixture(scope="module")
def pcm():
    return (np.random.default_rng(8).standard_normal((2, 1000 * 160)) * 0.2).astype(
        np.float32)


def _tokens(results):
    return [r.tokens for r in results], [r.text for r in results]


@pytest.mark.parametrize("opts", [
    dict(BENCH),
    dict(language="en", sample_len=10),  # timestamp rules on
], ids=["without_timestamps", "with_timestamps"])
def test_decode_token_exact_vs_jax(models, opts):
    jm, tm = models
    mel = np.random.default_rng(9).standard_normal((2, 80, 1000)).astype(np.float32)
    ref = jdecode(jm, jnp.asarray(mel), JOptions(fp16=False, **opts))
    ours = port.decode(tm, mel, port.DecodingOptions(fp16=False, **opts))
    assert _tokens(ours) == _tokens(ref)
    for a, b in zip(ours, ref):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-5)


def test_slice_pcm_to_text_matches_jax(models, pcm):
    jm, tm = models
    ref = jdecode(jm, jaudio.log_mel_spectrogram(pcm), JOptions(**BENCH))
    ours = port.decode(tm, port.log_mel_spectrogram(pcm, device="cpu"),
                       port.DecodingOptions(**BENCH))
    assert _tokens(ours) == _tokens(ref)
    assert all(len(r.tokens) == BENCH["sample_len"] for r in ours)


def test_detect_language_matches_jax(models):
    jm, tm = models
    mel = np.random.default_rng(10).standard_normal((2, 80, 1000)).astype(np.float32)
    ref_tok, ref_probs = jm.detect_language(jnp.asarray(mel))
    tok, probs = tm.detect_language(mel)
    np.testing.assert_array_equal(tok, np.asarray(ref_tok))
    for a, b in zip(probs, ref_probs):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a], atol=1e-5)


@pytest.mark.parametrize("opts", [
    dict(BENCH),
    dict(language="en", sample_len=10),  # timestamp rules on
], ids=["without_timestamps", "with_timestamps"])
def test_decode_kv_int8_matches_jax(models, opts):
    """Greedy decode over the int8 cross cache: the same tokens as the JAX
    package's (its int8 kernel in interpret mode), logprobs within 1e-3."""
    jm, tm = models
    mel = np.random.default_rng(14).standard_normal((2, 80, 1000)).astype(np.float32)
    ref = jdecode(jm, jnp.asarray(mel), JOptions(fp16=False, kv_int8=True, **opts))
    ours = port.decode(tm, mel, port.DecodingOptions(fp16=False, kv_int8=True, **opts))
    assert _tokens(ours) == _tokens(ref)
    for a, b in zip(ours, ref):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-3)
        assert a.avg_logprob * (len(a.tokens) + 1) == pytest.approx(
            b.avg_logprob * (len(b.tokens) + 1), abs=1e-3)  # sum_logprobs


@pytest.mark.parametrize("kw", [dict(draft=None)], ids=["draft"])
def test_unported_options_raise(models, kw):
    """``draft``, the last option the port refused, now decodes: prompt
    lookup gives JAX's greedy tokens (tests/test_torch_speculative.py holds
    the model drafts and the round counts)."""
    from qasr_ijcnlp_tpu.decode import Draft as JDraft
    from qasr_ijcnlp_tpu_torch.decode import Draft

    jm, tm = models
    mel = np.random.default_rng(15).standard_normal((2, 80, 1000)).astype(np.float32)
    ref = jdecode(jm, jnp.asarray(mel), JOptions(fp16=False, draft=JDraft(kw["draft"], 2),
                                                 **BENCH))
    ours = port.decode(tm, mel, port.DecodingOptions(fp16=False, draft=Draft(kw["draft"], 2),
                                                     **BENCH))
    assert _tokens(ours) == _tokens(ref)


def test_sampling_is_seeded_by_generator(models):
    _, tm = models
    mel = np.random.default_rng(11).standard_normal((2, 80, 1000)).astype(np.float32)
    opts = port.DecodingOptions(temperature=0.8, **BENCH)
    a = port.decode(tm, mel, opts, generator=torch.Generator().manual_seed(3))
    b = port.decode(tm, mel, opts, generator=torch.Generator().manual_seed(3))
    assert _tokens(a) == _tokens(b)


def test_port_runs_without_jax():
    code = textwrap.dedent("""
        import sys
        for blocked in ("jax", "optax", "orbax", "qasr_ijcnlp_tpu"):
            sys.modules[blocked] = None  # any import of them raises ImportError
        import numpy as np, torch
        torch.set_num_threads(1)  # beside the other pytest workers
        import qasr_ijcnlp_tpu_torch as port
        from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
        from qasr_ijcnlp_tpu_torch.models.whisper import init_params
        dims = ModelDimensions(80, 500, 128, 2, 1, 51865, 48, 128, 2, 1)
        m = port.WhisperModel.from_state_dict(
            init_params(torch.Generator().manual_seed(0), dims), dims, "cpu")
        pcm = np.zeros(1000 * 160, np.float32)
        r = port.decode(m, port.log_mel_spectrogram(pcm, device="cpu"), language="en",
                        sample_len=4, without_timestamps=True)
        assert len(r.tokens) <= 4
        from qasr_ijcnlp_tpu_torch import align, serving, streaming, transcribe  # noqa: F401
        from qasr_ijcnlp_tpu_torch.cli import transcribe as cli  # noqa: F401
        from qasr_ijcnlp_tpu_torch.decode import Draft, engine, speculative  # noqa: F401
        from qasr_ijcnlp_tpu_torch import data, metrics, reporting  # noqa: F401
        from qasr_ijcnlp_tpu_torch.cli import (  # noqa: F401
            evaluate_quantum_whisper_asr, evaluate_whisper_pretrained_modified_gspeech)
        from qasr_ijcnlp_tpu_torch.models import asr, classifier, quantum
        from qasr_ijcnlp_tpu_torch.train import checkpoint, loops  # noqa: F401
        q = quantum.QuantumWhisperModel.from_state_dict(
            quantum.init_quantum_params(torch.Generator().manual_seed(0), dims, 3), dims, "cpu")
        qr = port.decode(q, port.log_mel_spectrogram(pcm, device="cpu"), language="en",
                         sample_len=4, without_timestamps=True)
        assert len(qr.tokens) <= 4
        assert metrics.calculate_wer(["a b"], ["a c"]) == 0.5
        s = port.decode(m, port.log_mel_spectrogram(pcm, device="cpu"), language="en",
                        sample_len=4, without_timestamps=True, draft=Draft(None, 2))
        assert s.tokens == r.tokens
        lf = ModelDimensions(80, 1500, 128, 2, 1, 51865, 48, 128, 2, 1)
        m = port.WhisperModel.from_state_dict(
            init_params(torch.Generator().manual_seed(0), lf), lf, "cpu")
        out = m.transcribe(np.zeros(16000 * 3, np.float32), language="en", sample_len=4,
                           temperature=0.0, word_timestamps=True)
        assert out["language"] == "en" and out["segments"], out
        from qasr_ijcnlp_tpu_torch import train
        from qasr_ijcnlp_tpu_torch.cli import (  # noqa: F401
            evaluate_pretrained_whisper, evaluate_pretrained_whisper_asr,
            train_classical_whisper_asr, train_quantum_whisper, train_quantum_whisper_asr)
        m.module.requires_grad_(True)
        tx = train.make_optimizer(train.warmup_cosine(1e-3, 0, 4))
        state = train.init_state(m.module, tx)
        step = train.make_train_step(train.whisper_loss_fn(lf), tx)
        w0 = m.module.decoder.ln.bias.clone()
        mel = port.log_mel_spectrogram(np.zeros((1, 16000), np.float32), device="cpu")
        state, met = step(state, torch.nn.functional.pad(mel, (0, 3000 - mel.shape[-1])),
                          torch.tensor([[50258, 50359, 440, 50257]]))
        assert int(state.step) == 1 and int(met["skipped"]) == 0
        assert torch.isfinite(met["loss"]) and not torch.equal(w0, m.module.decoder.ln.bias)
        from qasr_ijcnlp_tpu_torch import export, profiling  # noqa: F401
        from qasr_ijcnlp_tpu_torch.cli import (  # noqa: F401
            distill_draft, export_decode, train_whisper_from_scratch)
        from qasr_ijcnlp_tpu_torch.models import quantize
        from qasr_ijcnlp_tpu_torch.ops import library  # noqa: F401
        from qasr_ijcnlp_tpu_torch.tokenizer import bpe
        from qasr_ijcnlp_tpu_torch.train import distill  # noqa: F401
        assert bpe.get_encoding("gpt2")._native is not None
        q = quantize.quantize_params(m.module, lf)
        assert q["decoder.token_embedding.weight"]["q"].dtype == torch.int8
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "optax", "orbax", "qasr_ijcnlp_tpu")
               and sys.modules[k] is not None]
        assert not bad, bad
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
