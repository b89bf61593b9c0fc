"""The plain reference against the port at a small size on the CPU (float32
on both sides): the yardstick and the program agree where both are right."""

import numpy as np
import pytest
import torch

import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.audio import mel_filters, wire_pcm16
from qasr_ijcnlp_tpu_torch.decode import DecodingTask
from qasr_ijcnlp_tpu_torch.models import whisper as pw
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions

from portbench.reference import train as rt
from portbench.reference import whisper as ref
from portbench.weights import make_pcm, make_weights

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2)


@pytest.fixture(scope="module")
def setup():
    w = make_weights(DIMS, 11, "cpu")
    model = port.WhisperModel.from_state_dict(w, ModelDimensions(**DIMS), device="cpu")
    pcm = make_pcm(2, ref.N_SAMPLES, 11, "cpu")
    return w, model, pcm


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank(n_mels):
    np.testing.assert_allclose(ref.mel_filterbank(n_mels), mel_filters(n_mels), atol=1e-7)


def test_log_mel(setup):
    _, _, pcm = setup
    with ref.exact_fp32():
        got = port.log_mel_spectrogram(pcm, 80, device="cpu")
        want = ref.log_mel(torch.from_numpy(pcm), 80)
    assert got.shape == want.shape == (2, 80, 3000)
    assert float((got - want).abs().max()) < 2e-4


def test_encoder_and_decoder(setup):
    w, model, pcm = setup
    with ref.exact_fp32(), torch.no_grad():
        mel = ref.log_mel(torch.from_numpy(pcm), 80)
        xa = ref.encoder(w, mel, DIMS)
        got = pw.encoder_apply(model.module.encoder, mel, model.dims)
        assert float((got - xa).abs().max()) < 1e-4
        tokens = torch.tensor([ref.prompt_tokens(DIMS["n_vocab"]) + [220, 1000, 7]] * 2)
        want = ref.decoder(w, tokens, xa, DIMS)
        got = pw.decoder_apply(model.module.decoder, tokens, xa, model.dims)
        assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("n_vocab", [51865, 51866])
def test_special_tokens_match_the_tokenizer(n_vocab):
    dims = ModelDimensions(**dict(DIMS, n_vocab=n_vocab, n_mels=128 if n_vocab == 51866 else 80))
    model = port.WhisperModel(dims, None)
    model.module = type("M", (), {"decoder": type("D", (), {
        "positional_embedding": torch.zeros(1)})()})()
    options = port.DecodingOptions(language="en", without_timestamps=True, suppress_tokens=[50257],
                                   suppress_blank=False)
    task = DecodingTask(model, options)
    assert list(task.initial_tokens) == ref.prompt_tokens(n_vocab)
    assert list(task._get_suppress_tokens()) == ref.suppressed_tokens(n_vocab)


def test_wire_audio_matches_the_engine():
    pcm = make_pcm(1, 160000, 5, "cpu")[0]
    codes, scale = wire_pcm16(pcm)
    np.testing.assert_array_equal(ref.wire_int16(pcm), codes.astype(np.float32) * np.float32(scale))


def test_served_numbers_of_the_ports_own_decode(setup):
    w, model, pcm = setup
    options = port.DecodingOptions(language="en", without_timestamps=True, sample_len=6,
                                   suppress_tokens=[50257], suppress_blank=False, fp16=False)
    results = port.decode(model, port.log_mel_spectrogram(pcm, 80, device="cpu"), options)
    items = [(pcm[i], r.tokens, r.avg_logprob, r.audio_features) for i, r in enumerate(results)]
    got = ref.served_numbers(w, DIMS, items, "cpu", control=ref.Precision("fp8"))
    assert got["served_gap_max"] == 0.0 and got["rows"] == 2 and got["tokens"] == 12
    assert got["avg_logprob_gap"] < 1e-5 and got["encoder_rel_err"] < 1e-5
    assert got["control_encoder_rel_err"] > 100 * got["encoder_rel_err"]


def test_adamw_step_matches_the_ports(setup):
    from qasr_ijcnlp_tpu_torch.train.step import (
        init_state, make_optimizer, make_train_step, whisper_loss_fn,
    )

    w, _, pcm = setup
    mel = ref.log_mel(torch.from_numpy(pcm), 80)
    tokens = torch.tensor([ref.prompt_tokens(DIMS["n_vocab"]) + [5, 6, 7, 8]] * 2)
    model = port.WhisperModel.from_state_dict({k: v.clone() for k, v in w.items()},
                                              ModelDimensions(**DIMS), device="cpu")
    module = model.module.requires_grad_(True)
    tx = make_optimizer(1e-3, 0.01, 0.9, 0.98, 1e-6, 1.0)
    state = init_state(module, tx)
    with ref.exact_fp32():
        state, metrics = make_train_step(whisper_loss_fn(model.dims, "float32"), tx)(
            state, mel, tokens)
    mine = {k: v.clone() for k, v in w.items()}
    hyper = dict(lr=1e-3, weight_decay=0.01, b1=0.9, b2=0.98, eps=1e-6, clip_norm=1.0)
    out = rt.reference_steps(mine, DIMS, [(mel, tokens)], hyper, rows=1)
    assert out["losses"][0] == pytest.approx(float(metrics["loss"]), abs=1e-5)
    for name, p in module.named_parameters():
        assert float((p.detach() - mine[name]).abs().max()) < 1e-5, name
