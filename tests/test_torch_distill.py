"""Draft distillation (``train/distill.py``), its CLI (``cli/distill_draft``)
and the from-scratch trainer CLI (``cli/train_whisper_from_scratch``)
against the JAX package's, on the CPU.

At JAX's ``tests/test_distill.py`` geometry (a two-layer width-64 teacher,
a one-layer width-32 student, n_audio_ctx 50, the real vocabulary; JAX
``init`` moved to the port through numpy): the distillation loss, the
teacher's labels and the agreement equal JAX's, a port-only distillation
meets JAX's bar (held-out agreement up by more than 0.25, the KL halved),
and a distilled draft keeps speculative decoding token-exact.  The CLIs
run at n_audio_ctx 1500 on the synthetic sets from one weight set on both
sides, as ``tests/test_torch_train_cli.py`` runs the other trainers: the
final KL and the from-scratch trainer's epoch losses within 1e-4 relative,
agreements exactly, and the port's checkpoints read by JAX's loaders
(``load_pytree``; the draft's ``.pt`` by JAX's ``load_torch_checkpoint``)
near JAX's values (a few Adam steps at 1e-3: 2e-5).
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.cli import distill_draft as jdd
from qasr_ijcnlp_tpu.cli import train_whisper_from_scratch as jfs
from qasr_ijcnlp_tpu.data import SyntheticLibriSpeech as JLibri
from qasr_ijcnlp_tpu.models import asr as jasr, quantum as jqm
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.convert import load_torch_checkpoint as jload_pt
from qasr_ijcnlp_tpu.models.dims import ModelDimensions
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
from qasr_ijcnlp_tpu.train import checkpoint as jckpt
from qasr_ijcnlp_tpu.train import distill as jdistill
from qasr_ijcnlp_tpu_torch.cli import distill_draft as tdd
from qasr_ijcnlp_tpu_torch.cli import train_whisper_from_scratch as tfs
from qasr_ijcnlp_tpu_torch.data import SyntheticLibriSpeech
from qasr_ijcnlp_tpu_torch.decode import DecodingOptions, Draft, decode
from qasr_ijcnlp_tpu_torch.models import asr, convert, quantum
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.train import distill
from tests.torch_port_common import one_torch_thread  # noqa: F401

T_DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=50, n_audio_state=64, n_audio_head=2,
    n_audio_layer=2, n_vocab=51865, n_text_ctx=48, n_text_state=64,
    n_text_head=2, n_text_layer=2,
)
S_DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=50, n_audio_state=32, n_audio_head=2,
    n_audio_layer=1, n_vocab=51865, n_text_ctx=48, n_text_state=32,
    n_text_head=2, n_text_layer=1,
)


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mels(batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, 80, 100)).astype(np.float32)


def _pair(tree, dims, name):
    return (JModel(jax.tree.map(jnp.asarray, tree), dims, name=name),
            WhisperModel.from_state_dict(convert.from_jax_params(tree, dims), dims, "cpu",
                                         name=name))


@pytest.fixture(scope="module")
def models():
    """(JAX teacher, JAX student, port teacher, port student)."""
    jt, tt = _pair(_tree(jmodel.init_params(jax.random.PRNGKey(0), T_DIMS)), T_DIMS, "teacher")
    js, ts = _pair(_tree(jmodel.init_params(jax.random.PRNGKey(1), S_DIMS)), S_DIMS, "student")
    return jt, js, tt, ts


@pytest.fixture(scope="module")
def held(models):
    """A held-out batch and the teacher's labels of it, from both packages."""
    jt, _, tt, _ = models
    mel = _mels(4, 12)
    return mel, jdistill.make_teacher_labeler(jt, sample_len=12)(mel), \
        distill.make_teacher_labeler(tt, sample_len=12)(mel)


def test_teacher_labels_equal_jax(held):
    _, jlabels, tlabels = held
    assert tlabels.dtype == np.int32 and tlabels.shape == jlabels.shape == (4, 4 + 12 + 1)
    np.testing.assert_array_equal(tlabels, jlabels)
    assert (tlabels[:, 0] >= 0).all()


def test_loss_and_agreement_equal_jax(models, held):
    """The KL at tau 1 and 2 (a label row cut short by -100 included) and
    the agreement rate, on the same weights and tokens."""
    jt, js, tt, ts = models
    mel, labels, _ = held
    labels = labels.copy()
    labels[1, 9:] = -100
    for tau in (1.0, 2.0):
        want = jdistill.distill_loss_fn(T_DIMS, S_DIMS, tau=tau)(
            js.params, jt.params, jnp.asarray(mel), jnp.asarray(labels))
        got = distill.distill_loss_fn(T_DIMS, S_DIMS, tau=tau)(
            ts.module, tt.module, torch.from_numpy(mel), torch.from_numpy(labels))
        assert float(got) == pytest.approx(float(want), rel=1e-4)
    assert distill.agreement_rate(tt, ts, mel, labels) == \
        jdistill.agreement_rate(jt, js, mel, labels)


def test_distill_improves_teacher_agreement(models, held):
    """JAX's bar, on the port alone: 100 steps at lr 1e-2 over two batches
    (JAX takes 400 at 3e-3) raise the held-out agreement by more than 0.25
    and halve the KL."""
    _, _, tt, ts = models
    student = WhisperModel.from_state_dict(
        {k: v.clone() for k, v in ts.module.state_dict().items()}, S_DIMS, "cpu")
    mel, _, labels = held
    before = distill.agreement_rate(tt, student, mel, labels)
    student, history = distill.distill_draft(
        tt, student, [_mels(4, s) for s in (10, 11)], steps=100, learning_rate=1e-2,
        sample_len=12, log_every=20)
    after = distill.agreement_rate(tt, student, mel, labels)
    assert after > before + 0.25, (before, after)
    assert history[-1][1] < history[0][1] * 0.5, history
    assert [s for s, _ in history] == [20, 40, 60, 80, 100]
    assert not any(p.requires_grad for p in student.module.parameters())


def test_distilled_draft_stays_token_exact(models):
    _, _, tt, ts = models
    student = WhisperModel.from_state_dict(
        {k: v.clone() for k, v in ts.module.state_dict().items()}, S_DIMS, "cpu")
    student, _ = distill.distill_draft(tt, student, [_mels(4, 20)], steps=30,
                                       learning_rate=3e-3, sample_len=8)
    mel = torch.from_numpy(_mels(2, 21))
    base = decode(tt, mel, DecodingOptions(fp16=False, language="en", sample_len=10))
    spec = decode(tt, mel, DecodingOptions(fp16=False, language="en", sample_len=10,
                                           draft=Draft(student, 3)))
    for b, s in zip(base, spec):
        assert list(s.tokens) == list(b.tokens)


# -- the CLIs ---------------------------------------------------------------------------

CLI_T = ModelDimensions(80, 1500, 64, 2, 2, 51865, 48, 64, 2, 2)
CLI_S = ModelDimensions(80, 1500, 64, 2, 1, 51865, 48, 64, 2, 1)


def test_distill_cli_matches_jax(tmp_path, monkeypatch):
    """Two distillation steps through both CLIs from one weight set: the
    final KL, the agreement before and after, and the saved drafts."""
    trees = {"teacher": (_tree(jmodel.init_params(jax.random.PRNGKey(4), CLI_T)), CLI_T),
             "draft": (_tree(jmodel.init_params(jax.random.PRNGKey(5), CLI_S)), CLI_S)}
    monkeypatch.setattr(jdd, "load_model_with_fallback", lambda name: JModel(
        jax.tree.map(jnp.asarray, trees[name][0]), trees[name][1], name=name))
    monkeypatch.setattr(tdd, "load_model_with_fallback", lambda name, device: (
        WhisperModel.from_state_dict(convert.from_jax_params(*trees[name]), trees[name][1],
                                     device, name=name)))
    monkeypatch.setattr(jdd, "load_librispeech", lambda split, n: JLibri(split, n))
    monkeypatch.setattr(tdd, "load_librispeech", lambda split, n: SyntheticLibriSpeech(split, n))
    argv = ["--model", "teacher", "--draft", "draft", "--steps", "2", "--batch_size", "2",
            "--n_batches", "2", "--sample_len", "6", "--device", "cpu"]
    ref = jdd.main(argv + ["--out", str(tmp_path / "jax.pt")])
    got = tdd.main(argv + ["--out", str(tmp_path / "port.pt")])
    assert (got["before"], got["after"]) == (ref["before"], ref["after"])
    assert [s for s, _ in got["history"]] == [s for s, _ in ref["history"]] == [2]
    assert got["history"][0][1] == pytest.approx(ref["history"][0][1], rel=1e-4)
    mine, mdims = jload_pt(str(tmp_path / "port.pt"))
    theirs, tdims = jload_pt(str(tmp_path / "jax.pt"))
    assert mdims == tdims == CLI_S
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=2e-5)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tdd.main(["--device", "auto"])


FS_DIMS = ModelDimensions(80, 1500, 128, 2, 1, 51865, 48, 128, 2, 1)


def test_from_scratch_cli_matches_jax(tmp_path, monkeypatch):
    """Two epochs of the 8-qubit quantum stem + random trunk + LSTM head
    through both CLIs, nothing frozen: JAX's history, and best checkpoints
    that JAX's ``load_pytree`` reads, trunk weights moved by training."""
    q = _tree(jqm.init_quantum_params(jax.random.PRNGKey(0), FS_DIMS, 8))
    for mod in (jfs, tfs):
        monkeypatch.setattr(mod, "tiny_dims", lambda: FS_DIMS)
    monkeypatch.setattr(jfs, "init_quantum_params", lambda key, dims, n_qubits: jax.tree.map(
        jnp.asarray, q))
    monkeypatch.setattr(tfs, "init_quantum_params", lambda gen, dims, n_qubits:
                        convert.from_jax_params(q, FS_DIMS))
    head = {}

    def jhead(key, enc_dim, num_chars, hidden, layers):
        head["tree"] = _tree(jasr.init_lstm_decoder(jax.random.PRNGKey(1), enc_dim, num_chars,
                                                    hidden, layers))
        return jax.tree.map(jnp.asarray, head["tree"])

    def thead(gen, enc_dim, num_chars, hidden, layers):
        dec = asr.LSTMDecoder(enc_dim, num_chars, hidden, layers)
        dec.load_state_dict(convert.from_jax_head(head["tree"]))
        return dec

    monkeypatch.setattr(jfs, "asr_model", SimpleNamespace(init_lstm_decoder=jhead))
    monkeypatch.setattr(tfs, "asr_model", SimpleNamespace(init_lstm_decoder=thead))
    monkeypatch.setattr(jfs, "load_librispeech", lambda split, n: JLibri(split, n))
    monkeypatch.setattr(tfs, "load_librispeech", lambda split, n: SyntheticLibriSpeech(split, n))
    argv = ["--epochs", "2", "--batch_size", "2", "--max_samples", "4", "--hidden_size", "32",
            "--num_layers", "1", "--max_text_len", "16", "--lr", "1e-3", "--device", "cpu",
            "--checkpoint_dir", "ck"]
    history = "whisper_from_scratch_training_history.json"
    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    jfs.main(argv)
    ref = json.load(open(history))
    os.makedirs(tmp_path / "port")
    monkeypatch.chdir(tmp_path / "port")
    out = tfs.main(argv)
    got = json.load(open(history))
    assert len(got["epochs"]) == len(ref["epochs"]) == 2 and got["config"] == ref["config"]
    for g, r in zip(got["epochs"], ref["epochs"]):
        for k in ("epoch", "skipped", "val_cer", "val_wer"):
            assert g[k] == r[k], k
        assert g["train_loss"] == pytest.approx(r["train_loss"], rel=1e-4)
    enc = out["params"]["encoder"]
    trunk = convert.from_jax_encoder(q["encoder"], FS_DIMS, "")
    moved = [n for n, p in enc.named_parameters() if not torch.equal(p, trunk[n])]
    assert "blocks.0.attn.query.weight" in moved and "qconv1.qweights" in moved
    for metric in ("cer", "wer"):
        mine = jckpt.load_pytree(str(tmp_path / "port" / "ck" / f"best_{metric}"))
        theirs = jckpt.load_pytree(str(tmp_path / "jax" / "ck" / f"best_{metric}"))
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert quantum.count_params(out["params"]) > 0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tfs.main(["--device", "auto"])
