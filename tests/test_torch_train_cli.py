"""The port's trainers and their CLIs (train_quantum_whisper_asr,
train_quantum_whisper, train_classical_whisper_asr) and the two classical
evaluation CLIs (evaluate_pretrained_whisper, evaluate_pretrained_whisper_asr)
against the JAX package's, on the CPU.

Both sides are pointed at the same narrow models (``torch_port_common.
LF_DIMS``: n_audio_ctx 1500, width 128, two layers each side; one JAX
``init`` tree moved to the port through numpy, heads included) and at the
synthetic sets (the JAX loaders would try the network), and run from a
temporary directory each.  Tolerances: epoch losses 1e-4 relative (two
epochs of Adam steps from equal weights; see tests/test_torch_train.py for
the per-step bounds); CER, WER, accuracies and decoded text exactly.
"""

import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import reporting as jreporting
from qasr_ijcnlp_tpu.cli import evaluate_pretrained_whisper as jepw
from qasr_ijcnlp_tpu.cli import evaluate_pretrained_whisper_asr as jepa
from qasr_ijcnlp_tpu.cli import train_classical_whisper_asr as jtc
from qasr_ijcnlp_tpu.cli import train_quantum_whisper as jtq
from qasr_ijcnlp_tpu.cli import train_quantum_whisper_asr as jta
from qasr_ijcnlp_tpu.data import SyntheticLibriSpeech as JLibri
from qasr_ijcnlp_tpu.data import SyntheticSpeechCommands as JCommands
from qasr_ijcnlp_tpu.models import asr as jasr, classifier as jclf, quantum as jqm
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
from qasr_ijcnlp_tpu.train import checkpoint as jckpt
from qasr_ijcnlp_tpu_torch import reporting
from qasr_ijcnlp_tpu_torch.cli import evaluate_pretrained_whisper as tepw
from qasr_ijcnlp_tpu_torch.cli import evaluate_pretrained_whisper_asr as tepa
from qasr_ijcnlp_tpu_torch.cli import train_classical_whisper_asr as ttc
from qasr_ijcnlp_tpu_torch.cli import train_quantum_whisper as ttq
from qasr_ijcnlp_tpu_torch.cli import train_quantum_whisper_asr as tta
from qasr_ijcnlp_tpu_torch.data import SyntheticLibriSpeech, SyntheticSpeechCommands
from qasr_ijcnlp_tpu_torch.models import asr, convert, quantum
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from tests.torch_port_common import LF_DIMS, one_torch_thread  # noqa: F401

N_ITEMS, BATCH, HIDDEN, MAX_TEXT = 4, 2, 32, 16


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    return {"q": _tree(jqm.init_quantum_params(jax.random.PRNGKey(0), LF_DIMS, 3)),
            "c": _tree(jmodel.init_params(jax.random.PRNGKey(0), LF_DIMS))}


def _in_dir(monkeypatch, path):
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)


def _history(name):
    with open(name) as f:
        return json.load(f)


def _same_history(got, ref, exact=("skipped", "val_cer", "val_wer", "val_accuracy", "epoch")):
    assert len(got["epochs"]) == len(ref["epochs"]) > 0
    for g, r in zip(got["epochs"], ref["epochs"]):
        assert set(g) == set(r)
        for k, v in r.items():
            if k == "time_s":
                continue
            if k in exact:
                assert g[k] == v, (k, g[k], v)
            else:
                assert g[k] == pytest.approx(v, rel=1e-4), k
        assert np.isfinite(g["train_loss"]) and g["skipped"] == 0
    assert got["config"] == ref["config"]


def _quantum_patches(monkeypatch, trees, jcli, tcli):
    q = trees["q"]
    monkeypatch.setattr(jcli, "create_quantum_whisper_tiny",
                        lambda n_qubits: jqm.QuantumWhisperModel(
                            jax.tree.map(jnp.asarray, q), LF_DIMS, n_qubits=3))
    monkeypatch.setattr(tcli, "create_quantum_whisper_tiny",
                        lambda n_qubits, device: quantum.QuantumWhisperModel.from_state_dict(
                            convert.from_jax_params(q, LF_DIMS), LF_DIMS, device))


def _port_head(module, jhead):
    module.load_state_dict(convert.from_jax_head(_tree(jhead)))
    return module


def test_quantum_asr_trainer_cli_matches_jax(trees, tmp_path, monkeypatch):
    """Two epochs of the paper's model (quantum stem + frozen trunk + LSTM
    char head) through both CLIs: JAX's history, best checkpoints that the
    JAX package reads with JAX's tree and near JAX's values, the trunk
    untouched.  (The MLP head's steps: tests/test_torch_train.py.)"""
    _quantum_patches(monkeypatch, trees, jta, tta)
    for mod in (jta, tta):
        monkeypatch.setattr(mod, "load_librispeech", lambda split, n: JLibri(split, n))

    def lstm(gen, enc_dim, num_chars, hidden, layers):
        return _port_head(asr.LSTMDecoder(enc_dim, num_chars, hidden, layers),
                          jasr.init_lstm_decoder(jax.random.PRNGKey(0), enc_dim, num_chars,
                                                 hidden, layers))

    monkeypatch.setattr(tta, "asr_model", SimpleNamespace(init_lstm_decoder=lstm))
    argv = ["--epochs", "2", "--batch_size", str(BATCH), "--max_samples", str(N_ITEMS),
            "--n_qubits", "3", "--hidden_size", str(HIDDEN), "--num_layers", "2",
            "--max_text_len", str(MAX_TEXT), "--head", "lstm", "--lr", "1e-3",
            "--device", "cpu", "--checkpoint_dir", "ck"]
    _in_dir(monkeypatch, tmp_path / "jax")
    jta.main(argv)
    ref = _history("quantum_whisper_asr_training_history.json")
    _in_dir(monkeypatch, tmp_path / "port")
    out = tta.main(argv)
    got = _history("quantum_whisper_asr_training_history.json")
    _same_history(got, ref)
    module = out["params"]
    assert not any(p.requires_grad for p in module["encoder"].parameters())
    assert all(p.requires_grad for p in module["head"].parameters())  # as built
    trunk = convert.from_jax_encoder(trees["q"]["encoder"], LF_DIMS, "")
    for n, p in module["encoder"].named_parameters():
        if not n.startswith(("qconv1.", "qconv2.")):
            assert torch.equal(p, trunk[n]), n
    for metric in ("cer", "wer"):
        path = f"ck/best_{metric}"
        mine, theirs = jckpt.load_pytree(str(tmp_path / "port" / path)), \
            jckpt.load_pytree(str(tmp_path / "jax" / path))
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)  # 4 Adam steps at 1e-3
        meta = jckpt.load_metadata(str(tmp_path / "port" / path))
        assert meta["metric"] == metric and "char_vocab" in meta


def test_quantum_classifier_trainer_cli_matches_jax(trees, tmp_path, monkeypatch):
    """Two epochs of the classifier through both CLIs: JAX's history and
    its test accuracy."""
    _quantum_patches(monkeypatch, trees, jtq, ttq)
    for mod, cls in ((jtq, JCommands), (ttq, SyntheticSpeechCommands)):
        monkeypatch.setattr(mod, "load_speech_commands", lambda split, n, c=cls: c(split, n))
    monkeypatch.setattr(ttq, "clf_model", SimpleNamespace(
        init_classifier_head=lambda gen, d, n: _port_head(
            torch.nn.Linear(d, n), jclf.init_classifier_head(jax.random.PRNGKey(0), d, n))))
    argv = ["--epochs", "2", "--batch_size", str(BATCH), "--max_samples", str(N_ITEMS),
            "--n_qubits", "3", "--lr", "1e-3", "--device", "cpu", "--checkpoint_dir", "ck"]
    _in_dir(monkeypatch, tmp_path / "jax")
    jtq.main(argv)
    ref = _history("quantum_whisper_training_history.json")
    _in_dir(monkeypatch, tmp_path / "port")
    out = ttq.main(argv)
    _same_history(_history("quantum_whisper_training_history.json"), ref)
    for metric in ("accuracy", "loss", "wer"):
        assert os.path.exists(f"ck/best_{metric}.pkl")
    assert 0.0 <= out["test"]["accuracy"] <= 1.0


@pytest.fixture(scope="module")
def classical_runs(trees, tmp_path_factory):
    """The classical token trainer through both CLIs, two epochs with
    ``--grad_accum 2 --remat --save_every 1``, then the port's resumed from
    its epoch-0 state for the second epoch."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("classical")
    try:
        for mod in (jtc, ttc):
            mp.setattr(mod, "dims_for", lambda name: LF_DIMS)
        mp.setattr(jtc, "load_librispeech", lambda split, n: JLibri(split, n))
        mp.setattr(ttc, "load_librispeech", lambda split, n: SyntheticLibriSpeech(split, n))
        mp.setattr(tmodel, "init_params",
                   lambda gen, dims: convert.from_jax_params(trees["c"], LF_DIMS))
        mp.setattr(jmodel, "_USE_REMAT", False)  # restored: the JAX CLI never resets it
        argv = ["--model_size", "tiny", "--epochs", "2", "--batch_size", str(BATCH),
                "--max_samples", str(N_ITEMS), "--max_tokens", "24", "--grad_accum", "2",
                "--save_every", "1", "--warmup_epochs", "1", "--remat", "--lr", "1e-3",
                "--device", "cpu", "--checkpoint_dir", "ck"]
        _in_dir(mp, tmp / "jax")
        jtc.main(argv)
        ref = _history("classical_whisper_asr_training_history.json")
        _in_dir(mp, tmp / "port")
        out = ttc.main(argv)
        got = _history("classical_whisper_asr_training_history.json")
        final = {k: v.clone() for k, v in out["params"].state_dict().items()}
        resumed = ttc.main(argv + ["--resume_state", "ck/state_epoch_0"])
        return dict(ref=ref, got=got, out=out, final=final, resumed=resumed, tmp=tmp,
                    resumed_history=_history("classical_whisper_asr_training_history.json"))
    finally:
        mp.undo()


def test_classical_trainer_cli_matches_jax(classical_runs):
    r = classical_runs
    _same_history(r["got"], r["ref"])
    assert not tmodel._USE_REMAT and not jmodel._USE_REMAT
    port, jax_dir = r["tmp"] / "port" / "ck", r["tmp"] / "jax" / "ck"
    for name in ("best_wer", "best_wer_state", "state_epoch_0", "state_epoch_1"):
        assert os.path.exists(port / f"{name}.pkl"), name
    mine, theirs = jckpt.load_pytree(str(port / "best_wer")), \
        jckpt.load_pytree(str(jax_dir / "best_wer"))
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert int(r["out"]["state"].step) == 4


def test_classical_trainer_resumes_where_it_stopped(classical_runs):
    """Resumed from ``state_epoch_0``, the trainer runs epoch 1 only, its
    step count carries on to 4, and it ends on the straight run's
    parameters bit for bit."""
    r = classical_runs
    hist = r["resumed_history"]
    assert [e["epoch"] for e in hist["epochs"]] == [1]
    assert hist["epochs"][0]["train_loss"] == r["got"]["epochs"][1]["train_loss"]
    assert int(r["resumed"]["state"].step) == 4
    for k, v in r["resumed"]["params"].state_dict().items():
        assert torch.equal(v, r["final"][k]), k


def _greedy_transcribe(model):
    """``model`` whose ``transcribe`` keeps to temperature 0: the fallback
    ladder samples at T > 0, where JAX's and torch's generators differ."""
    model.transcribe = functools.partial(model.transcribe, temperature=0.0)
    return model


def _eval_patches(monkeypatch, trees):
    c = trees["c"]
    jax_model = lambda name: _greedy_transcribe(JModel(jax.tree.map(jnp.asarray, c), LF_DIMS))
    monkeypatch.setattr(jepw, "load_model_with_fallback", jax_model)
    monkeypatch.setattr(jepa, "load_model_with_fallback", jax_model)
    port_model = lambda name, device: _greedy_transcribe(WhisperModel.from_state_dict(
        convert.from_jax_params(c, LF_DIMS), LF_DIMS, device))
    for mod in (tepw, tepa):
        monkeypatch.setattr(mod, "load_model_with_fallback", port_model)
    for mod in (jepw, jepa):
        monkeypatch.setattr(mod, "load_librispeech", lambda split, n: JLibri(split, n or 8))
    for mod in (tepw, tepa):
        monkeypatch.setattr(mod, "load_librispeech",
                            lambda split, n: SyntheticLibriSpeech(split, n or 8))


def test_evaluate_pretrained_whisper_matches_jax(trees, tmp_path, monkeypatch):
    """The batched evaluation (B=2 over 3 synthetic items, the last batch
    padded): JAX's hypotheses, WER and CER."""
    _eval_patches(monkeypatch, trees)
    monkeypatch.chdir(tmp_path)
    argv = ["--model_size", "tiny", "--batch_size", str(BATCH), "--max_samples", "3",
            "--device", "cpu"]
    ref = jepw.main(argv)
    jres = json.load(open("pretrained_whisper_tiny_evaluation_results.json"))
    got = tepw.main(argv)
    res = json.load(open("pretrained_whisper_tiny_evaluation_results.json"))
    assert (got["wer"], got["cer"]) == (ref["wer"], ref["cer"])
    assert res["samples"] == jres["samples"] and res["num_samples"] == 3
    assert got["rtf"] > 0 and res["used_dummy_dataset"] is True


def test_evaluate_pretrained_whisper_asr_matches_jax(trees, tmp_path, monkeypatch):
    """``transcribe`` per item (2 synthetic items) at temperature 0: JAX's
    CER/WER and transcripts, no failure sentinel."""
    _eval_patches(monkeypatch, trees)
    monkeypatch.chdir(tmp_path)
    argv = ["--model_size", "tiny", "--max_samples", "2", "--device", "cpu"]
    ref = jepa.main(argv)
    got = tepa.main(argv)
    assert (got["cer"], got["wer"]) == (ref["cer"], ref["wer"])
    assert tepa.SENTINEL not in got["predictions"] and len(got["predictions"]) == 2
    res = json.load(open("pretrained_whisper_tiny_asr_evaluation_results.json"))
    assert res["num_samples"] == 2 and res["cer"] == got["cer"]


def test_new_clis_refuse_without_a_card_and_report_like_jax(tmp_path, monkeypatch):
    """Without a card, ``--device auto`` exits with an error in every new
    CLI; the training header and the training plot follow JAX's."""
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        for main in (tta.main, ttq.main, ttc.main, tepw.main, tepa.main):
            with pytest.raises(SystemExit, match="no CUDA device"):
                main(["--device", "auto"])
    ours, theirs = [], []
    reporting.print_training_header("t", 2, 1e-3, 8, log=ours.append)
    jreporting.print_training_header("t", 2, 1e-3, 8, log=theirs.append)
    cut = lambda lines: [line.split("backend=")[0] for line in lines]
    assert cut(ours) == cut(theirs) and "backend=cpu" in ours[2]
    epochs = [{"epoch": 0, "train_loss": 1.0, "val_wer": 0.5, "time_s": 1.0},
              {"epoch": 1, "train_loss": 0.8, "val_wer": 0.4, "time_s": 1.0}]
    assert os.path.getsize(reporting.plot_training_results(epochs, "t.png")) > 1000
    assert reporting.plot_training_results([], "e.png") is None
