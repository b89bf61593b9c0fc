"""Port evaluation side (qasr_ijcnlp_tpu_torch/metrics/, train/loops.py,
train/checkpoint.py, reporting.py and the two evaluation CLIs) vs the JAX
package.

CER/WER and the normalizers are checked on JAX's own test tables (read
from tests/test_metrics.py as data): equal floats and strings.  The two
evaluation functions and the two CLIs run on the same numpy-pickle
checkpoint (the JAX package's ``save_pytree`` fallback format, written here
with pickle) and the same synthetic data as JAX's, at narrow dims
(``torch_port_common.LF_DIMS``: n_audio_ctx 1500, width 128, two layers),
and give JAX's numbers.  The JAX CLIs are pointed at the narrow models and
at the synthetic sets (their own loaders would try the network).
"""

import ast
import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import metrics as jmetrics, reporting as jreporting
from qasr_ijcnlp_tpu.cli import evaluate_quantum_whisper_asr as jqcli
from qasr_ijcnlp_tpu.cli import evaluate_whisper_pretrained_modified_gspeech as jgcli
from qasr_ijcnlp_tpu.data import CharASRView as JCharView, CharVocabulary as JVocab
from qasr_ijcnlp_tpu.data import ClassificationView as JClsView
from qasr_ijcnlp_tpu.data import SyntheticLibriSpeech as JLibri
from qasr_ijcnlp_tpu.data import SyntheticSpeechCommands as JCommands
from qasr_ijcnlp_tpu.data.loader import DataLoader as JLoader
from qasr_ijcnlp_tpu.models import asr as jasr, classifier as jclf, quantum as jqm
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
from qasr_ijcnlp_tpu.train import loops as jloops
from qasr_ijcnlp_tpu_torch import metrics, reporting
from qasr_ijcnlp_tpu_torch.cli import evaluate_quantum_whisper_asr as qcli
from qasr_ijcnlp_tpu_torch.cli import evaluate_whisper_pretrained_modified_gspeech as gcli
from qasr_ijcnlp_tpu_torch.data import (
    CharASRView, CharVocabulary, ClassificationView, SyntheticLibriSpeech,
    SyntheticSpeechCommands,
)
from qasr_ijcnlp_tpu_torch.data.loader import DataLoader
from qasr_ijcnlp_tpu_torch.models import asr, convert, quantum
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.train import checkpoint, loops
from tests.torch_port_common import LF_DIMS, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, N_ITEMS, BATCH, MAX_TEXT = 32, 4, 2, 16


def _jax_test_table(name):
    """A literal assigned to ``name`` in tests/test_metrics.py, read as data
    (importing that module would install its reference stubs)."""
    with open(os.path.join(ROOT, "tests", "test_metrics.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            value = node.value
            if isinstance(value, ast.Call):  # "...".split()
                return ast.literal_eval(value.func.value).split()
            return ast.literal_eval(value)
    raise KeyError(name)


# -- metrics and normalizers -----------------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_levenshtein_matches_jax(monkeypatch, native):
    if not native:
        monkeypatch.setattr(metrics, "_NATIVE_LEV", None)
    else:
        assert metrics._native_lev() is not None
    rnd = random.Random(0)
    for _ in range(200):
        a = "".join(rnd.choice("abcd") for _ in range(rnd.randrange(0, 12)))
        b = "".join(rnd.choice("abcd") for _ in range(rnd.randrange(0, 12)))
        assert metrics.levenshtein(a, b) == jmetrics.levenshtein(a, b), (a, b)
    assert metrics.levenshtein("kitten", "sitting") == 3
    assert metrics.levenshtein([], ["a"]) == 1
    assert metrics.levenshtein("hello world".split(), "hello word".split()) == 1


def test_error_rates_match_jax():
    rnd = random.Random(1)
    words = "the a cat sat on mat dog ran".split()
    preds, tgts = ["hello world", "a b c", "", "x"], ["hello word", "a b c", "abc", ""]
    for _ in range(20):
        tgts.append(" ".join(rnd.choice(words) for _ in range(rnd.randrange(0, 6))))
        preds.append(" ".join(rnd.choice(words) for _ in range(rnd.randrange(0, 6))))
    for fn in ("calculate_cer", "calculate_cer_pure", "calculate_wer",
               "calculate_wer_per_sample_mean"):
        assert getattr(metrics, fn)(preds, tgts) == getattr(jmetrics, fn)(preds, tgts), fn
        assert getattr(metrics, fn)([], []) == getattr(jmetrics, fn)([], [])
        with pytest.raises(ValueError):
            getattr(metrics, fn)(["a"], [])
    assert metrics.wer_corpus(tgts, preds) == jmetrics.wer_corpus(tgts, preds)
    assert metrics.calculate_cer(["hello world"], ["hello word"]) == pytest.approx(1 / 10)


def test_normalizers_match_jax():
    cases = _jax_test_table("CASES")
    assert len(cases) > 30
    ours, theirs = metrics.EnglishTextNormalizer(), jmetrics.EnglishTextNormalizer()
    for s in cases:
        assert ours(s) == theirs(s), s
    words = _jax_test_table("words")
    rnd = random.Random(1)
    for _ in range(150):
        s = " ".join(rnd.choice(words) for _ in range(rnd.randrange(1, 12)))
        assert ours(s) == theirs(s), s
    for remove in (False, True):
        b, jb = (metrics.BasicTextNormalizer(remove_diacritics=remove),
                 jmetrics.BasicTextNormalizer(remove_diacritics=remove))
        for s in _jax_test_table("cases") + cases:
            assert b(s) == jb(s), s
    assert metrics.EnglishSpellingNormalizer()("colour armour") == "color armor"


# -- checkpoints and reporting ------------------------------------------------------------

def _save_pickle(path, tree, meta=None):
    """The JAX package's ``save_pytree`` fallback format."""
    with open(path + ".pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, tree), f)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def test_checkpoint_reading(tmp_path):
    tree = {"a": np.arange(3, dtype=np.float64), "b": [np.ones((2, 2), np.float32)]}
    path = str(tmp_path / "ck")
    _save_pickle(path, tree, {"char_vocab": "{}"})
    got = checkpoint.load_pytree(path)
    np.testing.assert_array_equal(got["a"], tree["a"])
    cast = checkpoint.load_pytree(path, target={"a": np.zeros(3, np.float32),
                                                "b": [np.zeros((2, 2), np.float16)]})
    assert cast["a"].dtype == np.float32 and cast["b"][0].dtype == np.float16
    with pytest.raises(ValueError):
        checkpoint.load_pytree(path, target={"a": np.zeros(3)})
    assert checkpoint.load_metadata(path) == {"char_vocab": "{}"}
    assert checkpoint.load_metadata(str(tmp_path / "none")) is None
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_pytree(str(tmp_path / "orbax"))
    with pytest.raises(FileNotFoundError):
        checkpoint.load_pytree(str(tmp_path / "absent"))


def test_reporting_matches_jax(tmp_path, monkeypatch):
    preds, tgts = ["abc", "xyz", "ab"], ["abc", "abc", ""]
    ours, theirs = [], []
    rows = reporting.analyze_predictions(preds, tgts, num_samples=1, log=ours.append)
    jrows = jreporting.analyze_predictions(preds, tgts, num_samples=1, log=theirs.append)
    assert rows == jrows and ours == theirs
    ours, theirs = [], []
    reporting.print_model_info("m", 1000, 10, log=ours.append)
    jreporting.print_model_info("m", 1000, 10, log=theirs.append)
    assert ours == theirs
    path = reporting.save_results_json(str(tmp_path / "r" / "r.json"), {"wer": 0.1})
    data = json.load(open(path))
    assert data["wer"] == 0.1 and "timestamp" in data
    cers = list(np.random.default_rng(0).random(20))
    assert os.path.getsize(reporting.plot_cer_distribution(cers, str(tmp_path / "c.png"))) > 1000
    assert os.path.getsize(reporting.plot_metrics_distribution(
        {"cer": cers, "wer": cers}, str(tmp_path / "m.png"))) > 1000
    assert reporting.plot_cer_distribution([], str(tmp_path / "e.png")) is None
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)  # absent
    assert reporting.plot_cer_distribution(cers, str(tmp_path / "x.png")) is None
    assert reporting.plot_metrics_distribution({"cer": cers}, str(tmp_path / "y.png")) is None


# -- the evaluation functions and the CLIs ----------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """JAX trees (numpy leaves) at LF_DIMS: a quantum and a classical model,
    the two char heads and a classifier head over 35 classes."""
    q = jax.tree.map(np.asarray, jqm.init_quantum_params(jax.random.PRNGKey(0), LF_DIMS, 3))
    c = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(1), LF_DIMS))
    texts = [JLibri("test", N_ITEMS)[i][1] for i in range(N_ITEMS)]
    vocab = JVocab.build(texts)
    D = LF_DIMS.n_audio_state
    heads = {
        "lstm": jasr.init_lstm_decoder(jax.random.PRNGKey(2), D, vocab.num_chars, HIDDEN, 2),
        "mlp": jasr.init_mlp_head(jax.random.PRNGKey(3), D, vocab.num_chars, D, 1),
        "clf": jclf.init_classifier_head(jax.random.PRNGKey(4), D, 35),
    }
    return {"q": q, "c": c, "vocab": vocab,
            "heads": {k: jax.tree.map(np.asarray, v) for k, v in heads.items()}}


def _port_model(tree, quantum_stem):
    cls = quantum.QuantumWhisperModel if quantum_stem else WhisperModel
    return cls.from_state_dict(convert.from_jax_params(tree, LF_DIMS), LF_DIMS, "cpu")


def _jax_model(tree, quantum_stem):
    t = jax.tree.map(jnp.asarray, tree)
    if quantum_stem:
        return jqm.QuantumWhisperModel(t, LF_DIMS, n_qubits=3)
    return JModel(t, LF_DIMS)


def _port_head(kind, tree, vocab):
    D = LF_DIMS.n_audio_state
    module = {"lstm": lambda: asr.LSTMDecoder(D, vocab.num_chars, HIDDEN, 2),
              "mlp": lambda: asr.MLPHead(D, vocab.num_chars, D, 1),
              "clf": lambda: torch.nn.Linear(D, 35)}[kind]()
    module.load_state_dict(convert.from_jax_head(tree))
    return module.requires_grad_(False)


@pytest.fixture(scope="module")
def char_jax_results(trees):
    """JAX's evaluate_char_asr of the quantum encoder for each head mode."""
    jm = _jax_model(trees["q"], True)
    loader = JLoader(JCharView(JLibri("test", N_ITEMS), trees["vocab"], MAX_TEXT), BATCH,
                     shuffle=False)
    out = {}
    for kind, real in (("lstm", False), ("mlp", False), ("mlp", True)):
        params = {"encoder": jm.params["encoder"],
                  "head": jax.tree.map(jnp.asarray, trees["heads"][kind])}
        out[kind, real] = jloops.evaluate_char_asr(
            params, jloops.encoder_fn_for(jm), kind, loader, trees["vocab"], MAX_TEXT, real)
    return out


@pytest.mark.parametrize("kind,real", [("lstm", False), ("mlp", False), ("mlp", True)],
                         ids=["lstm", "mlp_teacher_forced", "mlp_real_decode"])
def test_evaluate_char_asr_matches_jax(trees, char_jax_results, kind, real):
    tm = _port_model(trees["q"], True)
    vocab = CharVocabulary(trees["vocab"].char_to_idx)
    params = {"encoder": tm.module.encoder,
              "head": _port_head(kind, trees["heads"][kind], vocab)}
    loader = DataLoader(CharASRView(SyntheticLibriSpeech("test", N_ITEMS), vocab, MAX_TEXT,
                                    device="cpu"), BATCH, shuffle=False)
    got = loops.evaluate_char_asr(params, loops.encoder_fn_for(tm), kind, loader, vocab,
                                  MAX_TEXT, real)
    ref = char_jax_results[kind, real]
    assert got["cer"] == ref["cer"] and got["wer"] == ref["wer"]
    assert got["loss"] == pytest.approx(ref["loss"], abs=1e-5)


@pytest.fixture(scope="module")
def clf_jax_results(trees):
    """JAX's evaluate_classifier of each encoder (classical, quantum) with
    the classifier head on the synthetic Speech Commands test split."""
    out = {}
    for quantum_stem in (False, True):
        jm = _jax_model(trees["q" if quantum_stem else "c"], quantum_stem)
        jparams = {"encoder": jm.params["encoder"],
                   "head": jax.tree.map(jnp.asarray, trees["heads"]["clf"])}
        out[quantum_stem] = jloops.evaluate_classifier(
            jparams, jloops.encoder_fn_for(jm),
            JLoader(JClsView(JCommands("test", N_ITEMS)), BATCH, shuffle=False))
    return out


@pytest.mark.parametrize("quantum_stem", [False, True], ids=["classical", "quantum"])
def test_evaluate_classifier_matches_jax(trees, clf_jax_results, quantum_stem):
    tree = trees["q" if quantum_stem else "c"]
    ref = clf_jax_results[quantum_stem]
    tm = _port_model(tree, quantum_stem)
    params = {"encoder": tm.module.encoder,
              "head": _port_head("clf", trees["heads"]["clf"], None)}
    got = loops.evaluate_classifier(
        params, loops.encoder_fn_for(tm),
        DataLoader(ClassificationView(SyntheticSpeechCommands("test", N_ITEMS), device="cpu"),
                   BATCH, shuffle=False))
    assert got["accuracy"] == ref["accuracy"] and got["wer"] == ref["wer"]
    assert got["loss"] == pytest.approx(ref["loss"], abs=1e-5)
    mel = torch.zeros(1, 80, 3000)
    ids = torch.tensor([[2, 5, 3]])
    loss = loops.char_asr_loss_fn(loops.encoder_fn_for(tm), "mlp")(
        {"encoder": tm.module.encoder,
         "head": asr.init_mlp_head(torch.Generator(), 128, 10, 128, 1)}, mel, ids)
    assert torch.isfinite(loss)
    closs = loops.classifier_loss_fn(loops.encoder_fn_for(tm))(params, mel, torch.tensor([-1]))
    assert closs.item() == 0.0


def test_parallel_flags_raise_naming_the_roadmap(in_tmp):
    """No training entry point under a mesh raises NotImplementedError any
    more (they once waited for ROADMAP queue 1, item 7): on one process each
    runs on its (1, 1) mesh, and a wrong call raises the JAX package's own
    ValueError (FSDP without a mesh)."""
    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.cli import train_classical_whisper_asr
    from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
    from qasr_ijcnlp_tpu_torch.models.whisper import Whisper, init_params
    from qasr_ijcnlp_tpu_torch.train import checkpoint as tck, distill as tdistill
    from qasr_ijcnlp_tpu_torch.train import step as tstep

    mesh = parallel.make_mesh(model_parallel=2)
    assert mesh.shape == {"data": 1, "model": 1}
    dims = ModelDimensions(8, 16, 16, 2, 1, 64, 8, 16, 2, 1)
    module = Whisper(dims)
    module.load_state_dict(init_params(torch.Generator().manual_seed(0), dims))
    tx = tstep.make_optimizer(1e-3)
    loss = tstep.whisper_loss_fn(dims, mesh=mesh)
    state = tstep.shard_state(tstep.init_state(module, tx), mesh, fsdp=True)
    mel, tokens = torch.randn(2, 8, 32), torch.tensor([[1, 5, 6, 2], [3, 4, -100, -100]])
    state, m = tstep.make_sharded_train_step(loss, tx, mesh)(state, mel, tokens)
    assert int(state.step) == 1 and int(m["skipped"]) == 0
    tck.save_train_state("state", state)
    restored = tck.restore_train_state("state", tstep.init_state(module, tx), mesh=mesh,
                                       fsdp=True)
    assert int(restored.step) == 1
    assert torch.isfinite(tdistill.distill_loss_fn(dims, dims, mesh=mesh)(
        module, module, mel, tokens))
    calls = [
        lambda: loops.train_token_asr(None, LF_DIMS, None, [], None, fsdp=True),
        lambda: parallel.param_specs({"w": torch.zeros(4)}, None, fsdp=True),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="requires a mesh"):
            call()
    args = train_classical_whisper_asr.build_parser().parse_args(
        ["--model_parallel", "2", "--fsdp", "--device", "cpu"])
    assert args.model_parallel == 2 and args.fsdp


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("head", ["lstm", "mlp"])
def test_quantum_asr_cli_matches_jax(trees, in_tmp, monkeypatch, head):
    """Both CLIs on one pickle checkpoint (a quantum encoder and a head) and
    the synthetic LibriSpeech test split: equal CER, WER and results."""
    ck = str(in_tmp / "best_cer")
    layers = 2 if head == "lstm" else 1
    hidden = HIDDEN if head == "lstm" else LF_DIMS.n_audio_state
    _save_pickle(ck, {"encoder": trees["q"]["encoder"], "head": trees["heads"][head]},
                 {"char_vocab": trees["vocab"].to_json()})
    monkeypatch.setattr(jqcli, "create_quantum_whisper_tiny",
                        lambda n_qubits: _jax_model(trees["q"], True))
    monkeypatch.setattr(jqcli, "load_librispeech", lambda split, n: JLibri(split, n))
    monkeypatch.setattr(qcli, "create_quantum_whisper_tiny", lambda n_qubits, device: (
        quantum.QuantumWhisperModel.from_state_dict(
            quantum.init_quantum_params(torch.Generator().manual_seed(9), LF_DIMS, n_qubits),
            LF_DIMS, device)))
    argv = ["--model_path", ck, "--batch_size", str(BATCH), "--max_samples", str(N_ITEMS),
            "--n_qubits", "3", "--hidden_size", str(hidden), "--num_layers", str(layers),
            "--max_text_len", str(MAX_TEXT), "--head", head, "--device", "cpu"]
    ref = jqcli.main(argv)
    jres = json.load(open("quantum_whisper_asr_evaluation_results.json"))
    got = qcli.main(argv)
    res = json.load(open("quantum_whisper_asr_evaluation_results.json"))
    assert (got["cer"], got["wer"]) == (ref["cer"], ref["wer"])
    for key in ("cer", "wer", "num_samples", "used_dummy_dataset", "model_path"):
        assert res[key] == jres[key], key
    assert res["used_dummy_dataset"] is True and len(got["predictions"]) == N_ITEMS


def test_gspeech_cli_matches_jax(trees, clf_jax_results, in_tmp, monkeypatch):
    """Classical: the two CLIs on one pickle checkpoint (encoder and
    classifier head) and synthetic Speech Commands: equal accuracy and
    class-wise accuracy.  Quantum (``--model_size quantum-tiny``, which the
    JAX CLI lacks): the port's CLI equals JAX's evaluate_classifier."""
    ck = str(in_tmp / "clf")
    _save_pickle(ck, {"encoder": trees["c"]["encoder"], "head": trees["heads"]["clf"]})
    monkeypatch.setattr(jgcli, "load_model_with_fallback",
                        lambda name: _jax_model(trees["c"], False))
    monkeypatch.setattr(jgcli, "load_speech_commands", lambda split, n: JCommands(split, n))
    monkeypatch.setattr(gcli, "load_model_with_fallback",
                        lambda name, device: WhisperModel.from_state_dict(
                            convert.from_jax_params(trees["c"], LF_DIMS), LF_DIMS, device))
    argv = ["--batch_size", str(BATCH), "--max_samples", str(N_ITEMS), "--n_repeats", "3",
            "--classifier_path", ck, "--device", "cpu"]
    ref = jgcli.main(argv)
    jres = json.load(open("gspeech_classification_results.json"))
    got = gcli.main(argv)
    res = json.load(open("gspeech_classification_results.json"))
    assert got == ref
    for key in ("accuracy", "n_repeats", "num_samples", "class_accuracy", "used_dummy_dataset"):
        assert res[key] == jres[key], key

    qck = str(in_tmp / "qclf")
    _save_pickle(qck, {"encoder": trees["q"]["encoder"], "head": trees["heads"]["clf"]})
    got = gcli.main(["--model_size", "quantum-tiny", "--batch_size", str(BATCH),
                     "--max_samples", str(N_ITEMS), "--classifier_path", qck,
                     "--device", "cpu"])
    assert got["accuracy"] == clf_jax_results[True]["accuracy"]
    assert json.load(open("gspeech_classification_results.json"))["model"].startswith(
        "quantum-")


def test_cli_device_refuses_without_a_card(in_tmp):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        gcli.main(["--device", "auto"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        qcli.main(["--model_path", "x", "--device", "cuda"])
