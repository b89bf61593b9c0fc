"""Port character-ASR heads, classifier, losses and data layer
(qasr_ijcnlp_tpu_torch/models/asr.py, models/classifier.py, train/loss.py,
data/) vs the JAX package.

Head weights are JAX's ``init_*`` trees moved through numpy and
``models.convert.from_jax_head``.  Logits to 1e-5 and greedy ids equal
(MLP and LSTM heads), classifier logits to 1e-5, the masked cross-entropy
to 1e-6; the vocabulary, the synthetic items (audio bit for bit, mel at the
port's mel tolerance, atol 2e-4 rtol 1e-4), the loader's order and
``pad_batch_to`` equal JAX's.
"""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import data as jdata
from qasr_ijcnlp_tpu.data import loader as jloader
from qasr_ijcnlp_tpu.models import asr as jasr, classifier as jclf
from qasr_ijcnlp_tpu.train import loss as jloss
from qasr_ijcnlp_tpu_torch import data as tdata
from qasr_ijcnlp_tpu_torch.data import loader as tloader
from qasr_ijcnlp_tpu_torch.models import asr as tasr, classifier as tclf
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_head, to_jax_head
from qasr_ijcnlp_tpu_torch.train import loss as tloss
from tests.torch_port_common import one_torch_thread  # noqa: F401

# The MLP head concatenates audio rows and char rows, so its hidden width is
# the encoder's; the LSTM's may differ.
ENC, CHARS, HIDDEN = 64, 20, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(module, tree):
    module.load_state_dict(from_jax_head(_np(tree)), strict=True)
    return module.requires_grad_(False)


@pytest.fixture(scope="module")
def enc():
    return np.random.default_rng(0).standard_normal((3, 10, ENC)).astype(np.float32)


@pytest.fixture(scope="module")
def char_ids():
    return np.random.default_rng(1).integers(0, CHARS, (3, 12)).astype(np.int32)


# -- heads -------------------------------------------------------------------------------

@pytest.mark.parametrize("num_layers", [1, 2])
def test_mlp_head_matches_jax(enc, char_ids, num_layers):
    jh = jasr.init_mlp_head(jax.random.PRNGKey(2), ENC, CHARS, ENC, num_layers)
    th = _port(tasr.MLPHead(ENC, CHARS, ENC, num_layers), jh)
    e, ids = torch.from_numpy(enc), torch.from_numpy(char_ids).long()
    np.testing.assert_allclose(tasr.mlp_head_apply(th, e, ids).numpy(),
                               np.asarray(jasr.mlp_head_apply(jh, enc, char_ids)), atol=1e-5)
    np.testing.assert_allclose(tasr.mlp_head_char_logits(th, e, ids).numpy(),
                               np.asarray(jasr.mlp_head_char_logits(jh, enc, char_ids)),
                               atol=1e-5)
    out, lengths = tasr.mlp_greedy_decode(th, e, 2, 3, 16)
    jout, jlen = jasr.mlp_greedy_decode(jh, enc, 2, 3, 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_lstm_decoder_matches_jax(enc, char_ids, num_layers):
    jd = jasr.init_lstm_decoder(jax.random.PRNGKey(3), ENC, CHARS, HIDDEN, num_layers)
    td = _port(tasr.LSTMDecoder(ENC, CHARS, HIDDEN, num_layers), jd)
    e, ids = torch.from_numpy(enc), torch.from_numpy(char_ids).long()
    np.testing.assert_allclose(tasr.lstm_teacher_forced(td, e, ids).numpy(),
                               np.asarray(jasr.lstm_teacher_forced(jd, enc, char_ids)),
                               atol=1e-5)
    h, c = tasr._init_lstm_state(td, e, num_layers, HIDDEN)
    jh, jc = jasr._init_lstm_state(jd, enc, num_layers, HIDDEN)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    # pick an end id the greedy rows reach, so the lengths rule is exercised
    end = int(np.asarray(jasr.lstm_greedy_decode(jd, enc, 2, 3, 16)[0])[0, 4])
    out, lengths = tasr.lstm_greedy_decode(td, e, 2, end, 16)
    jout, jlen = jasr.lstm_greedy_decode(jd, enc, 2, end, 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    assert (lengths.numpy() <= 4).any()


def test_lengths_rule():
    out = torch.tensor([[5, 3, 3], [5, 6, 7], [3, 3, 3]])
    np.testing.assert_array_equal(tasr._lengths(out, 3, 3).numpy(), [1, 3, 0])


def test_heads_round_trip_and_init():
    g = torch.Generator().manual_seed(0)
    for head in (tasr.init_mlp_head(g, ENC, CHARS, ENC, 2),
                 tasr.init_lstm_decoder(g, ENC, CHARS, HIDDEN, 2),
                 tclf.init_classifier_head(g, ENC, 35)):
        sd = head.state_dict()
        back = from_jax_head(to_jax_head(head))
        assert back.keys() == sd.keys()
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], atol=0, rtol=0)
    lin = tasr.init_mlp_head(torch.Generator().manual_seed(1), ENC, CHARS, ENC).layers[0]
    assert lin.weight.abs().max() <= 1 / np.sqrt(ENC)
    jh = _np(jasr.init_lstm_decoder(jax.random.PRNGKey(0), ENC, CHARS, HIDDEN, 2))
    assert jax.tree.structure(to_jax_head(_port(tasr.LSTMDecoder(ENC, CHARS, HIDDEN, 2), jh))) \
        == jax.tree.structure(jh)


def test_mlp_dropout_from_generator(enc, char_ids):
    th = tasr.init_mlp_head(torch.Generator().manual_seed(0), ENC, CHARS, ENC)
    e, ids = torch.from_numpy(enc), torch.from_numpy(char_ids).long()
    a = tasr.mlp_head_apply(th, e, ids, generator=torch.Generator().manual_seed(5))
    b = tasr.mlp_head_apply(th, e, ids, generator=torch.Generator().manual_seed(5))
    plain = tasr.mlp_head_apply(th, e, ids)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, plain)
    torch.testing.assert_close(
        tasr.mlp_head_apply(th, e, ids, generator=torch.Generator(), dropout_rate=0.0), plain)


def test_classifier_matches_jax(enc):
    jh = jclf.init_classifier_head(jax.random.PRNGKey(4), ENC, 35)
    th = _port(torch.nn.Linear(ENC, 35), jh)
    np.testing.assert_allclose(tclf.classifier_apply(th, torch.from_numpy(enc)).numpy(),
                               np.asarray(jclf.classifier_apply(jh, enc)), atol=1e-5)


# -- losses ------------------------------------------------------------------------------

@pytest.mark.parametrize("ignore_index", [-100, 0])
def test_masked_cross_entropy_matches_jax(ignore_index):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    targets[0, 4:] = ignore_index
    targets[2, :2] = ignore_index
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    np.testing.assert_allclose(tloss.masked_cross_entropy(tl, tt, ignore_index).item(),
                               float(jloss.masked_cross_entropy(logits, targets, ignore_index)),
                               atol=1e-6)
    s, n = tloss.masked_cross_entropy_sum(tl, tt, ignore_index)
    js, jn = jloss.masked_cross_entropy_sum(logits, targets, ignore_index)
    np.testing.assert_allclose(s.item(), float(js), rtol=1e-6)
    assert n.item() == float(jn)
    np.testing.assert_allclose(tloss.shifted_token_loss(tl, tt, ignore_index).item(),
                               float(jloss.shifted_token_loss(logits, targets, ignore_index)),
                               atol=1e-6)
    s, n = tloss.shifted_token_loss_sum(tl, tt, ignore_index)
    js, jn = jloss.shifted_token_loss_sum(logits, targets, ignore_index)
    np.testing.assert_allclose(s.item(), float(js), rtol=1e-6)
    assert n.item() == float(jn)
    empty = torch.full_like(tt, ignore_index)
    assert tloss.masked_cross_entropy(tl, empty, ignore_index).item() == 0.0


# -- data --------------------------------------------------------------------------------

TEXTS = ["Hello World", "the quick brown fox!", "ÉCOLE 42"]


def test_vocabulary_matches_jax():
    tv, jv = tdata.CharVocabulary.build(TEXTS), jdata.CharVocabulary.build(TEXTS)
    assert tv.char_to_idx == jv.char_to_idx and tv.num_chars == jv.num_chars
    assert tdata.build_character_vocabulary(TEXTS) == jdata.build_character_vocabulary(TEXTS)
    for text in TEXTS + ["x" * 40, "unseen §"]:
        for max_len in (8, 16, 100):
            ids = tv.encode(text, max_len)
            np.testing.assert_array_equal(ids, jv.encode(text, max_len))
            assert ids[min(len(text) + 1, max_len - 1)] == tdata.END
            assert tv.decode(ids) == jv.decode(ids)
    assert tv.decode(tv.encode("hello world", 100)) == "hello world"
    assert tv.decode([2, 5, 3, 6, 7]) == tv.idx_to_char[5]
    assert tdata.CharVocabulary.from_json(jv.to_json()).char_to_idx == tv.char_to_idx


@pytest.mark.parametrize("split", ["train", "validation", "test", "train.100"])
def test_synthetic_items_bit_equal(split):
    for i in (0, 3, 11):
        a, t = tdata.SyntheticLibriSpeech(split, 12)[i]
        ja, jt = jdata.SyntheticLibriSpeech(split, 12)[i]
        np.testing.assert_array_equal(a, ja)
        assert t == jt and a.dtype == np.float32
        a, lab = tdata.SyntheticSpeechCommands(split, 12)[i]
        ja, jlab = jdata.SyntheticSpeechCommands(split, 12)[i]
        np.testing.assert_array_equal(a, ja)
        assert lab == jlab
    assert tdata.SPEECH_COMMANDS_LABELS == jdata.SPEECH_COMMANDS_LABELS


def test_views_match_jax():
    base = tdata.SyntheticLibriSpeech("test", 2)
    vocab = tdata.CharVocabulary.build([base[i][1] for i in range(2)])
    mel, ids = tdata.CharASRView(base, vocab, 32, device="cpu")[1]
    jmel, jids = jdata.CharASRView(jdata.SyntheticLibriSpeech("test", 2),
                                   jdata.CharVocabulary(vocab.char_to_idx), 32)[1]
    assert isinstance(mel, np.ndarray) and mel.shape == (80, 3000)
    np.testing.assert_allclose(mel, np.asarray(jmel), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(ids, jids)
    sc = tdata.SyntheticSpeechCommands("test", 2)
    mel, lab = tdata.ClassificationView(sc, device="cpu")[1]
    jmel, jlab = jdata.ClassificationView(jdata.SyntheticSpeechCommands("test", 2))[1]
    np.testing.assert_allclose(mel, np.asarray(jmel), atol=2e-4, rtol=1e-4)
    assert lab == jlab and lab.dtype == np.int32

    from qasr_ijcnlp_tpu.tokenizer import get_tokenizer as jget
    from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(True, num_languages=99, language="en", task="transcribe")
    jtok = jget(True, num_languages=99, language="en", task="transcribe")
    _, ids = tdata.TokenASRView(base, tok, 64, device="cpu")[0]
    _, jids = jdata.TokenASRView(jdata.SyntheticLibriSpeech("test", 2), jtok, 64)[0]
    np.testing.assert_array_equal(ids, jids)


def test_loaders_without_a_local_copy_are_synthetic(tmp_path):
    ds = tdata.load_librispeech("test", 3, verbose=False)
    assert ds.is_synthetic and len(ds) == 3
    sc = tdata.load_speech_commands("test", 5, verbose=False)
    assert sc.is_synthetic and len(sc) == 5
    buf = io.StringIO()
    with redirect_stdout(buf):
        tdata.load_librispeech("test", 2, data_dir=str(tmp_path / "missing"))
    assert "synthetic offline corpus" in buf.getvalue()


def test_local_copy_loads(tmp_path):
    datasets = pytest.importorskip("datasets")
    audio = [{"array": np.full(800, v, np.float32).tolist(), "sampling_rate": 16000}
             for v in (0.1, 0.2)]
    datasets.Dataset.from_dict({"audio": audio, "text": ["one", "two"]}).save_to_disk(
        str(tmp_path / "ls"))
    ds = tdata.load_librispeech("test", 1, data_dir=str(tmp_path / "ls"))
    assert not ds.is_synthetic and len(ds) == 1
    a, t = ds[0]
    assert t == "one" and ds.text(0) == "one" and a.dtype == np.float32 and a.shape == (800,)
    assert tdata.dataset_texts(ds) == ["one"]


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, shuffle=False),
    dict(batch_size=3, shuffle=True, seed=4),
    dict(batch_size=4, shuffle=True, drop_last=True),
    dict(batch_size=2, shuffle=True, process_index=1, process_count=3),
    dict(batch_size=2, shuffle=False, process_index=2, process_count=4, drop_last=True),
], ids=["plain", "shuffled", "drop_last", "sharded", "sharded_drop_last"])
def test_loader_order_matches_jax(kw):
    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return np.int32(i), np.full(2, i, np.float32)

    ours, theirs = tloader.DataLoader(Items(), **kw), jloader.DataLoader(Items(), **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):  # two epochs: the order moves with the epoch
        a, b = list(ours), list(theirs)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for f, g in zip(x, y):
                np.testing.assert_array_equal(f, g)


def test_pad_batch_to_matches_jax():
    mel = np.arange(12, dtype=np.float32).reshape(3, 4)
    labels = np.array([[5, 6], [7, 8], [9, 10]], np.int32)
    for fills in (None, (None, -100), (0.5, 0)):
        ours, real = tloader.pad_batch_to((mel, labels), 5, fills)
        theirs, jreal = jloader.pad_batch_to((mel, labels), 5, fills)
        assert real == jreal == 3
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    same, real = tloader.pad_batch_to((mel, labels), 3)
    assert real == 3 and same[0] is mel


def test_prefetch_to_device():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2) + i) for i in range(4)]
    got = list(tloader.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 4
    for (a, b), (x, y) in zip(got, batches):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), x)
        np.testing.assert_array_equal(b.numpy(), y)

    def boom():
        yield batches[0]
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(tloader.prefetch_to_device(boom(), device="cpu"))
    gen = tloader.prefetch_to_device(iter(batches * 50), size=1, device="cpu")
    next(gen)
    gen.close()  # abandoned early: the producer stops


def test_dataset_texts_and_validate_match_jax():
    base = tdata.SyntheticLibriSpeech("test", 3)
    assert tdata.dataset_texts(base) == jdata.dataset_texts(jdata.SyntheticLibriSpeech("test", 3))
    assert tdata.dataset_texts(base, 2) == [base[0][1], base[1][1]]
    ours, theirs = [], []
    tdata.validate_dataset(tdata.SyntheticSpeechCommands("test", 3), 2, log=ours.append)
    jdata.validate_dataset(jdata.SyntheticSpeechCommands("test", 3), 2, log=theirs.append)
    assert ours == theirs
    loader = tdata.create_dataloader(base, batch_size=2, shuffle=False)
    assert isinstance(loader, tloader.DataLoader) and len(loader) == 2
