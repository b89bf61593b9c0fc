"""Deployment artifacts (``export.py``, ``cli/export_decode.py``) and int8
weights (``models/quantize.py``) against the JAX package's, on the CPU.

At JAX's ``tests/test_export.py`` geometry (width 64, one layer each side,
n_audio_ctx 1500, a 48-token context) and one weight set (JAX ``init``
moved to the port through numpy):

* int8: ``q`` and ``s`` bit-equal to JAX's, the error bound, small entries
  untouched;
* artifacts from audio and from a mel give JAX ``decode``'s tokens, and the
  program's four outputs mean what JAX's ``_greedy_decode_jit``'s mean (the
  buffer and ``cur_len`` exactly, the scores to 1e-4); the int8 artifact
  (written by the CLI) is under half the fp file and gives the decode of
  the dequantized weights in both packages;
* refusals, bad magic, a JAX artifact, the kernels artifact refused on the
  CPU, the version warning, and a kernel-free artifact run in a process
  that can import neither JAX nor the port;
* the ``qasr::`` ops: each op's fake agrees with its body
  (``torch.library.opcheck``), and a traced encoder records them where the
  wrappers would launch (stem, fused block, K7, K8 geometries).
"""

import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.audio import log_mel_spectrogram as jlog_mel
from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions, _get_task as jget_task
from qasr_ijcnlp_tpu.decode import decode as jdecode
from qasr_ijcnlp_tpu.decode.loop import _greedy_decode_jit
from qasr_ijcnlp_tpu.models import quantize as jquantize
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.dims import ModelDimensions
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
from qasr_ijcnlp_tpu_torch import _kernels, export, ops
from qasr_ijcnlp_tpu_torch.cli import export_decode
from qasr_ijcnlp_tpu_torch.decode import DecodingOptions, decode
from qasr_ijcnlp_tpu_torch.models import convert, quantize
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel, save_model
from qasr_ijcnlp_tpu_torch.ops import library
from tests.torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
    n_audio_layer=1, n_vocab=51865, n_text_ctx=48, n_text_state=64,
    n_text_head=2, n_text_layer=1,
)
OPTS = dict(fp16=False, language="en", without_timestamps=True)


def _audio(seed, batch):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, 480000))).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(3), DIMS))
    jm = JModel(jax.tree.map(jnp.asarray, params), DIMS, name="export-test")
    tm = WhisperModel.from_state_dict(convert.from_jax_params(params, DIMS), DIMS, "cpu",
                                      name="export-test")
    return params, jm, tm


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """Three artifacts: fp from audio (B=2, 8 tokens), fp from a mel (B=1,
    6 tokens), int8 from a mel written by the CLI (B=1, 6 tokens)."""
    _, _, tm = models
    tmp = tmp_path_factory.mktemp("artifacts")
    out = {}
    ep, meta = export.export_greedy_decode(tm, DecodingOptions(**OPTS, sample_len=8), batch=2,
                                           from_audio=True, device="cpu")
    out["audio"] = str(tmp / "audio.qasrt")
    export.save_artifact(out["audio"], ep, meta)
    ep, meta = export.export_greedy_decode(tm, DecodingOptions(**OPTS, sample_len=6), batch=1,
                                           from_audio=False, device="cpu")
    out["mel"] = str(tmp / "mel.qasrt")
    export.save_artifact(out["mel"], ep, meta)
    ckpt = str(tmp / "model.pt")
    save_model(tm, ckpt)
    out["int8"] = str(tmp / "int8.qasrt")
    out["cli_meta"] = export_decode.main([
        "--model", ckpt, "--batch", "1", "--sample_len", "6", "--from_mel", "--no_fp16",
        "--quantize", "int8", "--device", "cpu", "--out", out["int8"]])
    out["tmp"] = tmp
    return out


def _qleaves(tree, path=()):
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qleaves(v, path + (k,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_quantize_bit_equal_to_jax(models):
    """Every quantized array of JAX's tree, and only those, is quantized in
    the port's state dict, with the same int8 codes and scales bit for
    bit (compared in JAX's layout)."""
    params, _, tm = models
    jq = jquantize.quantize_params(params)
    tq = quantize.quantize_params(tm.module, DIMS)
    q_sd = {k: v["q"].float() if quantize.is_quantized(v) else torch.full_like(v, -1000)
            for k, v in tq.items()}
    s_sd = {k: v["s"].expand(v["q"].shape) if quantize.is_quantized(v) else
            torch.full_like(v, -1000) for k, v in tq.items()}
    q_tree, s_tree = (convert.to_jax_params(sd, DIMS) for sd in (q_sd, s_sd))
    leaves = list(_qleaves(jq))
    for path, leaf in leaves:
        q, s = np.asarray(leaf["q"]), np.asarray(leaf["s"])
        assert q.dtype == np.int8
        np.testing.assert_array_equal(_at(q_tree, path), q.astype(np.float32))
        np.testing.assert_array_equal(_at(s_tree, path), np.broadcast_to(s, q.shape))
    # the arrays JAX leaves f32 are not quantized in the port either
    unq = convert.to_jax_params({k: torch.zeros_like(v["q"], dtype=torch.float32)
                                 if quantize.is_quantized(v) else torch.ones_like(v)
                                 for k, v in tq.items()}, DIMS)
    jq_paths = {p for p, _ in leaves}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                assert (path + (k,) in jq_paths) == (not np.asarray(v).any()), path + (k,)

    walk(unq)
    assert all(v["q"].dtype == torch.int8 and v["s"].dtype == torch.float32
               for v in tq.values() if quantize.is_quantized(v))
    assert tq["decoder.token_embedding.weight"]["s"].numel() == DIMS.n_text_state


def test_quantize_error_bound_and_small_entries(models):
    params, _, tm = models
    tq = quantize.quantize_params(tm.module, DIMS)
    max_abs, max_rel = quantize.quantization_error(tm.module, tq, DIMS)
    assert (max_abs, max_rel) == pytest.approx(
        jquantize.quantization_error(params, jquantize.quantize_params(params)), rel=0, abs=0)
    assert max_rel <= 1.0 / 200.0
    deq = quantize.dequantize_params(tq)
    for name in ("encoder.ln_post.weight", "decoder.blocks.0.mlp.0.bias",
                 "encoder.conv1.bias"):
        assert torch.equal(deq[name], tm.module.state_dict()[name]), name
    assert quantize.DEFAULT_MIN_SIZE == jquantize.DEFAULT_MIN_SIZE == 4096


@pytest.fixture(scope="module")
def audio_run(artifacts):
    """The from-audio artifact loaded and called in this process."""
    call, meta = export.load_artifact(artifacts["audio"])
    audio = _audio(7, 2)
    buf, cur_len, *_ = call(audio)
    return audio, meta, buf, export.decode_artifact_tokens(buf, cur_len, meta)


def test_artifact_from_audio_equals_jax_decode(models, audio_run):
    _, jm, _ = models
    audio, meta, buf, got = audio_run
    assert meta["input_shape"] == [2, 480000] and meta["outputs"][0] == "buf"
    assert meta["device"] == "cpu" and meta["compute_dtype"] == "float32"
    mels = np.asarray(jlog_mel(audio, DIMS.n_mels))
    expected = jdecode(jm, mels, JOptions(**OPTS, sample_len=8))
    assert [list(e.tokens) for e in expected] == list(got)
    assert buf.shape[0] == 2  # the weights are inside: the call took only the audio


def test_artifact_from_mel_matches_jax_program(models, artifacts):
    """From a mel: JAX ``decode``'s tokens, and the four outputs of JAX's
    ``_greedy_decode_jit(encode=True)`` on the same mel."""
    _, jm, _ = models
    call, meta = export.load_artifact(artifacts["mel"])
    assert meta["input_shape"] == [1, 80, 3000]
    mel = np.asarray(jlog_mel(_audio(9, 1), DIMS.n_mels))
    buf, cur_len, sum_lp, no_speech = call(mel)
    (expected,) = jdecode(jm, mel, JOptions(**OPTS, sample_len=6))
    assert export.decode_artifact_tokens(buf, cur_len, meta)[0] == list(expected.tokens)
    task = jget_task(jm, JOptions(**OPTS, sample_len=6))
    init = jnp.asarray(np.asarray(task.initial_tokens, np.int32)[None])
    jbuf, jcur, jlp, jns, _ = _greedy_decode_jit(
        jm.params, task.loop_cfg, jnp.asarray(mel), init, jax.random.PRNGKey(0),
        jnp.float32(0.0), sample=False, encode=True)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert int(cur_len) == int(jcur) and cur_len.dim() == 0
    np.testing.assert_allclose(sum_lp.numpy(), np.asarray(jlp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(no_speech.numpy(), np.asarray(jns), rtol=1e-4, atol=1e-6)


def test_int8_artifact_from_the_cli(models, artifacts):
    """Written by ``cli.export_decode --quantize int8``: under half the fp
    file, and the tokens of the dequantized weights' decode in both
    packages."""
    params, _, tm = models
    assert os.path.getsize(artifacts["int8"]) < 0.5 * os.path.getsize(artifacts["mel"])
    call, meta = export.load_artifact(artifacts["int8"])
    assert meta["quantize"] == "int8" == artifacts["cli_meta"]["quantize"]
    mel = np.asarray(jlog_mel(_audio(13, 1), DIMS.n_mels))
    buf, cur_len, *_ = call(mel)
    got = export.decode_artifact_tokens(buf, cur_len, meta)[0]
    jdeq = JModel(jquantize.dequantize_params(jquantize.quantize_params(params)), DIMS)
    (jexp,) = jdecode(jdeq, mel, JOptions(**OPTS, sample_len=6))
    tdeq = WhisperModel.from_state_dict(
        quantize.dequantize_params(quantize.quantize_params(tm.module, DIMS)), DIMS, "cpu")
    (texp,) = decode(tdeq, torch.from_numpy(mel), DecodingOptions(**OPTS, sample_len=6))
    assert got == list(jexp.tokens) == list(texp.tokens)


def test_export_refusals_and_bad_files(models, artifacts, tmp_path):
    _, _, tm = models
    with pytest.raises(ValueError, match="greedy-only"):
        export.export_greedy_decode(tm, DecodingOptions(language="en", beam_size=2),
                                    device="cpu")
    with pytest.raises(ValueError, match="fixed language"):
        export.export_greedy_decode(tm, DecodingOptions(language=None), device="cpu")
    with pytest.raises(ValueError, match="kv_int8"):
        export.export_greedy_decode(tm, DecodingOptions(language="en", kv_int8=True),
                                    device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        export.export_greedy_decode(tm, DecodingOptions(**OPTS), batch=1, quantize="int4",
                                    device="cpu")
    with pytest.raises(ValueError, match="card"):
        export.export_greedy_decode(tm, DecodingOptions(**OPTS), device="cpu",
                                    with_kernels=True)
    junk = tmp_path / "junk.qasrt"
    junk.write_bytes(b"NOTANARTIFACT")
    with pytest.raises(ValueError, match="not a qasr export artifact"):
        export.load_artifact(str(junk))
    jax_file = tmp_path / "jax.qasrx"
    jax_file.write_bytes(b"QASRX001" + bytes(16))
    with pytest.raises(ValueError, match="JAX export artifact"):
        export.load_artifact(str(jax_file))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            export_decode.main(["--out", str(tmp_path / "x.qasrt"), "--device", "auto"])


class _AddOne(torch.nn.Module):
    def forward(self, x):
        return x + 1


def test_kernels_artifact_version_warning(tmp_path):
    """A kernels artifact from another torch or other kernel sources loads
    with a warning (the program here is a stand-in: the check reads only
    the metadata)."""
    ep = torch.export.export(_AddOne(), (torch.zeros(2),))
    meta = {"device": "cpu", "with_kernels": True, "torch_version": "0.0",
            "kernels_source_hash": "0" * 16}
    path = str(tmp_path / "kernels.qasrt")
    export.save_artifact(path, ep, meta)
    with pytest.warns(UserWarning, match="stability guarantee"):
        call, got = export.load_artifact(path)
    assert got == meta and torch.equal(call(np.zeros(2, np.float32)), torch.ones(2))
    export.save_artifact(path, ep, {**meta, "torch_version": torch.__version__,
                                    "kernels_source_hash": _kernels.source_hash()})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        export.load_artifact(path)


def test_artifact_runs_with_torch_alone(artifacts, audio_run):
    """A fresh process that can import neither JAX nor the port reads the
    file's sections and runs the program: the tokens of the in-process
    call."""
    audio, _, _, want = audio_run
    np.save(artifacts["tmp"] / "audio.npy", audio)
    code = textwrap.dedent(f"""
        import io, json, sys
        for blocked in ("jax", "jaxlib", "qasr_ijcnlp_tpu", "qasr_ijcnlp_tpu_torch"):
            sys.modules[blocked] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        with open({artifacts["audio"]!r}, "rb") as f:
            assert f.read(8) == b"QASRT001"
            n = int(np.frombuffer(f.read(4), np.uint32)[0])
            meta = json.loads(f.read(n))
            program = torch.export.load(io.BytesIO(f.read())).module()
        audio = torch.from_numpy(np.load({str(artifacts["tmp"] / "audio.npy")!r}))
        with torch.no_grad():
            buf, cur_len, _, _ = program(audio)
        sb, eot = meta["sample_begin"], meta["eot"]
        rows = []
        for row in buf[:, sb:int(cur_len)].tolist():
            rows.append(row[:row.index(eot)] if eot in row else row)
        print(json.dumps(rows))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(artifacts["tmp"]), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [list(t) for t in want]


def test_ops_fakes_agree_with_their_bodies():
    g = torch.Generator().manual_seed(0)
    w = lambda *s: torch.randn(*s, generator=g) * 0.05
    B, T, D = 1, 512, 128
    x = torch.randn(B, T, D, generator=g)
    torch.library.opcheck(library.attention_ln, (x, torch.ones(D), torch.zeros(D), w(D, D),
                                                 w(D), w(D, D), w(D, D), w(D), 2, 500))
    torch.library.opcheck(library.block_finish, (x, x.clone(), w(D, D), w(D), torch.ones(D),
                                                 torch.zeros(D), w(4 * D, D), w(4 * D),
                                                 w(D, 4 * D), w(D)))
    q = torch.randn(B, 2, T, 64, generator=g)
    torch.library.opcheck(library.flash_attention, (q, q.clone(), q.clone(), 500))
    torch.library.opcheck(library.flash_attention_packed, (x, x.clone(), x.clone(), 2, 500))
    mel = torch.randn(B, 80, 1000, generator=g)
    torch.library.opcheck(library.conv_stem_op, (mel, w(D, 80, 3), w(D), w(D, D, 3), w(D),
                                                 w(500, D), 512, torch.float32))
    torch.library.opcheck(library.log10_mel, (torch.randn(B, 16000 + 400, generator=g), 80))


class _Encoder(torch.nn.Module):
    def __init__(self, module, dims):
        super().__init__()
        self.module, self.dims = module, dims

    def forward(self, mel):
        return tmodel.encoder_apply(self.module.encoder, mel, self.dims)


@pytest.mark.parametrize("n_state,n_head,ops_seen", [
    (128, 2, {"conv_stem", "attention_ln", "block_finish"}),  # the fused block
    (128, 4, {"conv_stem", "flash_attention_packed"}),  # heads of 32: K8
    (192, 2, {"conv_stem", "flash_attention"}),  # heads of 96: K7
], ids=["fused", "packed", "4d"])
def test_traced_encoder_records_the_ops(n_state, n_head, ops_seen):
    """Under ``ops.record_ops()`` the encoder's kernel calls become
    ``qasr::`` nodes of an exported program, which computes what the
    encoder computes (on the CPU the ops' bodies are the plain versions)."""
    dims = ModelDimensions(80, 500, n_state, n_head, 1, 51865, 48, n_state, n_head, 1)
    sd = tmodel.init_params(torch.Generator().manual_seed(0), dims)
    m = WhisperModel.from_state_dict(sd, dims, "cpu")
    mel = torch.randn(1, 80, 1000, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), ops.record_ops():
        ep = torch.export.export(_Encoder(m.module, dims), (mel,), strict=False)
    seen = {n.target.name().split("::")[1].split(".")[0] for n in ep.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("qasr.")}
    assert seen == ops_seen
    with torch.no_grad():
        want = tmodel.encoder_apply(m.module.encoder, mel, dims)
        assert torch.equal(ep.module()(mel), want)
    assert not ops.recording_ops()
