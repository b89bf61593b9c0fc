"""Port quantum layer and quantum Whisper (qasr_ijcnlp_tpu_torch/ops/qsim.py,
models/quantum.py) vs the JAX package and the gate-by-gate oracle.

The closed-form simulator is held to 1e-6 against both JAX and
``tests/quantum_oracle.py`` (tests/test_quantum.py's bound), the hybrid
convolution to 1e-5, the quantum encoder at f32 to 5e-5 (the encoder bound
of tests/test_torch_whisper.py), and decode on quantum weights token for
token against JAX's.  Weights cross from JAX's ``init_*`` through numpy and
``models.convert``.  Every encoder call site (decode, the draft,
``embed_audio``, ``forward``, the decode engine, transcribe and its
alignment) runs the quantum stem through ``dispatch_encoder_apply`` and
never the classical stem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions, decode as jdecode
from qasr_ijcnlp_tpu.models import quantum as jqm
from qasr_ijcnlp_tpu.models.dims import ModelDimensions
from qasr_ijcnlp_tpu.ops import qsim as jqsim
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine
from qasr_ijcnlp_tpu_torch.models import convert, quantum as tqm
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.ops import qsim
from tests import quantum_oracle as oracle
from tests.torch_port_common import DIMS, LF_DIMS, one_torch_thread  # noqa: F401

NO_TS = dict(language="en", without_timestamps=True, sample_len=8)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _port_conv(p):
    """The port's QuantumConv1d holding JAX layer ``p``'s values."""
    sd = {}
    convert._quantum_conv(sd, "l", jax.tree.map(np.asarray, p))
    nq, d_in = sd["l.pre.weight"].shape
    layer = tqm.QuantumConv1d(d_in // 3, sd["l.post.weight"].shape[0], 3, nq)
    layer.load_state_dict({k[2:]: v for k, v in sd.items()})
    return layer.requires_grad_(False)


@pytest.fixture(scope="module")
def qparams():
    """JAX quantum params (numpy leaves) at DIMS, 4 qubits."""
    return jax.tree.map(np.asarray, jqm.init_quantum_params(jax.random.PRNGKey(0), DIMS, 4))


@pytest.fixture(scope="module")
def models(qparams):
    jm = jqm.QuantumWhisperModel(jax.tree.map(jnp.asarray, qparams), DIMS, n_qubits=4)
    tm = tqm.QuantumWhisperModel.from_state_dict(convert.from_jax_params(qparams, DIMS),
                                                 DIMS, "cpu")
    return jm, tm


# -- the simulator ---------------------------------------------------------------------

@pytest.mark.parametrize("n_qubits", [2, 3, 4, 6, 8])
def test_expvals_match_jax_and_oracle(rng, n_qubits):
    w = rng.standard_normal((n_qubits, 3)).astype(np.float32)
    x = rng.standard_normal((5, n_qubits)).astype(np.float32)
    ours = qsim.quantum_expvals(_t(x), _t(w), n_qubits).numpy()
    ref = np.asarray(jqsim.quantum_expvals(jnp.asarray(x), jnp.asarray(w), n_qubits))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    for j in range(5):
        np.testing.assert_allclose(ours[j], oracle.simulate_circuit(x[j], w, n_qubits),
                                   atol=1e-6)


def test_expvals_full_amplitude_input(rng):
    w = rng.standard_normal((3, 3)).astype(np.float32)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    ours = qsim.quantum_expvals(_t(x), _t(w), 3).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jqsim.quantum_expvals(jnp.asarray(x), jnp.asarray(w), 3)), atol=1e-6)
    for j in range(4):
        np.testing.assert_allclose(ours[j], oracle.simulate_circuit(x[j], w, 3), atol=1e-6)
    with pytest.raises(ValueError):
        qsim.quantum_expvals(_t(rng.standard_normal((1, 9))), _t(w), 3)


def test_unitary_is_unitary_and_equals_jax(rng):
    w = rng.standard_normal((4, 3)).astype(np.float32)
    ur, ui = qsim.circuit_unitary(_t(w), 4)
    jr, ji = jqsim.circuit_unitary(jnp.asarray(w), 4)
    np.testing.assert_allclose(ur.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(ui.numpy(), np.asarray(ji), atol=1e-6)
    u = ur.double().numpy() + 1j * ui.double().numpy()
    np.testing.assert_allclose(u @ u.conj().T, np.eye(16), atol=1e-6)
    for n in (2, 3, 5):
        np.testing.assert_array_equal(qsim.cnot_chain_permutation(n),
                                      jqsim.cnot_chain_permutation(n))
        np.testing.assert_array_equal(qsim.pauli_z_diagonal(n), jqsim.pauli_z_diagonal(n))


def test_gradients_match_finite_differences(rng):
    """Autograd through the angles and through the embedding's norm, against
    central differences of the oracle (tests/test_quantum.py's bound)."""
    n = 3
    w = rng.standard_normal((n, 3))
    x = rng.standard_normal((n,)) + 1.0
    wt = _t(w).requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    (qsim.quantum_expvals(xt[None], wt, n) ** 2).sum().backward()
    eps = 1e-5
    for i in range(n):
        for j in range(3):
            wp, wm = w.copy(), w.copy()
            wp[i, j] += eps
            wm[i, j] -= eps
            fd = (np.sum(oracle.simulate_circuit(x, wp, n) ** 2)
                  - np.sum(oracle.simulate_circuit(x, wm, n) ** 2)) / (2 * eps)
            np.testing.assert_allclose(wt.grad[i, j].item(), fd, atol=1e-4)
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        fd = (np.sum(oracle.simulate_circuit(xp, w, n) ** 2)
              - np.sum(oracle.simulate_circuit(xm, w, n) ** 2)) / (2 * eps)
        np.testing.assert_allclose(xt.grad[i].item(), fd, atol=1e-4)
    assert np.abs(xt.grad.numpy()).max() > 0


def test_zero_input_window_finite_gradients():
    """An all-zero window gives zero expvals and finite gradients: the eps
    guard sits inside the sqrt."""
    w = _t(np.random.default_rng(0).normal(size=(3, 3))).requires_grad_(True)
    x = torch.zeros(2, 3, requires_grad=True)
    out = qsim.quantum_expvals(x, w, 3)
    assert torch.isfinite(out).all()
    (out ** 2).sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


# Hand-derived golden vectors (tests/test_quantum.py): an RY chain from
# |000> gives <Z_i> = prod_{j<=i} cos(theta_j); the Bell case pins the CNOT
# direction and the wire order; the phase case pins the Rot convention.
@pytest.mark.parametrize("weights,inputs,expected", [
    ([[0.0, np.pi / 3, 0.0], [0.0, np.pi / 4, 0.0], [0.0, np.pi / 6, 0.0]], [1.0, 0.0, 0.0],
     [0.5, np.sqrt(2.0) / 4.0, np.sqrt(6.0) / 8.0]),
    ([[0.0, np.pi / 2, 0.0], [0.0, 0.0, 0.0]], [1.0, 0.0], [0.0, 0.0]),
    ([[0.0, 0.0, 0.0], [np.pi / 2, np.pi / 2, 0.0]], [1.0, 1.0], [1.0, 0.0]),
], ids=["ry_chain", "bell", "phases"])
def test_qsim_analytic_golden(weights, inputs, expected):
    n = len(weights)
    got = qsim.quantum_expvals(_t([inputs]), _t(weights), n)[0].numpy()
    np.testing.assert_allclose(got, expected, atol=1e-6)


# -- the hybrid convolution ---------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_quantum_conv1d_matches_jax_and_loop_reference(rng, stride):
    p = jqm.init_quantum_conv(jax.random.PRNGKey(3), 8, 16, 3, n_qubits=4)
    x = rng.standard_normal((2, 8, 20)).astype(np.float32)
    ours = tqm.quantum_conv1d(_port_conv(p), _t(x), 3, stride, 1).numpy()
    ref = np.asarray(jqm.quantum_conv1d(p, jnp.asarray(x), 3, stride, 1))
    assert ours.shape == ref.shape == (2, 16, 20 // stride)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    pn = jax.tree.map(np.asarray, p)
    loop = oracle.quantum_conv1d_reference(
        x, pn["pre_w"], pn["pre_b"], pn["post_w"], pn["post_b"], pn["qweights"],
        kernel_size=3, stride=stride, padding=1, n_qubits=4)
    np.testing.assert_allclose(ours, loop, atol=1e-5)


def test_windows_list_taps_fastest(monkeypatch):
    """Feature c k + j of a window is channel c at tap j: a pre weight with
    one nonzero column selects exactly that (channel, tap)."""
    C, k, L = 3, 3, 6
    layer = tqm.QuantumConv1d(C, 1, k, n_qubits=1)
    x = torch.arange(C * L, dtype=torch.float32).reshape(1, C, L) + 1
    seen = {}
    orig = qsim.quantum_expvals

    def spy(inputs, weights, n, eps=1e-12):
        seen["pre"] = inputs.detach().clone()
        return orig(inputs, weights, n, eps)

    with torch.no_grad():
        layer.pre.weight.zero_()
        layer.pre.bias.zero_()
        layer.pre.weight[0, 1 * k + 2] = 1.0  # channel 1, tap 2
        layer.qweights.zero_()
        layer.post.weight.fill_(1.0)
        layer.post.bias.zero_()
    monkeypatch.setattr(tqm, "quantum_expvals", spy)
    tqm.quantum_conv1d(layer, x, k, 1, 0)
    np.testing.assert_array_equal(seen["pre"][0, :, 0].numpy(), x[0, 1, 2:].numpy())


def test_qubit_clamping():
    assert tqm.quantum_conv_spec(1, 2, 8) == 2 == jqm.quantum_conv_spec(1, 2, 8)
    assert tqm.QuantumConv1d(1, 4, 2, n_qubits=8).qweights.shape == (2, 3)


def test_trainable_mask_and_param_budget():
    dims = ModelDimensions(n_mels=80, n_audio_ctx=50, n_audio_state=384, n_audio_head=6,
                           n_audio_layer=1, n_vocab=1000, n_text_ctx=24, n_text_state=384,
                           n_text_head=6, n_text_layer=1)
    sd = tqm.init_quantum_params(torch.Generator().manual_seed(0), dims, n_qubits=4)
    mask = tqm.trainable_mask(sd)
    expected = (240 * 4 + 4 + 4 * 384 + 384 + 12) + (1152 * 4 + 4 + 4 * 384 + 384 + 12)
    assert tqm.count_params({n: sd[n] for n in mask}) == expected
    assert all(n.startswith(("encoder.qconv1.", "encoder.qconv2.")) for n in mask)
    module = tqm.QuantumWhisper(dims, 4)
    names = tqm.trainable_mask(module, extra_names=("ln_post",), set_requires_grad=True)
    assert names == {n for n, p in module.named_parameters() if p.requires_grad}
    assert "encoder.ln_post.weight" in names and "decoder.ln.weight" not in names
    assert tqm.count_params(module) == sum(p.numel() for p in module.parameters())
    # the JAX package's shapes (pre_w (240, 4) as (out, in)) and bounds
    assert sd["encoder.qconv1.pre.weight"].shape == (4, 240)
    assert sd["encoder.qconv1.pre.weight"].abs().max() <= 1 / np.sqrt(240)
    assert sd["encoder.qconv2.post.weight"].abs().max() <= 1 / np.sqrt(4)


# -- the quantum encoder and its call sites ---------------------------------------------------

def test_quantum_encoder_matches_jax(models, qparams):
    jm, tm = models
    mel = np.random.default_rng(1).standard_normal((2, 80, 1000)).astype(np.float32)
    ref = np.asarray(jqm.quantum_encoder_apply(jax.tree.map(jnp.asarray, qparams["encoder"]),
                                               jnp.asarray(mel), DIMS))
    ours = tqm.quantum_encoder_apply(tm.module.encoder, _t(mel), DIMS)
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5)
    np.testing.assert_array_equal(tm.embed_audio(mel).numpy(), ours.numpy())
    np.testing.assert_array_equal(
        tmodel.dispatch_encoder_apply(tm.module.encoder, _t(mel), DIMS).numpy(), ours.numpy())


def test_quantum_stem_runs_f32_in_bf16(models):
    """In bf16 both hybrid convolutions and GELUs run in f32; the cast comes
    after conv2, then the positions are added in bf16."""
    _, tm = models
    enc = tm.module.encoder
    mel = _t(np.random.default_rng(2).standard_normal((1, 80, 1000)))
    x = mel.transpose(1, 2)  # channels-last, as the stem lays it out
    x = torch.nn.functional.gelu(tqm._conv_channels_last(enc.qconv1, x, 3, 1, 1))
    x = torch.nn.functional.gelu(tqm._conv_channels_last(enc.qconv2, x, 3, 2, 1))
    assert x.dtype == torch.float32
    want = x.to(torch.bfloat16) + enc.positional_embedding.to(torch.bfloat16)
    got = tqm.quantum_stem(enc, mel, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_quantum_decode_token_exact_vs_jax(models):
    """The port's mirror of tests/test_quantum_decode.py at narrow dims:
    decode on quantum weights equals JAX's token for token, and the
    features equal JAX's embed_audio."""
    jm, tm = models
    mel = np.random.default_rng(3).standard_normal((2, 80, 1000)).astype(np.float32)
    ref = jdecode(jm, jnp.asarray(mel), JOptions(fp16=False, **NO_TS))
    ours = port.decode(tm, mel, port.DecodingOptions(fp16=False, **NO_TS))
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
    assert [r.text for r in ours] == [r.text for r in ref]
    for o, r in zip(ours, ref):
        assert o.avg_logprob == pytest.approx(r.avg_logprob, abs=1e-4)
    np.testing.assert_allclose(tm.embed_audio(mel).numpy(), np.asarray(jm.embed_audio(mel)),
                               atol=5e-5)


def test_engine_request_equals_decode(models):
    _, tm = models
    mel = np.random.default_rng(4).standard_normal((2, 80, 1000)).astype(np.float32)
    opts = port.DecodingOptions(fp16=False, **NO_TS)
    want = port.decode(tm, mel, opts)
    engine = DecodeEngine(tm, opts, slots=2, unroll=2)
    try:
        got = [engine.submit(m, timeout=300) for m in mel]
    finally:
        engine.close()
    assert [g["tokens"] for g in got] == [w.tokens for w in want]


def test_quantum_encoder_never_reaches_classical_stem(monkeypatch, models):
    """With the classical stem made to raise, decode (and a quantum draft),
    embed_audio, forward, the engine and transcribe with word timings all
    run on a quantum model; a classical model hits the trap."""
    _, tm = models

    def trap(*a, **k):
        raise AssertionError("the classical stem ran")

    monkeypatch.setattr(tmodel, "fused_conv_stem", trap)
    mel = np.random.default_rng(5).standard_normal((1, 80, 1000)).astype(np.float32)
    opts = port.DecodingOptions(fp16=False, **NO_TS)
    r = port.decode(tm, mel, opts)
    d = port.decode(tm, mel, port.DecodingOptions(fp16=False, draft=port.Draft(tm, 2), **NO_TS))
    assert d[0].tokens == r[0].tokens
    assert tm.embed_audio(mel).shape == (1, DIMS.n_audio_ctx, DIMS.n_audio_state)
    assert tm.forward(mel, torch.tensor([[50258]])).shape[-1] == DIMS.n_vocab
    engine = DecodeEngine(tm, opts, slots=1, unroll=2)
    try:
        assert engine.submit(mel[0], timeout=300)["tokens"] == r[0].tokens
    finally:
        engine.close()
    lf = tqm.QuantumWhisperModel.from_state_dict(
        tqm.init_quantum_params(torch.Generator().manual_seed(1), LF_DIMS, 4), LF_DIMS, "cpu")
    out = lf.transcribe(np.random.default_rng(6).standard_normal(16000 * 3).astype(np.float32)
                        * 0.1, language="en", sample_len=4, temperature=0.0,
                        word_timestamps=True)
    assert out["segments"] and "words" in out["segments"][0]
    classical = port.WhisperModel.from_state_dict(
        tmodel.init_params(torch.Generator().manual_seed(0), DIMS), DIMS, "cpu")
    with pytest.raises(AssertionError, match="classical stem"):
        classical.embed_audio(mel)


def test_save_model_refuses_quantum(models, tmp_path):
    _, tm = models
    with pytest.raises(ValueError, match="no quantum stem"):
        port.save_model(tm, str(tmp_path / "q.pt"))


def test_create_quantum_from_model_copies_the_trunk():
    classical = port.WhisperModel.from_state_dict(
        tmodel.init_params(torch.Generator().manual_seed(0), DIMS), DIMS, "cpu",
        name="narrow")
    q = tqm.create_quantum_whisper_from_model(classical, n_qubits=3)
    assert isinstance(q, tqm.QuantumWhisperModel) and q.name == "quantum-narrow"
    assert q.n_qubits == 3 and q.device == classical.device
    qs, cs = q.module.state_dict(), classical.module.state_dict()
    for k, v in cs.items():
        if k.startswith(("encoder.conv1", "encoder.conv2")):
            assert k not in qs
        else:
            torch.testing.assert_close(qs[k], v, atol=0, rtol=0)
    assert tqm.create_quantum_whisper_from_official is tqm.create_quantum_whisper_from_model


def test_converters_round_trip(qparams):
    enc = convert.from_jax_encoder(qparams["encoder"], DIMS, "")
    back = convert.to_jax_encoder(enc, DIMS)
    assert jax.tree.structure(back) == jax.tree.structure(qparams["encoder"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(qparams["encoder"])):
        np.testing.assert_array_equal(a, b)
    classical = jax.tree.map(np.asarray, jqm.cmodel.init_params(jax.random.PRNGKey(1), DIMS))
    back = convert.to_jax_encoder(convert.from_jax_encoder(classical["encoder"], DIMS, ""),
                                  DIMS)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(classical["encoder"])):
        np.testing.assert_array_equal(a, b)
