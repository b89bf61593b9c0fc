"""Port Whisper model (qasr_ijcnlp_tpu_torch/models/) vs the JAX model.

Weights cross over through numpy.  The whole encoder is held against JAX
``encoder_apply`` with its kernel path on (the Pallas stem and fused blocks
in interpret mode) at atol 5e-5; decoder logits at atol 5e-4, the bound of
tests/test_model_parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.convert import to_torch_state_dict
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_params
from tests.torch_port_common import DIMS, jax_params, torch_model


@pytest.fixture(scope="module")
def models():
    params = jax_params(5)
    return params, torch_model(params)


@pytest.fixture(scope="module")
def features():
    return np.random.default_rng(6).standard_normal(
        (2, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)


def test_from_jax_params_mirrors_to_torch_state_dict(models):
    params, _ = models
    ref = to_torch_state_dict(params, DIMS)
    ours = from_jax_params(params, DIMS)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_init_params_matches_module_layout():
    sd = tmodel.init_params(torch.Generator().manual_seed(0), DIMS)
    ref = tmodel.Whisper(DIMS).state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k
    bound = 1 / np.sqrt(DIMS.n_audio_state)
    assert float(sd["encoder.blocks.0.attn.query.weight"].abs().max()) <= bound
    assert "encoder.blocks.0.attn.key.bias" not in sd
    again = tmodel.init_params(torch.Generator().manual_seed(0), DIMS)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_encoder_matches_jax_kernel_path(models):
    params, m = models
    mel = np.random.default_rng(7).standard_normal((2, 80, 1000)).astype(np.float32)
    jmodel.set_flash_attention(True)
    try:
        ref = np.asarray(jmodel.encoder_apply(params["encoder"], jnp.asarray(mel), DIMS))
    finally:
        jmodel.set_flash_attention(None)
    ours = tmodel.encoder_apply(m.module.encoder, torch.from_numpy(mel), DIMS)
    assert tuple(ours.shape) == ref.shape == (2, DIMS.n_audio_ctx, DIMS.n_audio_state)
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("t_real", [None, 40])
def test_attention_matches_jax(t_real):
    """Plain multi-head attention, with keys >= t_real masked."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 48, 128)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jmodel.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      2, t_real=t_real))
    ours = tmodel.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            2, t_real=t_real)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_attention_bf16_heads_scaled_as_jax(monkeypatch):
    """bf16 q and k heads, scaled by dh^-0.25, equal JAX's bit for bit.

    JAX rounds the Python-float factor to bf16 before the product; PyTorch
    would multiply in fp32 and round once, which moves about 2.5% of the
    values by one ulp.  Checked on the heads that attention() feeds to the
    softmax, not on its output: the two frameworks sum bf16 products in
    different orders, so the output is not bit-comparable."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((2, 48, 128)).astype(np.float32) for _ in range(3))
    ref = {name: np.asarray((jmodel._split_heads(jnp.asarray(a, jnp.bfloat16), 2)
                             * (64 ** -0.25)).astype(jnp.float32))
           for name, a in (("q", q), ("k", k))}
    seen = {}
    attend = tmodel._attend

    def spy(qh, kh, vh, mask=None):
        seen["q"], seen["k"] = qh, kh
        return attend(qh, kh, vh, mask)

    monkeypatch.setattr(tmodel, "_attend", spy)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tmodel.attention(bf16(q), bf16(k), bf16(v), 2)
    for name in ("q", "k"):
        assert seen[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(seen[name].float().numpy(), ref[name], err_msg=name)


def test_decoder_apply_matches_jax(models, features):
    params, m = models
    tokens = np.array([[50258, 50259, 50359, 220, 1000], [50258, 50260, 50359, 11, 7]])
    ref = np.asarray(jmodel.decoder_apply(params["decoder"], jnp.asarray(tokens),
                                          jnp.asarray(features), DIMS))
    ours = tmodel.decoder_apply(m.module.decoder, torch.from_numpy(tokens),
                                torch.from_numpy(features), DIMS)
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-4)


def test_decoder_step_matches_jax(models, features):
    """Prompt pass then two single-token steps over a bounded cache."""
    params, m = models
    prompt = np.array([[50258, 50259, 50359], [50258, 50259, 50359]])
    steps = [np.array([[220], [11]]), np.array([[1000], [7]])]
    ctx = 16

    jc = jmodel.init_kv_cache(DIMS, 2, ctx=ctx)
    jc = jmodel.precompute_cross_kv(params["decoder"], jnp.asarray(features), jc)
    tc = tmodel.init_kv_cache(DIMS, 2, device="cpu", ctx=ctx)
    tc = tmodel.precompute_cross_kv(m.module.decoder, torch.from_numpy(features), tc)
    for toks in [prompt] + steps:
        ref, jc = jmodel.decoder_step(params["decoder"], jnp.asarray(toks), jc, DIMS)
        ours, tc = tmodel.decoder_step(m.module.decoder, torch.from_numpy(toks), tc, DIMS)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-4)
    assert tc["idx"] == int(jc["idx"]) == 5


@pytest.mark.parametrize("feature", ["offsets"])
def test_unported_decoder_features_raise(models, features, feature):
    """Per-row offsets (speculative decode, the decode engine), once refused,
    now run: a prompt at offset 0 of every row, then one token per row at
    ragged positions, as JAX's per-row path gives them (logits within the
    scalar step's 5e-4)."""
    params, m = models
    prompt = np.array([[50258, 50259, 50359], [50258, 50259, 50359]])
    tok = np.array([[220], [11]])
    jc = jmodel.init_kv_cache(DIMS, 2, ctx=16)
    jc = jmodel.precompute_cross_kv(params["decoder"], jnp.asarray(features), jc)
    tc = tmodel.init_kv_cache(DIMS, 2, device="cpu", ctx=16)
    tc = tmodel.precompute_cross_kv(m.module.decoder, torch.from_numpy(features), tc)
    for toks, off in ((prompt, [0, 0]), (tok, [3, 2])):
        ref, jc = jmodel.decoder_step(params["decoder"], jnp.asarray(toks), jc, DIMS,
                                      offsets=jnp.asarray(off))
        ours, tc = tmodel.decoder_step(m.module.decoder, torch.from_numpy(toks), tc, DIMS,
                                       offsets=torch.tensor(off))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-4)
    assert tc["idx"] == 0