"""Port int8 cross K/V (qasr_ijcnlp_tpu_torch/ops/decode_attn.py, K9's plain
version, and the int8 branches of models/whisper.py) vs the JAX package.

``quantize_kv`` must give JAX's codes and scales bit for bit (after the
layout transpose: the port keeps (B, H, Tp, Dh), JAX (B, H, Dh, Tp)).  The
attention is held to the JAX kernel (interpret mode) at the JAX test's own
tolerance, atol 2e-5 / rtol 1e-5 (tests/test_ops.py); the int8 decoder
step to JAX's at the fp step's atol 5e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.ops import decode_attn as jattn
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.ops import decode_attn
from tests.torch_port_common import DIMS, jax_params, torch_model


def _port_layout(codes, scales):
    """JAX (B, H, Dh, Tp) codes -> the port's (B, H, Tp, Dh)."""
    return (torch.from_numpy(np.asarray(codes).transpose(0, 1, 3, 2).copy()),
            torch.from_numpy(np.array(scales)))


def test_quantize_kv_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 200, 256)) * 3).astype(np.float32)
    x[:, 7] = 0.0                  # a whole-zero position (scale 0)
    x[0, 11, 64:128] = 0.0         # one head of one position all zero
    x[1, ::5, ::3] = 0.0           # scattered exact zeros
    # head 0 of (1, 3): max 127, so scale 1 and these values sit on rounding
    # midpoints, which both sides must round half to even
    x[1, 3, :7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]
    codes, scales = decode_attn.quantize_kv(torch.from_numpy(x), 4)
    assert float(scales[1, 0, 3]) == 1.0
    assert codes[1, 0, 3, :7].tolist() == [127, 0, 2, 2, 0, -2, 126]
    ref_codes, ref_scales = _port_layout(*jattn.quantize_kv(jnp.asarray(x), 4))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert codes.shape == (2, 4, 256, 64) and scales.shape == (2, 4, 256)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(scales, ref_scales)
    assert float(scales[:, :, 200:].abs().max()) == 0.0
    assert int(codes[:, :, 200:].abs().max()) == 0
    assert float(scales[:, :, 7].abs().max()) == 0.0


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("T_new", [1, 4])
def test_int8_cross_attention_plain_matches_jax_kernel(G, T_new):
    rng = np.random.default_rng(10 * G + T_new)
    B, H, Dh, Ta = 2, 4, 64, 200
    D = H * Dh
    k = jnp.asarray(rng.standard_normal((B, Ta, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, Ta, D)), jnp.float32)
    q = rng.standard_normal((B * G, T_new, D)).astype(np.float32)
    k8, sk = jattn.quantize_kv(k, H)
    v8, sv = jattn.quantize_kv(v, H)
    ref = np.asarray(jattn.int8_cross_attention(jnp.asarray(q), k8, sk, v8, sv, H, Ta))
    ours = decode_attn.int8_cross_attention(
        torch.from_numpy(q), *_port_layout(k8, sk), *_port_layout(v8, sv), H, Ta)
    assert ours.dtype == torch.float32 and ours.shape == (B * G, T_new, D)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("Dh", [128, 40])
def test_int8_cross_attention_wide_heads_match_jax_kernel(Dh):
    """Head widths other than 64: 128 (16-byte code loads on the card) and
    40 (not a multiple of 16: single-byte loads), one step and a prompt."""
    rng = np.random.default_rng(Dh)
    B, H, Ta = 2, 2, 200
    D = H * Dh
    k = jnp.asarray(rng.standard_normal((B, Ta, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, Ta, D)), jnp.float32)
    k8, sk = jattn.quantize_kv(k, H)
    v8, sv = jattn.quantize_kv(v, H)
    for T_new in (1, 4):
        q = rng.standard_normal((B, T_new, D)).astype(np.float32)
        ref = np.asarray(jattn.int8_cross_attention(jnp.asarray(q), k8, sk, v8, sv, H, Ta))
        ours = decode_attn.int8_cross_attention(
            torch.from_numpy(q), *_port_layout(k8, sk), *_port_layout(v8, sv), H, Ta)
        assert ours.shape == (B, T_new, D)
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    params = jax_params(4)
    return params, torch_model(params)


@pytest.fixture(scope="module")
def features():
    return np.random.default_rng(12).standard_normal(
        (2, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)


def _steps():
    prompt = np.array([[50258, 50259, 50359, 50363], [50258, 50260, 50359, 50363]])
    rng = np.random.default_rng(13)
    return [prompt] + [rng.integers(0, 50000, (2, 1)) for _ in range(4)]


def test_int8_precompute_matches_jax(models, features):
    """Codes and scales of every layer's cross K/V, quantized from the fp32
    projections: the scales within fp32 summation order of JAX's, and codes
    equal except where that order moves a value across a rounding
    midpoint."""
    params, m = models
    jc = jmodel.precompute_cross_kv(
        params["decoder"], jnp.asarray(features),
        jmodel.init_kv_cache(DIMS, 2, ctx=16, cross_int8=True))
    tc = tmodel.precompute_cross_kv(
        m.module.decoder, torch.from_numpy(features),
        tmodel.init_kv_cache(DIMS, 2, device="cpu", ctx=16, cross_int8=True))
    for name in ("k", "v"):
        for l in range(DIMS.n_text_layer):
            codes, scales = _port_layout(jc[f"cross_{name}8"][l], jc[f"cross_s{name}"][l])
            np.testing.assert_allclose(tc[f"cross_s{name}"][l].numpy(), scales.numpy(),
                                       rtol=1e-5, atol=1e-7)
            diff = (tc[f"cross_{name}8"][l].int() - codes.int()).abs()
            assert int(diff.max()) <= 1
            assert float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decoder_step_matches_jax(models, features, dtype):
    """Prompt pass then four single-token steps over the int8 cache.  In
    bf16 the cross K/V are still projected with the fp32 weights, as the
    JAX package projects them (``decoder_for(bfloat16)`` holds rounded
    ones, which ``precompute_cross_kv`` refuses)."""
    params, m = models
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ctx = 16
    jc = jmodel.precompute_cross_kv(
        params["decoder"], jnp.asarray(features),
        jmodel.init_kv_cache(DIMS, 2, jdt, ctx=ctx, cross_int8=True))
    tc = tmodel.precompute_cross_kv(
        m.module.decoder, torch.from_numpy(features),
        tmodel.init_kv_cache(DIMS, 2, tdt, "cpu", ctx=ctx, cross_int8=True))
    decoder = m.decoder_for(tdt)
    if dtype == "bfloat16":
        with pytest.raises(ValueError, match="fp32"):
            tmodel.precompute_cross_kv(decoder, torch.from_numpy(features),
                                       tmodel.init_kv_cache(DIMS, 2, tdt, "cpu", ctx=ctx,
                                                            cross_int8=True))
    # f32: the fp step's bound; bf16: 2.5 bf16 ulps of the O(1) logits (the
    # two frameworks round bf16 products summed in different orders)
    atol = 5e-4 if dtype == "float32" else 2e-2
    for toks in _steps():
        ref, jc = jmodel.decoder_step(params["decoder"], jnp.asarray(toks), jc, DIMS, jdt)
        ours, tc = tmodel.decoder_step(decoder, torch.from_numpy(toks), tc, DIMS, tdt)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref, np.float32), atol=atol)
    assert tc["idx"] == int(jc["idx"]) == 8
