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
from tests.torch_port_common import DIMS, int8_attention_split, jax_params, torch_model


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


def test_split_rule():
    """The kernel's split of the audio axis: the largest of 8, 7 and 6
    blocks whose clusters the card holds at once (``fits``; 8 where none
    does), fewer where t_real holds fewer chunks of 16 positions (at every
    driven shape, t_real 1500, 6 to 8); the chunks cover [0, t_real), the
    first is never empty, and each chunk's copy (rounded up to 16
    positions) stays inside round_up(t_real, 16) <= Tp."""
    assert decode_attn.split(1500) == (8, 192)
    assert decode_attn.split(1500, lambda S, cs: S <= 6) == (6, 256)
    assert decode_attn.split(1500, lambda S, cs: S == 7 and cs == 224) == (7, 224)
    assert decode_attn.split(1500, lambda S, cs: False) == (8, 192)
    assert decode_attn.split(100, lambda S, cs: S <= 6) == (6, 32)
    assert decode_attn.split(200) == (8, 32)   # the 8th chunk, at 224, is empty
    assert decode_attn.split(40) == (3, 16)
    assert decode_attn.split(16) == (1, 16)
    assert decode_attn.split(1) == (1, 16)
    for t_real in range(1, 1537):
        S, cs = decode_attn.split(t_real)
        assert 1 <= S <= decode_attn.MAX_SPLIT and cs % 16 == 0
        assert S * cs >= t_real and cs <= decode_attn.round_up(t_real, 16)
        assert S == min(8, -(-t_real // 16))
        for s in range(S):
            t0 = min(s * cs, t_real)
            n = min(t_real, t0 + cs) - t0
            assert t0 + decode_attn.round_up(n, 16) <= decode_attn.round_up(t_real, 16)


# name: (B, G, T_new, H, Dh, Ta, t_real, S); S None = the kernel's split
SPLIT_CASES = {
    "large-v3-step": (1, 1, 1, 20, 64, 1500, 1500, None),
    "g5": (2, 5, 1, 4, 64, 200, 190, None),
    "r9": (2, 3, 3, 2, 64, 300, 300, None),
    "empty-chunk": (2, 1, 4, 2, 64, 200, 197, None),     # cs 32: the 8th holds nothing
    "short": (2, 2, 1, 2, 64, 40, 40, 8),                # t_real < 16 S: 5 empty
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_int8_split_merge_matches_plain_and_jax(case):
    """The kernel's split-and-merge arithmetic (``int8_attention_split``)
    against the plain version (1e-6) and the JAX kernel in interpret mode
    (the file's 2e-5 / 1e-5)."""
    B, G, T_new, H, Dh, Ta, t_real, S = SPLIT_CASES[case]
    S = S or decode_attn.split(t_real)[0]
    cs = decode_attn.chunk(t_real, S)
    if case in ("empty-chunk", "short"):
        assert (S - 1) * cs >= t_real
    rng = np.random.default_rng(sum(map(ord, case)))
    D = H * Dh
    k = jnp.asarray(rng.standard_normal((B, Ta, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, Ta, D)), jnp.float32)
    q = rng.standard_normal((B * G, T_new, D)).astype(np.float32)
    k8, sk = jattn.quantize_kv(k, H)
    v8, sv = jattn.quantize_kv(v, H)
    cache = (*_port_layout(k8, sk), *_port_layout(v8, sv))
    split = int8_attention_split(torch.from_numpy(q), *cache, H, t_real, S)
    plain = decode_attn.int8_cross_attention_plain(torch.from_numpy(q), *cache, H, t_real)
    assert split.dtype == torch.float32 and split.shape == (B * G, T_new, D)
    assert torch.isfinite(split).all()
    assert float((split - plain).abs().max()) <= 1e-6
    ref = np.asarray(jattn.int8_cross_attention(jnp.asarray(q), k8, sk, v8, sv, H, t_real))
    np.testing.assert_allclose(split.numpy(), ref, atol=2e-5, rtol=1e-5)


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
