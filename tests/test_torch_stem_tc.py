"""The tensor-core conv stem (K2/K3, csrc/conv_stem.cu) and mel frontend
(K1, csrc/melfront.cu) vs the JAX package, and the stem's weight pack.

The kernels run only on the card.  Here ``tests/torch_port_common.py``
``stem_tap_model`` and ``mel_tap_model`` compute what they compute in plain
PyTorch: the packed weights and cached tables the card path uses, times the
tap views of the padded row buffers exactly as the kernels index them
(conv1's two leading zero rows, y1's one leading zero row and 2P row pitch,
conv2's stride-2 rows; K1's 160-sample hop rows, three a frame), with the
3xTF32 products of f32.  They are held to the JAX package's stem (its XLA
oracle ``_xla_stem``) and mel kernel (Pallas, interpret mode) at the repo's
bounds: stem f32 atol 1e-5 (tests/test_conv_stem.py; 3e-5 at D 1024, as
for the JAX chunked kernel), mel 2e-4 after the clamp and scaling
(tests/test_ops.py).  A tap shifted by one row must fail them.

bf16: the port's stem (its plain version on the CPU) and the layout model
against JAX's Pallas stem in interpret mode, within twice the Pallas
kernel's own bf16-vs-f32 distance: the two round at other points (Pallas
each tap's product, the port each convolution's sum, as XLA and cuDNN do),
which is rounding noise of that size.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.ops.conv_stem import _xla_stem, fused_conv_stem as jax_stem
from qasr_ijcnlp_tpu.ops.melfront import fused_log_mel_spectrogram as jax_fused_mel
from qasr_ijcnlp_tpu_torch.ops import conv_stem, melfront
from tests.test_torch_conv_stem import _jax_stem_params, _wide_stem
from tests.torch_port_common import (
    T_PAD, jax_params, mel_tap_model, stem_tap_model, torch_model,
)

NOISE_FACTOR = 2.0


@pytest.fixture(scope="module")
def tier1():
    """The tier-1 geometry (D 128, 80 mels) with JAX's weights, and a mel
    of 1000 frames for two items."""
    params = jax_params(0)
    mel = np.random.default_rng(1).standard_normal((2, 80, 1000)).astype(np.float32)
    return _jax_stem_params(params), torch_model(params).module.encoder, mel


@pytest.mark.parametrize("port", ["plain", "tap_model"])
def test_bf16_stem_matches_jax_pallas(tier1, port):
    jp, enc, mel = tier1
    ref16 = np.asarray(jax_stem(jp, jnp.asarray(mel), T_PAD, "bfloat16").astype(jnp.float32))
    ref32 = np.asarray(jax_stem(jp, jnp.asarray(mel), T_PAD, "float32"))
    limit = NOISE_FACTOR * float(np.abs(ref16 - ref32).max())
    x = torch.from_numpy(mel)
    ours = (conv_stem.fused_conv_stem(enc, x, T_PAD, torch.bfloat16) if port == "plain"
            else stem_tap_model(enc, x, T_PAD, torch.bfloat16))
    assert ours.dtype == torch.bfloat16 and ours.shape == ref16.shape
    err = float(np.abs(ours.float().numpy() - ref16).max())
    assert 0 < limit < 0.1 and err <= limit, (err, limit)
    assert float(ours[:, 500:].float().abs().max()) == 0.0


# (D, mel bins, mel frames, t_pad, atol); t_pad == t_out leaves no spare row
# after an item's last frame, so its pitch grows by one row.
STEM_CASES = {
    "tier1": (128, 80, 1000, 512, 1e-5),
    "t_pad==t_out": (128, 80, 1024, 512, 1e-5),
    "d384_128mels_t_pad==t_out": (384, 128, 600, 300, 1e-5),
    "d1024": (1024, 80, 3000, 1536, 3e-5),
}


@pytest.mark.parametrize("case", list(STEM_CASES))
def test_stem_tap_model_matches_jax(case):
    D, C0, Tm, t_pad, atol = STEM_CASES[case]
    jp, enc = _wide_stem(D, C0, seed=D + Tm)
    jp = {**jp, "pos": jp["pos"][:Tm // 2]}  # the port's encoder keeps all 1500 rows
    mel = np.random.default_rng(Tm).standard_normal((2, C0, Tm)).astype(np.float32)
    ref = np.asarray(_xla_stem(jp, jnp.asarray(mel), t_pad, "float32"))
    ours = stem_tap_model(enc, torch.from_numpy(mel), t_pad, torch.float32)
    assert ours.shape == ref.shape == (2, t_pad, D)
    np.testing.assert_allclose(ours.numpy(), ref, atol=atol, rtol=0)
    assert not ours[:, Tm // 2:].any()  # padding rows exactly 0


@pytest.mark.parametrize("fault", ["conv1", "conv2"])
def test_stem_tap_model_catches_a_shifted_tap(tier1, fault):
    jp, enc, mel = tier1
    ref = np.asarray(_xla_stem(jp, jnp.asarray(mel), T_PAD, "float32"))
    bad = stem_tap_model(enc, torch.from_numpy(mel), T_PAD, torch.float32, fault=fault)
    assert float(np.abs(bad.numpy() - ref).max()) > 100 * 1e-5


def test_stem_pitch_leaves_a_row_for_each_item():
    assert conv_stem.stem_pitch(1000, 512) == 512
    assert conv_stem.stem_pitch(3000, 1536) == 1536
    assert conv_stem.stem_pitch(1024, 512) == 513  # t_pad == t_out
    for Tm, t_pad in ((1000, 512), (1024, 512), (600, 300), (3000, 1500)):
        P = conv_stem.stem_pitch(Tm, t_pad)
        assert P >= t_pad and Tm + 2 <= 2 * P


@pytest.mark.parametrize("seconds,n_mels", [(1.1, 80), (30.0, 80), (16001 / 16000, 80),
                                            (3.0, 128)])
def test_mel_tap_model_matches_jax_kernel(seconds, n_mels):
    pcm = np.random.default_rng(3).standard_normal(int(round(16000 * seconds))).astype(
        np.float32) * 0.3
    ref = np.asarray(jax_fused_mel(jnp.asarray(pcm), n_mels=n_mels))
    padded = melfront.reflect_pad(torch.from_numpy(pcm)[None])
    ours = melfront.clamp_and_scale(mel_tap_model(padded, n_mels))[0]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=0)


def test_mel_tap_model_catches_a_shifted_tap():
    pcm = np.random.default_rng(3).standard_normal(17600).astype(np.float32) * 0.3
    ref = np.asarray(jax_fused_mel(jnp.asarray(pcm)))
    padded = melfront.reflect_pad(torch.from_numpy(pcm)[None])
    bad = melfront.clamp_and_scale(mel_tap_model(padded, 80, fault=True))[0]
    assert float(np.abs(bad.numpy() - ref).max()) > 100 * 2e-4


def test_mel_frame_rows():
    """F kept frames and R = F + 2 hop rows an item: frame f's last row f +
    2 lies in its item, and R hop rows cover every kept frame's samples."""
    for n in (17600, 16001, 480000):
        L = n + 400
        F, R = melfront.frame_rows(L)
        assert F == (L - 400) // 160 and R == F + 2
        assert 160 * (F - 1) + 400 <= 160 * R


def test_mel_gemm_tables_fold_the_window_and_interleave_bins():
    basis, melfb = melfront.gemm_tables(80, torch.device("cpu"))
    window, cos_sin, fb = melfront._tables(80)
    b = (basis[0] + basis[1]).double()  # hi + lo
    assert basis.shape == (2, 512, 480) and melfb.shape == (2, 128, 256)
    want = torch.from_numpy(window.astype(np.float64) * cos_sin.astype(np.float64))
    torch.testing.assert_close(b[0:402:2, :400], want[:201], rtol=0, atol=1e-6)
    torch.testing.assert_close(b[1:402:2, :400], want[201:], rtol=0, atol=1e-6)
    assert not b[402:].any() and not b[:, 400:].any()
    torch.testing.assert_close((melfb[0] + melfb[1])[:80, :201], torch.from_numpy(fb),
                               rtol=2.0 ** -22, atol=0)  # hi + lo: w within 2^-22 |w|
    assert not melfb[:, 80:].any() and not melfb[:, :, 201:].any()
    assert melfront.gemm_tables(80, torch.device("cpu"))[0] is basis


def _encoder(D=128, n_mels=80):
    return _wide_stem(D, n_mels, seed=5)[1]


def test_stem_pack_layout():
    """conv1 and conv2 tap-major (column j c_pad + c is w[:, c, j]), conv1's
    channels zero-padded to the k-slice (96 in f32, 128 in bf16), f32 as
    TF32 hi/lo slabs, bf16 one slab of the weights cast once."""
    enc = _encoder()
    p32 = conv_stem.stem_pack(enc, torch.float32)
    p16 = conv_stem.stem_pack(enc, torch.bfloat16)
    assert (p32["c_pad"], p16["c_pad"]) == (96, 128)
    assert p32["w1"].shape == (2, 128, 288) and p16["w1"].shape == (1, 128, 384)
    assert p32["w2"].shape == (2, 128, 384) and p16["w2"].shape == (1, 128, 384)
    w1, w2 = enc.conv1.weight, enc.conv2.weight
    for j in range(3):
        torch.testing.assert_close(p32["w1"].sum(0)[:, 96 * j:96 * j + 80], w1[:, :, j],
                                   rtol=0, atol=1e-6)
        assert not p32["w1"][:, :, 96 * j + 80:96 * (j + 1)].any()
        assert torch.equal(p16["w1"][0, :, 128 * j:128 * j + 80], w1[:, :, j].bfloat16())
        assert torch.equal(p16["w2"][0, :, 128 * j:128 * (j + 1)], w2[:, :, j].bfloat16())
    assert p16["pos"].dtype == p16["b1"].dtype == torch.bfloat16


def test_stem_pack_built_once_per_module_and_dtype():
    enc = _encoder()
    p32 = conv_stem.stem_pack(enc, torch.float32)
    assert conv_stem.stem_pack(enc, torch.float32) is p32
    p16 = conv_stem.stem_pack(enc, torch.bfloat16)
    assert p16 is not p32 and conv_stem.stem_pack(enc, torch.bfloat16) is p16


def test_stem_pack_rebuilt_for_a_copy_a_reload_and_a_recast():
    enc = _encoder()
    pack = conv_stem.stem_pack(enc, torch.float32)
    twin = copy.deepcopy(enc)
    with torch.no_grad():
        twin.conv1.weight.mul_(2)
    other = conv_stem.stem_pack(twin, torch.float32)
    assert other is not pack
    torch.testing.assert_close(other["w1"].sum(0)[:, :80], 2 * enc.conv1.weight[:, :, 0],
                               rtol=0, atol=1e-6)
    enc.load_state_dict({k: v * 3 if k == "conv1.weight" else v
                         for k, v in enc.state_dict().items()}, assign=True)
    again = conv_stem.stem_pack(enc, torch.float32)
    assert again is not pack
    torch.testing.assert_close(again["w1"].sum(0)[:, :80], enc.conv1.weight[:, :, 0],
                               rtol=0, atol=1e-6)
    enc.to(torch.bfloat16)
    recast = conv_stem.stem_pack(enc, torch.float32)
    assert recast is not again
    assert torch.equal(recast["w1"].sum(0)[:, :80], enc.conv1.weight[:, :, 0].float())
