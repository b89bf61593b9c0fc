"""Port mel frontend (qasr_ijcnlp_tpu_torch/audio.py, ops/melfront.py) vs JAX.

On the CPU the wrapper runs its plain version; the JAX side runs the Pallas
mel kernel in interpret mode, or the batched XLA path.  Tolerance: atol 2e-4
(rtol 1e-4), the bound of tests/test_ops.py for the same op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import audio as jaudio
from qasr_ijcnlp_tpu.ops.melfront import fused_log_mel_spectrogram as jax_fused_mel
from qasr_ijcnlp_tpu_torch import audio
from qasr_ijcnlp_tpu_torch.ops import melfront


@pytest.mark.parametrize("seconds", [1.1, 30.0])
def test_fused_mel_matches_jax_kernel(seconds):
    pcm = np.random.default_rng(3).standard_normal(int(16000 * seconds)).astype(
        np.float32) * 0.3
    ref = np.asarray(jax_fused_mel(jnp.asarray(pcm)))
    ours = melfront.fused_log_mel_spectrogram(torch.from_numpy(pcm))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=1e-4)


def test_batched_mel_matches_jax_per_item_clamp():
    rng = np.random.default_rng(4)
    # very different loudness per item: each must clamp by its own max
    pcm = rng.standard_normal((2, 16000 * 4)).astype(np.float32)
    pcm[0] *= 0.5
    pcm[1] *= 1e-3
    ref = np.asarray(jaudio.log_mel_spectrogram(pcm))
    ours = audio.log_mel_spectrogram(pcm, device="cpu")
    assert tuple(ours.shape) == ref.shape == (2, 80, 400)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=1e-4)


def test_128_bin_mel_matches_jax():
    """large-v3's frontend: 128 mel bins through the same path."""
    pcm = np.random.default_rng(6).standard_normal((2, 16000 * 3)).astype(np.float32) * 0.3
    ref = np.asarray(jaudio.log_mel_spectrogram(pcm, n_mels=128))
    ours = audio.log_mel_spectrogram(pcm, n_mels=128, device="cpu")
    assert tuple(ours.shape) == ref.shape == (2, 128, 300)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=1e-4)


def test_int16_pcm_and_padding_match_jax():
    pcm = (np.random.default_rng(5).standard_normal(16000 * 2) * 3000).astype(np.int16)
    ref = np.asarray(jaudio.log_mel_spectrogram(pcm, padding=16000))
    ours = audio.log_mel_spectrogram(pcm, padding=16000, device="cpu")
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_filters_equal_jax(n_mels):
    np.testing.assert_array_equal(audio.mel_filters(n_mels), jaudio.mel_filters(n_mels))


def test_pad_or_trim_numpy_and_torch():
    a = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(audio.pad_or_trim(a, 12), jaudio.pad_or_trim(a, 12))
    np.testing.assert_array_equal(audio.pad_or_trim(a, 4), jaudio.pad_or_trim(a, 4))
    t = audio.pad_or_trim(torch.from_numpy(a).reshape(2, 5), 7)
    np.testing.assert_array_equal(t.numpy(), jaudio.pad_or_trim(a.reshape(2, 5), 7))
