"""Port conv stem (qasr_ijcnlp_tpu_torch/ops/conv_stem.py) vs the JAX stem.

On the CPU the wrapper runs its plain version; the JAX side runs the Pallas
stem kernel in interpret mode and its XLA oracle.  Tolerance: f32 atol 1e-5,
the bound of tests/test_conv_stem.py (3e-5 for its chunked K3 kernel at
D > 512); padding rows exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.models.dims import dims_for as jax_dims_for
from qasr_ijcnlp_tpu.ops.conv_stem import (
    _xla_stem,
    fused_conv_stem as jax_stem,
    stem_applicable as jax_stem_applicable,
)
from qasr_ijcnlp_tpu_torch.models.dims import dims_for
from qasr_ijcnlp_tpu_torch.models.whisper import AudioEncoder
from qasr_ijcnlp_tpu_torch.ops import conv_stem
from tests.torch_port_common import DIMS, T_PAD, jax_params, torch_model


@pytest.fixture(scope="module")
def models():
    params = jax_params(0)
    return params, torch_model(params)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(1).standard_normal((2, 80, 1000)).astype(np.float32)


def _jax_stem_params(params):
    return jax.tree.map(
        jnp.asarray, {k: params["encoder"][k] for k in ("conv1", "conv2", "pos")}
    )


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_stem_matches_jax(models, mel, oracle):
    params, m = models
    jp = _jax_stem_params(params)
    fn = jax_stem if oracle == "pallas_interpret" else _xla_stem
    ref = np.asarray(fn(jp, jnp.asarray(mel), T_PAD, "float32"))
    ours = conv_stem.fused_conv_stem(m.module.encoder, torch.from_numpy(mel), T_PAD)
    assert ours.shape == (2, T_PAD, DIMS.n_audio_state)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_stem_padding_rows_exactly_zero(models, mel):
    _, m = models
    ours = conv_stem.fused_conv_stem(m.module.encoder, torch.from_numpy(mel), T_PAD)
    assert float(ours[:, DIMS.n_audio_ctx:].abs().max()) == 0.0


def test_stem_cpu_uses_plain_version_without_counting(models, mel):
    _, m = models
    before = conv_stem.launches
    conv_stem.fused_conv_stem(m.module.encoder, torch.from_numpy(mel[:1]), T_PAD)
    assert conv_stem.launches == before


def _wide_stem(d_model, n_mels, seed):
    """Seeded stem weights at a full Whisper width: the JAX tree and the
    port's AudioEncoder holding the same values."""
    rng = np.random.default_rng(seed)

    def conv(c_out, c_in):
        bound = 1.0 / np.sqrt(3 * c_in)
        return {"w": rng.uniform(-bound, bound, (c_out, c_in, 3)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (c_out,)).astype(np.float32)}

    jp = {"conv1": conv(d_model, n_mels), "conv2": conv(d_model, d_model),
          "pos": (rng.standard_normal((1500, d_model)) * 0.02).astype(np.float32)}
    enc = AudioEncoder(n_mels, 1500, d_model, d_model // 64, 0)
    enc.load_state_dict({
        "conv1.weight": torch.from_numpy(jp["conv1"]["w"]),
        "conv1.bias": torch.from_numpy(jp["conv1"]["b"]),
        "conv2.weight": torch.from_numpy(jp["conv2"]["w"]),
        "conv2.bias": torch.from_numpy(jp["conv2"]["b"]),
        "positional_embedding": torch.from_numpy(jp["pos"]),
        "ln_post.weight": torch.ones(d_model), "ln_post.bias": torch.zeros(d_model),
    })
    return jax.tree.map(jnp.asarray, jp), enc.requires_grad_(False)


@pytest.mark.parametrize("d_model,n_mels", [(768, 80), (1024, 80), (1024, 128)])
def test_wide_stem_matches_jax_chunked_kernel(d_model, n_mels):
    """K3's range (512 < D <= 1024) on a full 30-s mel, 80 and 128 bins,
    against the JAX time-chunked kernel: conv2's zero left-padding row and
    the chunk seams must come out as in one pass."""
    jp, enc = _wide_stem(d_model, n_mels, seed=d_model + n_mels)
    mel = np.random.default_rng(12).standard_normal((1, n_mels, 3000)).astype(np.float32)
    ref = np.asarray(jax_stem(jp, jnp.asarray(mel), 1536, "float32"))
    ours = conv_stem.fused_conv_stem(enc, torch.from_numpy(mel), 1536)
    assert ours.shape == (1, 1536, d_model)
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-5)
    assert float(ours[:, 1500:].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["tiny", "base", "small", "medium", "large-v3"])
def test_stem_applicable_matches_jax(name):
    """The reference runs its stem kernels (K2, K3) for every size but
    large-v3, which it leaves to XLA; the port runs its one stem kernel at
    every size (models/whisper.py ``encoder_apply``), which the wide-stem
    tests above hold against the JAX stem up to D = 1024 and
    tests/test_torch_family.py at D = 1280."""
    d = dims_for(name)
    assert d.to_dict() == jax_dims_for(name).to_dict()
    args = (d.n_mels, 2 * d.n_audio_ctx, d.n_audio_ctx, 1536, d.n_audio_state)
    assert jax_stem_applicable(*args) == (name != "large-v3")
