"""Port conv stem (qasr_ijcnlp_tpu_torch/ops/conv_stem.py) vs the JAX stem.

On the CPU the wrapper runs its plain version; the JAX side runs the Pallas
stem kernel in interpret mode and its XLA oracle.  Tolerance: f32 atol 1e-5,
the bound of tests/test_conv_stem.py; padding rows exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.ops.conv_stem import _xla_stem, fused_conv_stem as jax_stem
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
