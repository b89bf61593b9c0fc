"""Port encoder block (qasr_ijcnlp_tpu_torch/ops/encoder_block.py) vs JAX.

On the CPU the wrappers run their plain versions; the JAX side runs the
Pallas attention and finish kernels in interpret mode.  Both t_real < Tp
(padded keys masked) and t_real == Tp (mask-free branch).  Tolerance: f32
atol 2e-5, the bound of tests/test_encoder_block.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.ops.encoder_block import (
    fused_attention_ln as jax_attn_ln,
    fused_encoder_block as jax_block,
)
from qasr_ijcnlp_tpu_torch.ops import encoder_block
from tests.torch_port_common import DIMS, T_PAD, jax_layer, jax_params, torch_model


@pytest.fixture(scope="module")
def models():
    params = jax_params(3)
    return params, torch_model(params)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(2).standard_normal(
        (2, T_PAD, DIMS.n_audio_state)).astype(np.float32)


def _jax_block(params, i):
    return jax.tree.map(jnp.asarray, jax_layer(params["encoder"]["blocks"], i))


@pytest.mark.parametrize("t_real", [DIMS.n_audio_ctx, T_PAD])
def test_attention_ln_matches_jax(models, x, t_real):
    params, m = models
    bp = _jax_block(params, 0)
    ref = np.asarray(jax_attn_ln(jnp.asarray(x), bp["attn_ln"], bp["attn"],
                                 DIMS.n_audio_head, t_real))
    blk = m.module.encoder.blocks[0]
    ours = encoder_block.fused_attention_ln(
        torch.from_numpy(x), blk.attn_ln, blk.attn, DIMS.n_audio_head, t_real)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("t_real", [DIMS.n_audio_ctx, T_PAD])
@pytest.mark.parametrize("layer", [0, 1])
def test_block_matches_jax(models, x, t_real, layer):
    params, m = models
    ref = np.asarray(jax_block(jnp.asarray(x), _jax_block(params, layer),
                               DIMS.n_audio_head, t_real))
    ours = encoder_block.fused_encoder_block(
        torch.from_numpy(x), m.module.encoder.blocks[layer], DIMS.n_audio_head,
        t_real)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_padded_keys_get_no_weight(models, x):
    """Garbage in rows >= t_real must not change any output row."""
    _, m = models
    blk = m.module.encoder.blocks[0]
    xt = torch.from_numpy(x)
    noisy = xt.clone()
    noisy[:, DIMS.n_audio_ctx:] = 1e3
    a = encoder_block.fused_encoder_block(xt, blk, DIMS.n_audio_head, DIMS.n_audio_ctx)
    b = encoder_block.fused_encoder_block(noisy, blk, DIMS.n_audio_head, DIMS.n_audio_ctx)
    n = DIMS.n_audio_ctx
    np.testing.assert_allclose(a[:, :n].numpy(), b[:, :n].numpy(), atol=1e-6)


def test_cpu_path_does_not_count_launches(models, x):
    _, m = models
    before = (encoder_block.attn_launches, encoder_block.finish_launches)
    encoder_block.fused_encoder_block(torch.from_numpy(x[:1]),
                                      m.module.encoder.blocks[0], 2, 500)
    assert (encoder_block.attn_launches, encoder_block.finish_launches) == before
