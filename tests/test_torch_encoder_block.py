"""Port encoder block (qasr_ijcnlp_tpu_torch/ops/encoder_block.py) vs JAX.

On the CPU the wrappers run their plain versions; the JAX side runs the
Pallas attention and finish kernels in interpret mode.  Both t_real < Tp
(padded keys masked) and t_real == Tp (mask-free branch).  Tolerance: f32
atol 2e-5, the bound of tests/test_encoder_block.py (3e-5 at D = 1024, the
bound it gives its widest F-tiled case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.models.dims import dims_for as jax_dims_for
from qasr_ijcnlp_tpu.ops import encoder_block as jeb
from qasr_ijcnlp_tpu.ops.encoder_block import (
    fused_attention_ln as jax_attn_ln,
    fused_encoder_block as jax_block,
)
from qasr_ijcnlp_tpu_torch.models.dims import dims_for
from qasr_ijcnlp_tpu_torch.ops import encoder_block
from tests.torch_port_common import (
    DIMS, T_PAD, jax_encoder_block, jax_layer, jax_params, port_block, torch_model,
)


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


@pytest.mark.parametrize("d_model,n_head,atol", [(768, 12, 2e-5), (1024, 16, 3e-5)])
def test_wide_block_matches_jax_ftiled(d_model, n_head, atol):
    """K6's range (D > 512): the JAX F-tiled finish streams the MLP weights
    and carries proj in fp32; the port's finish sums all of F at once."""
    bp = jax_encoder_block(d_model, d_model)
    x = np.random.default_rng(d_model).standard_normal((1, 512, d_model)).astype(np.float32)
    ref = np.asarray(jax_block(jnp.asarray(x), jax.tree.map(jnp.asarray, bp), n_head, 500))
    ours = encoder_block.fused_encoder_block(
        torch.from_numpy(x), port_block(bp, d_model, n_head), n_head, 500)
    np.testing.assert_allclose(ours.numpy(), ref, atol=atol)


@pytest.mark.parametrize("name", ["tiny", "base", "small", "medium", "large-v3"])
@pytest.mark.parametrize("t_pad", [512, 1000, 1536])
def test_block_gates_match_jax(name, t_pad):
    d = dims_for(name)
    assert d.to_dict() == jax_dims_for(name).to_dict()
    args = (d.n_audio_head, d.n_audio_state, t_pad)
    assert encoder_block.fused_block_applicable(*args) == jeb.fused_block_applicable(*args)


@pytest.mark.parametrize("n_head,d_model,mlp", [(3, 192, None), (4, 256, None),
                                               (16, 1024, 3000), (2, 128, 512),
                                               (1, 128, None), (20, 1280, 5000)])
def test_block_gates_match_jax_off_family(n_head, d_model, mlp):
    for t_pad in (512, 768):
        assert encoder_block.fused_block_applicable(n_head, d_model, t_pad, mlp) == \
            jeb.fused_block_applicable(n_head, d_model, t_pad, mlp)


@pytest.mark.parametrize("t_pad,t_real", [(512, 500), (1536, 1500)])
def test_k4_rounding_probe_is_the_jax_kernels_output(t_pad, t_real):
    """chip_smoke.py's K4 probe: the JAX attention kernel, whose softmax
    denominator sums the rounded p, gives exactly c in every head (the
    unrounded sum would give the probe's K8 output, a bf16 ulp away)."""
    from chip_smoke import k4_probe

    x, ln, attn, want = k4_probe("cpu", 128, 2, t_pad, t_real)
    f = lambda t: jnp.asarray(t.detach().numpy())
    lnp = {"g": f(ln.weight), "b": f(ln.bias)}
    ap = {"query": {"w": f(attn.query.weight.T), "b": f(attn.query.bias)},
          "key": {"w": f(attn.key.weight.T)},
          "value": {"w": f(attn.value.weight.T), "b": f(attn.value.bias)}}
    ref = jax_attn_ln(jnp.asarray(x.float().numpy(), jnp.bfloat16), lnp, ap, 2, t_real)
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)), want.float().numpy())
