"""Port packed attention (qasr_ijcnlp_tpu_torch/ops/flash.py, K8) vs JAX.

On the CPU the wrapper runs its plain version; the JAX side runs the Pallas
packed kernel in interpret mode.  Inputs as in tests/test_ops.py (q and k
scaled by 0.3, as the caller pre-scales them).  Tolerance: f32 atol 2e-5,
rtol 1e-4, the bound of tests/test_ops.py for the same kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.models.dims import dims_for as jax_dims_for
from qasr_ijcnlp_tpu.ops import flash as jflash
from qasr_ijcnlp_tpu_torch.models.dims import dims_for
from qasr_ijcnlp_tpu_torch.ops import flash

FAMILY = ["tiny", "base", "small", "medium", "large-v3", "large-v3-turbo"]


def _qkv(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, tq, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((1, tk, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((1, tk, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, n_head, t_real, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jflash.flash_attention_packed(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), n_head, t_real)
    ours = flash.flash_attention_packed(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), n_head, t_real)
    assert ours.dtype == dtype and tuple(ours.shape) == ref.shape
    return ours.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("t_real", [640, 600])
def test_packed_matches_jax_kernel(t_real):
    ours, ref = _both(*_qkv(0, 640, 640, 128), 2, t_real, torch.float32)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)


def test_packed_query_and_key_lengths_differ():
    """Tq != Tk (neither a tile multiple), keys >= t_real masked."""
    ours, ref = _both(*_qkv(1, 300, 640, 256), 4, 600, torch.float32)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)


def test_packed_bf16_matches_jax_kernel():
    """bf16: the plain version rounds the logits and the normalised weights
    to bf16 (the reference's XLA form), the kernel neither; with outputs
    below 1 in magnitude that stays within 2^-7 (two bf16 ulps at 0.5-1)."""
    ours, ref = _both(*_qkv(2, 640, 640, 128), 2, 600, torch.bfloat16)
    np.testing.assert_allclose(ours, ref, atol=2.0 ** -7, rtol=0)


def test_packed_padding_keys_get_no_weight():
    q, k, v = _qkv(3, 512, 512, 128)
    a = flash.flash_attention_packed(*map(torch.from_numpy, (q, k, v)), 2, 500)
    k[:, 500:], v[:, 500:] = 1e3, 1e3
    b = flash.flash_attention_packed(*map(torch.from_numpy, (q, k, v)), 2, 500)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", FAMILY)
def test_packed_applicable_matches_jax(name):
    d, jd = dims_for(name), jax_dims_for(name)
    assert d.to_dict() == jd.to_dict()
    assert flash.packed_applicable(d.n_audio_head, d.n_audio_state) == \
        jflash.packed_applicable(jd.n_audio_head, jd.n_audio_state)


@pytest.mark.parametrize("n_head,d_model", [(3, 192), (2, 256), (4, 128), (5, 320)])
def test_packed_applicable_matches_jax_off_family(n_head, d_model):
    assert flash.packed_applicable(n_head, d_model) == \
        jflash.packed_applicable(n_head, d_model)


def test_cpu_path_does_not_count_launches():
    before = flash.launches
    flash.flash_attention_packed(*map(torch.from_numpy, _qkv(4, 64, 64, 128)), 2, 60)
    assert flash.launches == before


@pytest.mark.parametrize("t_pad,t_real", [(512, 500), (1536, 1500)])
def test_k8_rounding_probe_is_the_jax_kernels_output(t_pad, t_real):
    """chip_smoke.py's K8 probe: the JAX packed kernel gives its expected
    bf16 output bit for bit, which is one bf16 ulp from the output of a
    denominator that sums the rounded p (K4's rule)."""
    from chip_smoke import k8_probe, probe_gaps

    q, k, v, want = k8_probe("cpu", 2, 128, t_pad, t_real)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ref = jflash.flash_attention_packed(j(q), j(k), j(v), 2, t_real)
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)), want.float().numpy())
    assert all(out != c for _, c, out in probe_gaps(t_real - 1))
