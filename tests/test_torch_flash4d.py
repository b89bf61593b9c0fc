"""Port 4D attention (qasr_ijcnlp_tpu_torch/ops/flash.py ``flash_attention``,
K7) vs JAX.

On the CPU the wrapper runs its plain version; the JAX side runs the Pallas
4D kernel (``flash_attention``) in interpret mode.  Shapes as in
tests/test_ops.py (one batch item, two heads, q and k scaled by 0.3) at the
head widths K7 serves on the port's paths (64 in odd counts, 96, 128), and
its cross shape.  Tolerance: f32 atol 2e-5, rtol 1e-4, the bound of
tests/test_ops.py for the same kernel; bf16 2^-7 as tests/test_torch_flash.py
(the plain version rounds the normalised weights, the kernel the
unnormalised ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.ops import flash as jflash
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.ops import flash


def _qkv(seed, shape_q, shape_k):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32) * 0.3
    k = rng.standard_normal(shape_k).astype(np.float32) * 0.3
    v = rng.standard_normal(shape_k).astype(np.float32)
    return q, k, v


def _both(q, k, v, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jflash.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    ours = flash.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))
    assert ours.dtype == dtype and tuple(ours.shape) == ref.shape
    return ours.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("dh", [64, 96, 128])
@pytest.mark.parametrize("T", [64, 200, 1500])
def test_plain_matches_jax_kernel(T, dh):
    ours, ref = _both(*_qkv(T + dh, (1, 2, T, dh), (1, 2, T, dh)))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)


def test_cross_shape_matches_jax_kernel():
    ours, ref = _both(*_qkv(5, (2, 2, 100, 64), (2, 2, 300, 64)))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)


def test_bf16_matches_jax_kernel():
    ours, ref = _both(*_qkv(6, (1, 3, 512, 96), (1, 3, 512, 96)), torch.bfloat16)
    np.testing.assert_allclose(ours, ref, atol=2.0 ** -7, rtol=0)


def test_masked_keys_equal_the_unpadded_attention():
    """The port's trunk is padded and K7 masks keys >= t_real; the JAX trunk
    is not padded.  The real rows of the two agree."""
    q, k, v = _qkv(7, (1, 2, 640, 96), (1, 2, 640, 96))
    k[:, :, 520:], v[:, :, 520:] = 1e3, 1e3
    t = lambda a: torch.from_numpy(a)
    padded = flash.flash_attention(t(q), t(k), t(v), t_real=520)
    _, ref = _both(q[:, :, :520], k[:, :, :520], v[:, :, :520])
    np.testing.assert_allclose(padded[:, :, :520].numpy(), ref, atol=2e-5, rtol=1e-4)


def test_attention_dispatch_runs_k7_plain_on_cpu():
    """Five 64-wide heads with 512 queries do not pack: ``attention`` takes
    the 4D path (its plain version on the CPU), which counts no launch and
    equals the masked plain attention."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 512, 320))
                         .astype(np.float32))
    assert not flash.packed_applicable(5, 320)
    before = (flash.launches, flash.launches_4d)
    got = tmodel.attention(x, x, x, 5, t_real=500)
    assert (flash.launches, flash.launches_4d) == before
    keep = torch.arange(512) < 500
    mask = torch.zeros(512).masked_fill(~keep, float("-inf"))
    want = tmodel._attend(tmodel.scaled_heads(x, 5), tmodel.scaled_heads(x, 5),
                          tmodel._split_heads(x, 5), mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_output_is_a_head_view_of_rows():
    """The plain version's output has the shape the card's has; the trunk
    merges the heads of either by ``_merge_heads``."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, (2, 3, 70, 32), (2, 3, 90, 32)))
    out = flash.flash_attention(q, k, v, t_real=80)
    assert tuple(out.shape) == (2, 3, 70, 32)
    assert tuple(tmodel._merge_heads(out).shape) == (2, 70, 96)
