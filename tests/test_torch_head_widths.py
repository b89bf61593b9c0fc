"""Encoder head geometries off the released family, on the port vs the JAX
package: the kernels each takes in the JAX dispatch, at narrow widths and
two layers.

* D 192, two heads of 96, n_audio_ctx 520: neither fused nor packable, so
  the JAX trunk runs the 4D kernel (K7) on an unpadded trunk; the port's
  trunk is padded to 640 and K7 masks keys >= 520.
* D 256, two heads of 128, n_audio_ctx 1000 (Tp 1024): the fused block with
  K4 at head width 128 (the heads would pack too; the fused block comes
  first).
* D 128, four heads of 32, n_audio_ctx 520: unfused, packed (K8) at head
  width 32.

The JAX side runs with its kernels on (``set_flash_attention(True)``, Pallas
in interpret mode); on the CPU the port runs its kernels' plain versions.
Tolerances as tests/test_torch_family.py: encoder output atol 5e-5, rtol
1e-4; greedy tokens exact at f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions, decode as jdecode
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
from qasr_ijcnlp_tpu.ops import flash as jflash
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_params
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
from qasr_ijcnlp_tpu_torch.ops import MAX_HEAD_WIDTH, flash, kernel_head_width

EOT = 50257
GREEDY = dict(language="en", without_timestamps=True, sample_len=12,
              suppress_tokens=[EOT], suppress_blank=False, fp16=False)

# name -> (dims, fused block, packed attention)
GEOMETRIES = {
    "k7_dh96": (ModelDimensions(80, 520, 192, 2, 2, 51865, 16, 192, 2, 2), False, False),
    "k4_dh128": (ModelDimensions(80, 1000, 256, 2, 2, 51865, 16, 256, 2, 2), True, True),
    "k8_dh32": (ModelDimensions(80, 520, 128, 4, 2, 51865, 16, 128, 4, 2), False, True),
}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(name, dims, fused, packed, JAX params, port model, JAX encoder
    output, port encoder output) of one geometry."""
    dims, fused, packed = GEOMETRIES[name]
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(5), dims))
    tm = port.WhisperModel.from_state_dict(from_jax_params(params, dims), dims, "cpu")
    mel = np.random.default_rng(6).standard_normal(
        (2, 80, 2 * dims.n_audio_ctx)).astype(np.float32)
    jmodel.set_flash_attention(True)
    try:
        ref = np.asarray(jmodel.encoder_apply(params["encoder"], jnp.asarray(mel), dims))
    finally:
        jmodel.set_flash_attention(None)
    ours = tmodel.encoder_apply(tm.module.encoder, torch.from_numpy(mel), dims)
    return name, dims, fused, packed, params, tm, ref, ours


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def geometry(request):
    return _setup(request.param)


def test_dispatch_is_the_jax_packages(geometry):
    _, dims, fused, packed, *_ = geometry
    D, H = dims.n_audio_state, dims.n_audio_head
    assert tmodel._trunk_uses_fused_blocks(dims) == fused
    jmodel.set_flash_attention(True)
    try:
        assert jmodel._trunk_uses_fused_blocks(dims, jnp.dtype(jnp.float32),
                                               t_pad=(dims.n_audio_ctx + 127) // 128 * 128) \
            == fused
    finally:
        jmodel.set_flash_attention(None)
    assert flash.packed_applicable(H, D) == jflash.packed_applicable(H, D) == packed
    assert kernel_head_width("test", D, H) == D // H <= MAX_HEAD_WIDTH


def test_encoder_matches_jax(geometry):
    _, dims, _, _, _, _, ref, ours = geometry
    assert tuple(ours.shape) == ref.shape == (2, dims.n_audio_ctx, dims.n_audio_state)
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5, rtol=1e-4)


def test_cpu_encoder_counts_no_launch(geometry):
    _, dims, _, _, _, tm, _, _ = geometry
    mel = torch.zeros(1, 80, 2 * dims.n_audio_ctx)
    before = (flash.launches, flash.launches_4d)
    tmodel.encoder_apply(tm.module.encoder, mel, dims)
    assert (flash.launches, flash.launches_4d) == before


def test_k7_geometry_greedy_tokens_match_jax():
    """Greedy decode from each side's own encoder output at the K7
    geometry (the decoder's 96-wide heads run plain on both sides)."""
    _, dims, _, _, params, tm, ref, ours = _setup("k7_dh96")
    jm = JModel(jax.tree.map(jnp.asarray, params), dims)
    want = jdecode(jm, jnp.asarray(ref), JOptions(**GREEDY))
    got = port.decode(tm, ours, port.DecodingOptions(**GREEDY))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == GREEDY["sample_len"] for r in got)


@pytest.mark.parametrize("n_head,d_model", [(1, 320), (3, 1000), (0, 64)])
def test_kernel_head_width_refuses_what_no_kernel_takes(n_head, d_model):
    with pytest.raises(ValueError):
        kernel_head_width("test", d_model, n_head)
