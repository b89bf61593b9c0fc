"""The Whisper family on the port: encoder dispatch, and the medium and
large-v3 request paths at full width and shallow depth, vs the JAX package.

The JAX side runs with its kernels on (``set_flash_attention(True)``, Pallas
in interpret mode), so it takes the dispatch the port copies: medium runs
the chunked stem (K3) and the fused block with the F-tiled finish (K6);
large-v3 runs XLA's stem and the unfused block around the packed attention
kernel (K8).  On the CPU the port runs the plain versions of its kernels.
Tolerances: encoder output atol 5e-5, rtol 1e-4 (tests/test_ops.py's bound
for the encoder on its kernel path); greedy tokens exact at f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions, decode as jdecode
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.convert import to_torch_state_dict
from qasr_ijcnlp_tpu.models.dims import ModelDimensions, dims_for as jax_dims_for
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
from qasr_ijcnlp_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_params
from qasr_ijcnlp_tpu_torch.models.dims import dims_for
from qasr_ijcnlp_tpu_torch.ops import flash
from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer

FAMILY = ["tiny", "base", "small", "medium", "large-v3", "large-v3-turbo"]
EOT = 50257
GREEDY = dict(language="en", without_timestamps=True, sample_len=12,
              suppress_tokens=[EOT], suppress_blank=False, fp16=False)

# Full width, one layer each, 500 audio frames (padded to 512 inside).
GEOMETRIES = {
    "medium": ModelDimensions(80, 500, 1024, 16, 1, 51865, 48, 1024, 16, 1),
    "large-v3": ModelDimensions(128, 500, 1280, 20, 1, 51866, 48, 1280, 20, 1),
}


def _jax_encoder(params, mel, dims):
    jmodel.set_flash_attention(True)
    try:
        return np.asarray(jmodel.encoder_apply(params["encoder"], jnp.asarray(mel), dims))
    finally:
        jmodel.set_flash_attention(None)


@pytest.mark.parametrize("name", FAMILY)
def test_trunk_dispatch_matches_jax(name):
    d, jd = dims_for(name), jax_dims_for(name)
    assert d.to_dict() == jd.to_dict()
    jmodel.set_flash_attention(True)
    try:
        for dt in (jnp.float32, jnp.bfloat16):
            for t_pad in (None, 1024):
                assert tmodel._trunk_uses_fused_blocks(d, t_pad) == \
                    jmodel._trunk_uses_fused_blocks(jd, jnp.dtype(dt), t_pad)
    finally:
        jmodel.set_flash_attention(None)
    fused = tmodel._trunk_uses_fused_blocks(d)
    assert fused == (d.n_audio_state <= 1024)
    # every size the trunk runs unfused packs its heads for K8
    assert fused or flash.packed_applicable(d.n_audio_head, d.n_audio_state)


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def geometry(request):
    dims = GEOMETRIES[request.param]
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(1), dims))
    tm = port.WhisperModel.from_state_dict(from_jax_params(params, dims), dims, "cpu")
    mel = np.random.default_rng(2).standard_normal((2, dims.n_mels, 1000)).astype(np.float32)
    ref = _jax_encoder(params, mel, dims)
    ours = tmodel.encoder_apply(tm.module.encoder, torch.from_numpy(mel), dims)
    return request.param, dims, params, tm, ref, ours


def test_family_encoder_matches_jax(geometry):
    _, dims, _, _, ref, ours = geometry
    assert tuple(ours.shape) == ref.shape == (2, 500, dims.n_audio_state)
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5, rtol=1e-4)


def test_family_greedy_tokens_match_jax(geometry):
    """Greedy decode from each side's own encoder output: token-exact."""
    _, dims, params, tm, ref, ours = geometry
    jm = JModel(jax.tree.map(jnp.asarray, params), dims)
    want = jdecode(jm, jnp.asarray(ref), JOptions(**GREEDY))
    got = port.decode(tm, ours, port.DecodingOptions(**GREEDY))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert all(len(r.tokens) == GREEDY["sample_len"] for r in got)


def test_family_detect_language_matches_jax(geometry):
    """Language id over the model's languages: 99 for medium, 100 for
    large-v3 (vocab 51866 adds Cantonese)."""
    name, dims, params, tm, ref, ours = geometry
    assert tm.num_languages == jmodel.num_languages(dims) == \
        (100 if name == "large-v3" else 99)
    jm = JModel(jax.tree.map(jnp.asarray, params), dims)
    ref_tok, ref_probs = jm.detect_language(jnp.asarray(ref))
    tok, probs = tm.detect_language(ours)
    np.testing.assert_array_equal(tok, np.asarray(ref_tok))
    for a, b in zip(probs, ref_probs):
        assert list(a) == list(b) and len(a) == tm.num_languages
        np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a], atol=1e-5)


def test_from_jax_params_family_shapes(geometry):
    """The 128-bin conv1 and the 51866-row embedding of large-v3 (80 and
    51865 for medium) cross over unchanged."""
    _, dims, params, _, _, _ = geometry
    ours = from_jax_params(params, dims)
    ref = to_torch_state_dict(params, dims)
    assert set(ours) == set(ref)
    D = dims.n_audio_state
    assert tuple(ours["encoder.conv1.weight"].shape) == (D, dims.n_mels, 3)
    assert tuple(ours["decoder.token_embedding.weight"].shape) == (dims.n_vocab, D)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_large_v3_token_table_matches_jax():
    ours = get_tokenizer(True, num_languages=100, language="yue")
    ref = jax_get_tokenizer(True, num_languages=100, language="yue")
    assert len(ours.all_language_tokens) == 100
    assert ours.all_language_tokens == tuple(ref.all_language_tokens)
    assert ours.all_language_codes == tuple(ref.all_language_codes)
    assert ours.sot_sequence == tuple(ref.sot_sequence)
    for name in ("eot", "sot", "transcribe", "translate", "no_timestamps",
                 "timestamp_begin", "no_speech"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.timestamp_begin + 1501 == 51866


def test_unpackable_heads_run_plain_on_cpu():
    """Three 64-wide heads neither fuse nor pack: the reference runs its 4D
    kernel (K7); the port runs K7's plain version on the CPU (and the
    kernel on the card).  n_audio_ctx 520 gives a 640-row trunk input."""
    dims = ModelDimensions(80, 520, 192, 3, 1, 51865, 16, 192, 3, 1)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(3), dims))
    tm = port.WhisperModel.from_state_dict(from_jax_params(params, dims), dims, "cpu")
    assert not tmodel._trunk_uses_fused_blocks(dims)
    assert not flash.packed_applicable(3, 192)
    mel = np.random.default_rng(4).standard_normal((1, 80, 1040)).astype(np.float32)
    ref = _jax_encoder(params, mel, dims)
    before = (flash.launches, flash.launches_4d)
    ours = tmodel.encoder_apply(tm.module.encoder, torch.from_numpy(mel), dims)
    assert (flash.launches, flash.launches_4d) == before
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5, rtol=1e-4)
