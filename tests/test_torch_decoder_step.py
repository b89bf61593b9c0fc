"""Port fused decoder-layer step (qasr_ijcnlp_tpu_torch/ops/decoder_step.py,
K10's plain version) vs the JAX package's fused step (its Pallas kernel in
interpret mode) and its unfused step.

On the JAX test's own geometry (tests/test_decoder_step_kernel.py: D 384,
6 heads, 2 decoder layers, 64 audio positions, vocab 256, B 8, a 3-token
prompt, 5 steps) and with its parity contract: max |logit delta| <= 5e-4
in f32 and 3e-2 in bf16 per step, and the argmax agrees wherever the top-2
gap exceeds twice that.  The greedy loop with the flag on must give the
unfused loop's tokens and the JAX fused loop's at f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.decode import filters as jfilters
from qasr_ijcnlp_tpu.decode import loop as jloop
from qasr_ijcnlp_tpu.models import ModelDimensions
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.dims import dims_for as jdims_for
from qasr_ijcnlp_tpu.ops import decoder_step as jstep
from qasr_ijcnlp_tpu_torch.decode import filters as tfilters
from qasr_ijcnlp_tpu_torch.decode import loop as tloop
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_params
from qasr_ijcnlp_tpu_torch.models.dims import dims_for as tdims_for
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.ops import decoder_step

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=64, n_audio_state=384, n_audio_head=6, n_audio_layer=1,
    n_vocab=256, n_text_ctx=64, n_text_state=384, n_text_head=6, n_text_layer=2,
)
B = 8
PROMPT = 3
TOL = {"float32": 5e-4, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), DIMS))
    port = WhisperModel.from_state_dict(from_jax_params(params, DIMS), DIMS, "cpu")
    return jax.tree.map(jnp.asarray, params), port


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    decoder_step.set_fused_decoder_step(None)
    jstep.set_fused_decoder_step(None)


def _inputs():
    rng = np.random.default_rng(5)
    feats = (rng.standard_normal((B, DIMS.n_audio_ctx, DIMS.n_text_state)) * 0.1).astype(
        np.float32)
    prompt = rng.integers(0, DIMS.n_vocab, (B, PROMPT))
    steps = np.random.default_rng(9).integers(0, DIMS.n_vocab, (5, B, 1))
    return feats, prompt, steps


def _assert_parity(ref, ours, atol):
    """tests/test_decoder_step_kernel.py ``_assert_parity``."""
    for step, (lu, lf) in enumerate(zip(ref, ours)):
        delta = np.max(np.abs(lu - lf))
        assert delta <= atol, f"step {step}: max |logit delta| {delta} > {atol}"
        top2 = np.sort(lu, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        unstable = (lu.argmax(-1) != lf.argmax(-1)) & (gap > 2 * atol)
        assert not unstable.any(), f"step {step}: argmax flipped on separated rows"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_step_matches_jax(models, dtype, monkeypatch):
    """Prompt on the unfused step, then five fused steps: logits against
    JAX's fused kernel and JAX's unfused step, and one plain layer step per
    layer per token (on the CPU the wrapper runs its plain version)."""
    params, port = models
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    feats, prompt, steps = _inputs()

    jc = jmodel.init_kv_cache(DIMS, B, jdt)
    jc = jmodel.precompute_cross_kv(params["decoder"], jnp.asarray(feats, jdt), jc,
                                    n_head=DIMS.n_text_head)
    _, jc = jmodel.decoder_step(params["decoder"], jnp.asarray(prompt), jc, DIMS, jdt)
    jf = jstep.to_fused_cache(jc, DIMS)

    dec = port.decoder_for(tdt)
    tc = tmodel.init_kv_cache(DIMS, B, tdt, "cpu")
    tc = tmodel.precompute_cross_kv(dec, torch.from_numpy(feats), tc)
    _, tc = tmodel.decoder_step(dec, torch.from_numpy(prompt), tc, DIMS, tdt)
    assert decoder_step.fused_cache_applicable(tc, DIMS, B)
    tc = decoder_step.to_fused_cache(tc, DIMS)

    calls = []
    plain = decoder_step.fused_decoder_layer_step_plain
    monkeypatch.setattr(decoder_step, "fused_decoder_layer_step_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = decoder_step.launches
    unfused, fused, ours = [], [], []
    for tok in steps:
        lu, jc = jmodel.decoder_step(params["decoder"], jnp.asarray(tok), jc, DIMS, jdt)
        lf, jf = jstep.fused_decoder_step(params["decoder"], jnp.asarray(tok), jf, DIMS, jdt)
        lt, tc = decoder_step.fused_decoder_step(dec, torch.from_numpy(tok), tc, DIMS, tdt)
        assert lt.dtype == torch.float32 and lt.shape == (B, 1, DIMS.n_vocab)
        unfused.append(np.asarray(lu[:, 0], np.float32))
        fused.append(np.asarray(lf[:, 0], np.float32))
        ours.append(lt[:, 0].numpy())
    assert len(calls) == DIMS.n_text_layer * len(steps)
    assert decoder_step.launches == before  # CPU tensors never launch
    assert tc["idx"] == PROMPT + len(steps)
    _assert_parity(fused, ours, TOL[dtype])
    _assert_parity(unfused, ours, TOL[dtype])


def test_fused_step_matches_unfused_port_step(models):
    """The port's own unfused step, f32, same tokens: logits within 5e-4 and
    the self caches written alike."""
    _, port = models
    feats, prompt, steps = _inputs()
    dec = port.decoder_for(torch.float32)
    caches = []
    for _ in range(2):
        c = tmodel.init_kv_cache(DIMS, B, device="cpu", ctx=16)
        c = tmodel.precompute_cross_kv(dec, torch.from_numpy(feats), c)
        _, c = tmodel.decoder_step(dec, torch.from_numpy(prompt), c, DIMS)
        caches.append(c)
    cu, cf = caches[0], decoder_step.to_fused_cache(caches[1], DIMS)
    for tok in steps:
        lu, cu = tmodel.decoder_step(dec, torch.from_numpy(tok), cu, DIMS)
        lf, cf = decoder_step.fused_decoder_step(dec, torch.from_numpy(tok), cf, DIMS)
        np.testing.assert_allclose(lf.numpy(), lu.numpy(), atol=5e-4)
    for key in ("self_k", "self_v"):
        for a, b in zip(cu[key], cf[key]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _loop_configs(jax_side: bool):
    eot = DIMS.n_vocab - 1
    suppress = np.zeros(DIMS.n_vocab, np.uint8)
    suppress[eot] = 1  # every row decodes the full sample_len
    fmod, lmod = (jfilters, jloop) if jax_side else (tfilters, tloop)
    filters = fmod.FilterConfig(
        n_vocab=DIMS.n_vocab, sample_begin=PROMPT, eot=eot,
        timestamp_begin=DIMS.n_vocab, no_timestamps=None, suppress_blank=False,
        suppress_mask=bytes(suppress), blank_mask=None, apply_timestamp_rules=False,
        max_initial_timestamp_index=None,
    )
    return lmod.LoopConfig(
        dims=DIMS, filters=filters, sample_begin=PROMPT, sot_index=0, sample_len=6,
        eot=eot, timestamp_begin=DIMS.n_vocab, no_speech=None,
        compute_dtype="float32" if jax_side else torch.float32,
    )


def test_greedy_loop_fused_wiring(models, monkeypatch):
    """greedy_decode with the flag on takes the fused step (n_text_layer
    layer steps per token after the prompt) and gives the unfused loop's
    tokens and JAX's fused loop's, at f32."""
    params, port = models
    feats, prompt, _ = _inputs()
    dec = port.decoder_for(torch.float32)
    cfg = _loop_configs(jax_side=False)

    decoder_step.set_fused_decoder_step(False)
    buf_u, len_u, lp_u, _ = tloop.greedy_decode(
        dec, cfg, torch.from_numpy(feats), torch.from_numpy(prompt))
    calls = []
    plain = decoder_step.fused_decoder_layer_step_plain
    monkeypatch.setattr(decoder_step, "fused_decoder_layer_step_plain",
                        lambda *a: calls.append(1) or plain(*a))
    decoder_step.set_fused_decoder_step(True)
    buf_f, len_f, lp_f, _ = tloop.greedy_decode(
        dec, cfg, torch.from_numpy(feats), torch.from_numpy(prompt))
    assert len(calls) == DIMS.n_text_layer * (cfg.sample_len - 1)

    jstep.set_fused_decoder_step(True)
    jbuf, _, jlp, *_ = jloop.greedy_decode(
        params, _loop_configs(jax_side=True), jnp.asarray(feats), jnp.asarray(prompt),
        jax.random.PRNGKey(0))

    assert torch.equal(buf_u, buf_f) and len_u == len_f
    np.testing.assert_allclose(lp_f.numpy(), lp_u.numpy(), atol=1e-3)
    # (the JAX loop's final length counts its unrolled overshoot; the tokens
    # past the sampled ones are eot on both sides)
    np.testing.assert_array_equal(buf_f.numpy(), np.asarray(jbuf)[:, :buf_f.shape[1]])
    np.testing.assert_allclose(lp_f.numpy(), np.asarray(jlp), atol=1e-3)


def test_default_off():
    assert decoder_step.fused_step_enabled() is False
    decoder_step.set_fused_decoder_step(True)
    assert decoder_step.fused_step_enabled() is True
    decoder_step.set_fused_decoder_step(None)
    assert decoder_step.fused_step_enabled() is False


@pytest.mark.parametrize("name", ["tiny", "tiny.en", "base", "small", "medium",
                                  "large-v3", "turbo"])
def test_gates_match_jax(name):
    """fused_step_applicable and fused_cache_applicable equal the JAX
    package's for every family size and batch (caches at one layer and 8
    audio positions: the gates read only heads, width and batch), and an
    int8 cross cache disables the fused step on both sides."""
    small = dict(n_text_layer=1, n_audio_ctx=8)
    jd = dataclasses.replace(jdims_for(name), **small)
    td = dataclasses.replace(tdims_for(name), **small)
    H, D = td.n_text_head, td.n_text_state
    for batch in (1, 8, 12, 16):
        want = jstep.fused_step_applicable(jd.n_text_head, jd.n_text_state, batch)
        assert decoder_step.fused_step_applicable(H, D, batch) == want
        jc = jmodel.init_kv_cache(jd, batch, ctx=8)
        tc = tmodel.init_kv_cache(td, batch, device="cpu", ctx=8)
        assert not decoder_step.fused_cache_applicable(tc, td, batch)  # not filled yet
        filled = torch.zeros(batch, H, 8, D // H)
        tc = {**tc, "cross_k": [filled], "cross_v": [filled]}
        assert decoder_step.fused_cache_applicable(tc, td, batch) == \
            jstep.fused_cache_applicable(jc, jd, batch)
        j8 = jmodel.init_kv_cache(jd, batch, ctx=8, cross_int8=True)
        t8 = tmodel.init_kv_cache(td, batch, device="cpu", ctx=8, cross_int8=True)
        assert not jstep.fused_cache_applicable(j8, jd, batch)
        assert not decoder_step.fused_cache_applicable(t8, td, batch)
    assert not decoder_step.fused_step_applicable(6, 384, 8, groups=2)
