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
from tests import torch_port_common as tpc

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


# ---------------------------------------------------------------------------
# K10's split of the attentions over (row, head, chunk) items and their merge
# (tests/torch_port_common.py ``decoder_layer_split``), at tiny's width
# ---------------------------------------------------------------------------

SPLIT_D, SPLIT_H, SPLIT_B = 384, 6, 8
# name: (idx, ctx, Ta, self plan, cross plan); None = the wrapper's plan
SPLIT_CASES = {
    "t1-idx0": (0, 16, 1500, None, None),
    "t37-Ta200": (36, 48, 200, None, None),  # one partial self chunk; Ta not a multiple of C
    "t67": (66, 80, 1500, None, None),
    "t448": (447, 448, 1500, None, None),    # a full self cache: four self chunks
    "empty-chunks": (36, 48, 200, (16, 4), (64, 5)),  # the last of each plan holds nothing
    "t448-peaked": (447, 448, 1500, None, None),  # chunk maxima units apart (PEAK below)
}
# Keys scaled by PEAK at self positions [128, 256) and audio positions [1280,
# 1408): those chunks' maxima stand several units above the others', so a
# merge that drops the e^(m_s - M) rescale is off by tenths in bf16 too.
PEAK, SELF_PEAK, CROSS_PEAK = 4.0, slice(128, 256), slice(1280, 1408)


def test_attention_split_rule():
    """The kernel's chunk C: the least multiple of 16 holding t_vis, up to
    32 KB of K rows (128 positions in f32, 256 in bf16); S = ceil(t_vis / C)
    chunks, none of them empty."""
    split = decoder_step.attention_split
    assert split(1) == (16, 1)
    assert split(37) == (48, 1)
    assert split(67) == (80, 1)
    assert split(128) == (128, 1)
    assert split(129) == (128, 2)
    assert split(448) == (128, 4)
    assert split(1500) == (128, 12)
    assert split(1500, 2) == (256, 6)
    assert split(448, 2) == (256, 2)
    assert split(200, 2) == (208, 1)
    for elem in (4, 2):
        for t_vis in range(1, 1537):
            C, S = split(t_vis, elem)
            assert C % 16 == 0 and 16 <= C <= decoder_step.CHUNK_BYTES // (64 * elem)
            assert C * S >= t_vis and C * (S - 1) < t_vis


def _split_inputs(case, dt):
    idx, ctx, Ta, _, _ = SPLIT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    bp = tpc.jax_decoder_block(3, SPLIT_D)
    packed, ln = decoder_step.pack_layer(tpc.port_decoder_block(bp, SPLIT_D, SPLIT_H), dt)
    shape = (SPLIT_B, SPLIT_H)
    t = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(dt)
    x = t(SPLIT_B, SPLIT_D)
    sk, sv = t(*shape, ctx, 64), t(*shape, ctx, 64)
    ck, cv = t(*shape, Ta, 64, scale=64 ** -0.25), t(*shape, Ta, 64)
    if case.endswith("peaked"):
        sk[:, :, SELF_PEAK] *= PEAK
        ck[:, :, CROSS_PEAK] *= PEAK
    return bp, (x, packed, ln, sk, sv, ck, cv)


def _run_layer(fn, inputs, idx, dt=None, **kw):
    """``fn`` on copies of the inputs (cast to ``dt``) -> (out, self k and v at idx)."""
    x, packed, ln, sk, sv, ck, cv = (z if dt is None or z.dtype == torch.float32 and z.dim() == 1
                                     else z.to(dt) for z in inputs)
    sk, sv = sk.clone(), sv.clone()
    out = fn(x, packed, ln, sk, sv, ck, cv, idx, SPLIT_H, **kw)
    return out, sk[:, :, idx], sv[:, :, idx]


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_plain(case, dtype):
    """The split-and-merge against ``fused_decoder_layer_step_plain``: the
    layer output and the fresh k/v at idx within 1e-6 in f32; in bf16
    within twice the plain bf16 version's own distance from the plain
    version in f32 on the same bf16-valued inputs."""
    dt = getattr(torch, dtype)
    idx, _, _, self_plan, cross_plan = SPLIT_CASES[case]
    if self_plan:
        assert (self_plan[1] - 1) * self_plan[0] >= idx + 1  # an empty self chunk
    _, inputs = _split_inputs(case, dt)
    split = _run_layer(tpc.decoder_layer_split, inputs, idx, self_plan=self_plan,
                       cross_plan=cross_plan)
    plain = _run_layer(decoder_step.fused_decoder_layer_step_plain, inputs, idx)
    plain32 = _run_layer(decoder_step.fused_decoder_layer_step_plain, inputs, idx,
                         dt=torch.float32)
    for s, p, p32 in zip(split, plain, plain32):
        assert s.dtype == dt and torch.isfinite(s.float()).all()
        err = float((s.float() - p.float()).abs().max())
        if dt == torch.float32:
            assert err <= 1e-6, err
        else:
            noise = float((p.float() - p32.float()).abs().max())
            assert 0 < noise and err <= 2 * noise, (err, noise)


def test_split_merge_matches_jax_fused_step():
    """The split-and-merge against the JAX package's fused layer step (its
    Pallas kernel in interpret mode, as tests/test_decoder_step_kernel.py
    runs it), f32, within that test's 5e-4: the layer output and the fresh
    k/v.  The JAX kernel takes T-on-lanes caches and an unscaled cross K."""
    case = "t37-Ta200"
    idx, ctx, Ta, _, _ = SPLIT_CASES[case]
    bp, inputs = _split_inputs(case, torch.float32)
    x, _, _, sk, sv, ck, cv = inputs
    out, kn, vn = _run_layer(tpc.decoder_layer_split, inputs, idx)

    def lanes(c, mult):  # (B, H, T, 64) -> (B, D, round_up(T, mult))
        z = c.permute(0, 1, 3, 2).reshape(SPLIT_B, SPLIT_D, c.shape[2]).numpy()
        pad = -z.shape[2] % mult
        return jnp.asarray(np.pad(z, ((0, 0), (0, 0), (0, pad))))

    cc = 256  # the JAX kernel's cross chunk at D 384
    jout, jkn, jvn = jstep.fused_decoder_layer_step(
        jnp.asarray(x.numpy()), jax.tree.map(jnp.asarray, bp), lanes(sk, 128), lanes(sv, 128),
        lanes(ck * 64 ** 0.25, cc), lanes(cv, cc), jnp.int32(idx), SPLIT_H, t_real_cross=Ta)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)
    np.testing.assert_allclose(kn.reshape(SPLIT_B, SPLIT_D).numpy(), np.asarray(jkn), atol=5e-4)
    np.testing.assert_allclose(vn.reshape(SPLIT_B, SPLIT_D).numpy(), np.asarray(jvn), atol=5e-4)


def test_stamps_instrument_the_phase_loop():
    """The phase-stamp diagnostic (``diagnostics.decoder_step_stamps``)
    stamps K10's entry and both sides of the grid barrier in each role's
    phase loop, and reads the per-phase, per-barrier and whole times off a
    launch's stamps."""
    import os

    from qasr_ijcnlp_tpu_torch import _kernels
    from qasr_ijcnlp_tpu_torch.diagnostics import decoder_step_stamps as stamps

    with open(os.path.join(_kernels.CSRC, "decoder_step.cu")) as f:
        src = f.read()
    out = stamps.instrument(src)
    assert out.count("STAMP(2 * step + 1)") == 2 and out.count("STAMP(0);") == 1
    assert "qasr_read_stamps" in out
    with pytest.raises(ValueError):
        stamps.instrument(src.replace("if (step < 7) grid.sync();", "grid.sync();"))
    # two blocks: entry at 0 / 100 ns, each phase 1,000 ns, each barrier 500
    st = np.zeros((2, stamps.SLOTS), np.uint64)
    st[:, 0] = (0, 100)
    for p in range(stamps.BARRIERS + 1):
        st[:, 2 * p + 1] = 1500 * p + 1000
        if p < stamps.BARRIERS:
            st[:, 2 * p + 2] = 1500 * p + 1500
    phases, bars, total = stamps.phase_times(st)
    assert phases == [1.0] * 8 and bars == [0.5] * 7 and total == 11.5
