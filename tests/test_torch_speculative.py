"""Port speculative decode (qasr_ijcnlp_tpu_torch/decode/speculative.py) and
the two primitives it added, vs the JAX package.

``decoder_step(offsets=...)``: offsets all equal to the scalar position
give the scalar path's logits and cache; ragged offsets give each row's
own replay; a row whose slab would run past the cache end writes where
JAX's ``dynamic_update_slice`` clamps it to (the port's scatter clamps its
start alike), logits and caches within 1e-5 of JAX's.  ``apply_filters``
with a (B,) ``cur_len`` gives JAX's masks exactly.  Speculative decode
with a model draft (the target itself, so nearly every proposal is
accepted, and a weak draft of other weights) and with prompt lookup must
give JAX's tokens, avg_logprob within 1e-4 (greedy's bound) and exactly
JAX's count of verify rounds: the tokens alone would not show a broken
draft or rewind, only a slower one.  One JAX decode compile per option set
and draft kind.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.decode import Draft as JDraft, DecodingOptions as JOptions
from qasr_ijcnlp_tpu.decode import _get_task as j_get_task, decode as jdecode
from qasr_ijcnlp_tpu.decode.filters import apply_filters as j_apply_filters
from qasr_ijcnlp_tpu.decode.filters import build_config as j_build_config
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
from qasr_ijcnlp_tpu.tokenizer import get_tokenizer as j_get_tokenizer
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.decode import Draft, _get_task
from qasr_ijcnlp_tpu_torch.decode.filters import apply_filters, build_config
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer
from tests.torch_port_common import DIMS, jax_params, one_torch_thread, torch_model  # noqa: F401

NO_TS = dict(language="en", without_timestamps=True, sample_len=12)
TS = dict(language="en", sample_len=10)  # timestamp rules on


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX weak draft, port target, port weak draft)."""
    p0, p1 = jax_params(0), jax_params(1)
    j = lambda p: JModel(jax.tree.map(jnp.asarray, p), DIMS)  # noqa: E731
    return j(p0), j(p1), torch_model(p0), torch_model(p1)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(9).standard_normal((3, 80, 1000)).astype(np.float32)


def _caches(models, B, ctx=16, seed=0, with_jax=True):
    """Equal JAX (or None) and port caches over one random encoder output."""
    jm, _, tm, _ = models
    xa = np.random.default_rng(seed).standard_normal((B, 500, 128)).astype(np.float32)
    jc = None
    if with_jax:
        jc = jmodel.init_kv_cache(DIMS, B, ctx=ctx)
        jc = jmodel.precompute_cross_kv(jm.params["decoder"], jnp.asarray(xa), jc)
    tc = tmodel.init_kv_cache(DIMS, B, device="cpu", ctx=ctx)
    tc = tmodel.precompute_cross_kv(tm.module.decoder, torch.from_numpy(xa), tc)
    return jc, tc


_j_step = jax.jit(jmodel.decoder_step, static_argnames=("dims",))


def _step(models, toks, jc, tc, offsets):
    jm, _, tm, _ = models
    jl, jc = _j_step(jm.params["decoder"], jnp.asarray(toks), jc, dims=DIMS,
                     offsets=None if offsets is None else jnp.asarray(offsets))
    tl, tc = tmodel.decoder_step(tm.module.decoder, torch.from_numpy(toks), tc, DIMS,
                                 offsets=None if offsets is None else torch.tensor(offsets))
    return np.asarray(jl), jc, tl.numpy(), tc


def _assert_caches(jc, tc):
    for l in range(DIMS.n_text_layer):
        for name in ("self_k", "self_v"):
            # JAX (B, T, D), the port (B, H, T, Dh)
            ours = tc[name][l].permute(0, 2, 1, 3).reshape(jc[name][l].shape)
            np.testing.assert_allclose(ours.numpy(), np.asarray(jc[name][l]), atol=1e-5)


def test_uniform_offsets_equal_scalar_path(models):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 1000, (3, 4))
    tok = rng.integers(0, 1000, (3, 1))
    _, _, tm, _ = models
    _, tc_o = _caches(models, 3, with_jax=False)
    _, tc_s = _caches(models, 3, with_jax=False)
    ls, tc_s = tmodel.decoder_step(tm.module.decoder, torch.from_numpy(prompt), tc_s, DIMS)
    lo, tc_o = tmodel.decoder_step(tm.module.decoder, torch.from_numpy(prompt), tc_o, DIMS,
                                   offsets=torch.zeros(3, dtype=torch.long))
    torch.testing.assert_close(lo, ls, rtol=0, atol=1e-5)
    assert tc_s["idx"] == 4 and tc_o["idx"] == 0  # offsets leave idx alone
    for l in range(DIMS.n_text_layer):
        torch.testing.assert_close(tc_o["self_k"][l], tc_s["self_k"][l], rtol=0, atol=1e-6)
    ls, _ = tmodel.decoder_step(tm.module.decoder, torch.from_numpy(tok), tc_s, DIMS)
    lo, _ = tmodel.decoder_step(tm.module.decoder, torch.from_numpy(tok), tc_o, DIMS,
                                offsets=torch.full((3,), 4))
    torch.testing.assert_close(lo, ls, rtol=0, atol=1e-5)


def test_ragged_offsets_equal_per_row_replay_and_jax(models):
    """Rows at their own positions, a stale tail past a row's offset (a
    rejected draft) invisible to its next query; the same as each row run
    alone, and as JAX's per-row path."""
    _, _, tm, _ = models
    rng = np.random.default_rng(1)
    lens = [2, 5, 3]
    slab1 = rng.integers(0, 1000, (3, 2))
    slab2 = rng.integers(0, 1000, (3, 3))
    q = rng.integers(0, 1000, (3, 1))
    jc, tc = _caches(models, 3, seed=1)
    for toks, off in ((slab1, [0, 0, 0]), (slab2, [2, 2, 2]), (q, lens)):
        jl, jc, tl, tc = _step(models, toks, jc, tc, off)
        np.testing.assert_allclose(tl, jl, atol=1e-5)
    _assert_caches(jc, tc)
    for b, n in enumerate(lens):
        _, one = _caches(models, 3, seed=1, with_jax=False)
        one = {k: ([t[b:b + 1] for t in v] if isinstance(v, list) else v)
               for k, v in one.items()}
        prefix = np.concatenate([slab1[b], slab2[b]])[:n][None]
        _, one = tmodel.decoder_step(tm.module.decoder, torch.from_numpy(prefix), one, DIMS)
        alone, _ = tmodel.decoder_step(tm.module.decoder, torch.from_numpy(q[b:b + 1]), one,
                                       DIMS)
        np.testing.assert_allclose(tl[b:b + 1], alone.numpy(), atol=1e-5)


def test_row_at_context_edge_is_clamped_as_jax(models):
    """A slab of 3 at offset 15 of a 16-position cache (and one at 14)
    writes from 13, as ``dynamic_update_slice`` clamps its start; the
    positional embedding index clamps to n_text_ctx - 1."""
    rng = np.random.default_rng(2)
    jc, tc = _caches(models, 3, seed=2)
    _, jc, _, tc = _step(models, rng.integers(0, 1000, (3, 8)), jc, tc, [0, 0, 0])
    jl, jc, tl, tc = _step(models, rng.integers(0, 1000, (3, 3)), jc, tc, [15, 14, 8])
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    _assert_caches(jc, tc)
    # at the text context's edge: the embedding row is clamped to 47
    jc, tc = _caches(models, 2, ctx=48, seed=3)
    jl, jc, tl, tc = _step(models, rng.integers(0, 1000, (2, 2)), jc, tc, [47, 10])
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    _assert_caches(jc, tc)


@pytest.mark.parametrize("without_timestamps", [False, True], ids=["ts", "no_ts"])
def test_per_row_cur_len_filters_equal_jax(without_timestamps):
    """A (B,) cur_len at the first sampled position, one after, two after
    and later, with the filter state of each, gives JAX's masks."""
    sb, V = 4, 51865
    tok = get_tokenizer(True, num_languages=99, language="en")
    jtok = j_get_tokenizer(True, num_languages=99, language="en")
    args = (V, sb, [220, 50257, 50362], True, without_timestamps, 50)
    cfg, jcfg = build_config(tok, *args), j_build_config(jtok, *args)
    ts = tok.timestamp_begin
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, V)).astype(np.float32) * 3
    logits[:, ts:] += 4  # timestamps in contention
    cur = np.array([4, 5, 6, 7, 4, 9])
    last = np.array([-1, ts + 3, 220, ts + 9, -1, 1000])
    prev = np.array([-1, -1, ts + 3, ts + 5, -1, ts + 9])
    max_ts = np.array([0, ts + 3, ts + 3, ts + 9, 0, ts + 9])
    ours = apply_filters(cfg, torch.from_numpy(logits), torch.from_numpy(cur),
                         *(torch.from_numpy(a) for a in (last, prev, max_ts)))
    theirs = j_apply_filters(jcfg, jnp.asarray(logits), jnp.asarray(cur, jnp.int32),
                             *(jnp.asarray(a, jnp.int32) for a in (last, prev, max_ts)))
    np.testing.assert_array_equal(np.isinf(ours.numpy()), np.isinf(np.asarray(theirs)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)
    # a (B,) cur_len all at one length equals the host int path
    same = apply_filters(cfg, torch.from_numpy(logits), torch.full((6,), 5),
                         *(torch.from_numpy(a) for a in (last, prev, max_ts)))
    host = apply_filters(cfg, torch.from_numpy(logits), 5,
                         *(torch.from_numpy(a) for a in (last, prev, max_ts)))
    torch.testing.assert_close(same, host, rtol=0, atol=0)


@pytest.mark.parametrize("opts", [NO_TS, TS], ids=["without_timestamps", "with_timestamps"])
@pytest.mark.parametrize("kind", ["self", "weak", "lookup"])
def test_speculative_equals_jax_tokens_and_rounds(models, mel, kind, opts):
    jm, jd, tm, td = models
    jdraft, draft = {"self": (JDraft(jm, 3), Draft(tm, 3)),
                     "weak": (JDraft(jd, 3), Draft(td, 3)),
                     "lookup": (JDraft(None, 3), Draft(None, 3))}[kind]
    jopts = JOptions(fp16=False, draft=jdraft, **opts)
    topts = port.DecodingOptions(fp16=False, draft=draft, **opts)
    ref = jdecode(jm, jnp.asarray(mel), jopts)
    ours = port.decode(tm, mel, topts)
    plain = port.decode(tm, mel, port.DecodingOptions(fp16=False, **opts))
    assert [r.tokens for r in ours] == [r.tokens for r in ref] == [r.tokens for r in plain]
    assert [r.text for r in ours] == [r.text for r in ref]
    for a, b in zip(ours, ref):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-5)
    rounds = _get_task(tm, topts).last_spec_rounds
    assert rounds == j_get_task(jm, jopts).last_spec_rounds
    committed = max(len(r.tokens) for r in ours)
    assert rounds <= committed
    if kind == "self":  # every proposal accepted: gamma + 1 per round
        assert rounds < committed / 2


def test_speculative_kv_int8_target_equals_jax(models, mel):
    """The target on the int8 cross cache (K9's plain version over a
    slab of gamma + 1 query rows), a weak fp draft."""
    jm, jd, tm, td = models
    jopts = JOptions(fp16=False, kv_int8=True, draft=JDraft(jd, 3), **NO_TS)
    topts = port.DecodingOptions(fp16=False, kv_int8=True, draft=Draft(td, 3), **NO_TS)
    ref = jdecode(jm, jnp.asarray(mel), jopts)
    ours = port.decode(tm, mel, topts)
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
    for a, b in zip(ours, ref):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-3)
    assert _get_task(tm, topts).last_spec_rounds == j_get_task(jm, jopts).last_spec_rounds


def test_draft_refusals_and_fallbacks(models, mel):
    """An incompatible draft raises as JAX's does; at T > 0 the sampling
    loop runs (no rounds); with language detection a model draft is not
    run (its encoder would need the mel), as in JAX; gamma >= 1."""
    _, _, tm, _ = models
    bad = dataclasses.replace(DIMS, n_vocab=51864)
    dm = port.WhisperModel.from_state_dict(
        tmodel.init_params(torch.Generator().manual_seed(1), bad), bad, "cpu")
    with pytest.raises(ValueError, match="incompatible"):
        port.decode(tm, mel[:1], port.DecodingOptions(draft=Draft(dm), **NO_TS))
    with pytest.raises(ValueError, match="gamma"):
        Draft(tm, 0)
    opts = port.DecodingOptions(fp16=False, draft=Draft(tm, 2), temperature=0.7, **NO_TS)
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    res = port.decode(tm, mel[:1], opts, generator=g())
    plain = port.decode(tm, mel[:1], port.DecodingOptions(fp16=False, temperature=0.7,
                                                          **NO_TS), generator=g())
    assert res[0].temperature == 0.7 and res[0].tokens == plain[0].tokens
    assert _get_task(tm, opts).last_spec_rounds is None
    detect = port.DecodingOptions(fp16=False, draft=Draft(tm, 2), **{**NO_TS, "language": None})
    port.decode(tm, mel[:1], detect)
    assert _get_task(tm, detect).last_spec_rounds is None


def test_round_events_are_per_call_and_card_only(models, mel):
    """Round timing is an argument of each call (no process-wide switch):
    a decode given no list records nothing, and CUDA events are refused for
    a decode on the CPU before any round runs."""
    _, _, tm, _ = models
    task = _get_task(tm, port.DecodingOptions(fp16=False, draft=Draft(None, 3), **NO_TS))
    task.run(torch.from_numpy(mel[:1]))
    assert task.last_spec_rounds >= 1
    with pytest.raises(ValueError, match="CUDA events"):
        task.run(torch.from_numpy(mel[:1]), spec_events=[])
