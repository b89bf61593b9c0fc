"""Port beam search and best-of (qasr_ijcnlp_tpu_torch/decode/, the grouped
cross attention of models/whisper.py) vs the JAX package.

Beam decode must be token-exact at f32 with avg_logprob within 1e-4 (the
greedy test's bound), also over the int8 cross cache (logprobs within 1e-3,
as the greedy int8 test).  Two weight sets of one geometry: the shared test
model, and the same model with its final LayerNorm bias set to a multiple
of eot's embedding, so that eot ranks near the top and the finished set
fills (partly at beam 5, fully at patience 0.5 and 2.0): that drives the
bounded finished set, its top-up from the live beams and the exit.  The JAX
beam loop compiles once per configuration (~6 s here), and both weight sets
share the compile.  Best-of at T > 0 cannot be token-exact (the two
packages' random numbers differ): the grouped loop is held at T = 0 against
JAX's, and sampling to its seeded generator and the ranking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions, DecodingTask as JTask
from qasr_ijcnlp_tpu.decode import decode as jdecode
from qasr_ijcnlp_tpu.decode import finalize_beam_group as j_finalize
from qasr_ijcnlp_tpu.decode import loop as jloop
from qasr_ijcnlp_tpu.decode import rank_group as j_rank
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.decode import (
    DecodingTask, _audio_features, finalize_beam_group, rank_group,
)
from qasr_ijcnlp_tpu_torch.decode import loop as tloop
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from tests.torch_port_common import DIMS, jax_params, torch_model

EOT = 50257
NO_TS = dict(language="en", without_timestamps=True, sample_len=12)
TS = dict(language="en", sample_len=10)  # timestamp rules on
# Final-LN bias = EOT_BIAS * eot's embedding: eot's logit rises by ~1, the
# size of the top logits of this random model.
EOT_BIAS = 22.0


def _pair(params):
    return JModel(jax.tree.map(jnp.asarray, params), DIMS), torch_model(params)


@pytest.fixture(scope="module")
def models():
    params = jax_params(0)
    eot_params = jax.tree.map(np.array, params)
    eot_params["decoder"]["ln"]["b"][:] = EOT_BIAS * eot_params["decoder"]["tok_emb"][EOT]
    return {"plain": _pair(params), "eot": _pair(eot_params)}


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(9).standard_normal((2, 80, 1000)).astype(np.float32)


def _check(ours, ref, atol=1e-4):
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
    assert [r.text for r in ours] == [r.text for r in ref]
    for a, b in zip(ours, ref):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=atol)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-5)


@pytest.mark.parametrize("opts", [
    dict(beam_size=5, **NO_TS), dict(beam_size=2, **NO_TS),
    dict(beam_size=5, **TS), dict(beam_size=2, **TS),
    dict(beam_size=5, patience=2.0, **NO_TS),
    dict(beam_size=2, patience=0.5, **TS),
], ids=["K5", "K2", "K5-timestamps", "K2-timestamps", "K5-patience2", "K2-patience0.5"])
def test_beam_decode_token_exact_vs_jax(models, mel, opts):
    """Both weight sets; on the eot one the finished set fills (K2 with
    patience 0.5: C = 1 < K, the exit and the top-up from live beams)."""
    for name in ("plain", "eot"):
        jm, tm = models[name]
        ref = jdecode(jm, jnp.asarray(mel), JOptions(fp16=False, **opts))
        ours = port.decode(tm, mel, port.DecodingOptions(fp16=False, **opts))
        _check(ours, ref)


def _finished_counts(tm, mel, opts):
    task = DecodingTask(tm, port.DecodingOptions(fp16=False, **opts))
    feats = _audio_features(tm, torch.from_numpy(mel), False)
    init = torch.tensor([task.initial_tokens] * mel.shape[0]).repeat_interleave(
        task.n_group, 0)
    K = opts["beam_size"]
    C = max(round(K * opts.get("patience", 1.0)), 1)
    return tloop.beam_decode(tm.module.decoder, task.loop_cfg, feats, init, K, C)[4], C


def test_eot_model_fills_the_finished_set(models, mel):
    """The eot weight set reaches the paths the parity test is there for."""
    tm = models["eot"][1]
    count, C = _finished_counts(tm, mel, dict(beam_size=2, patience=0.5, **TS))
    assert count.tolist() == [C, C]  # every set full: the loop exits early
    count, C = _finished_counts(tm, mel, dict(beam_size=5, **NO_TS))
    assert 0 < int(count.min()) and int(count.max()) < C  # topped up from live beams


def test_batched_beam_equals_per_item(models, mel):
    tm = models["eot"][1]
    opts = port.DecodingOptions(fp16=False, beam_size=5, **NO_TS)
    batched = port.decode(tm, mel, opts)
    for i in range(mel.shape[0]):
        single = port.decode(tm, mel[i], opts)
        assert single.tokens == batched[i].tokens
        assert single.avg_logprob == pytest.approx(batched[i].avg_logprob, abs=1e-5)


def test_beam_kv_int8_matches_jax(models, mel):
    """Beam over the int8 cross cache (K9's plain version at G = 2)."""
    for name in ("plain", "eot"):
        jm, tm = models[name]
        opts = dict(beam_size=2, kv_int8=True, **NO_TS)
        ref = jdecode(jm, jnp.asarray(mel), JOptions(fp16=False, **opts))
        ours = port.decode(tm, mel, port.DecodingOptions(fp16=False, **opts))
        _check(ours, ref, atol=1e-3)


def _cross_only_block(D, H):
    """A decoder block whose output is x + its cross attention on LN(x):
    the self attention's out-projection and the MLP's last layer are zero,
    the cross query and out-projections the identity."""
    bp = tmodel.ResidualAttentionBlock(D, H, cross_attention=True)
    with torch.no_grad():
        for lin in (bp.attn.out, bp.mlp[2]):
            lin.weight.zero_()
            lin.bias.zero_()
        for lin in (bp.cross_attn.query, bp.cross_attn.out):
            lin.weight.copy_(torch.eye(D))
            lin.bias.zero_()
    return bp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_cross_attention_matches_jax(dtype):
    """JAX ``_grouped_cross_attention`` vs ``decoder_layer``'s fp cross
    branch on a grouped, pre-scaled cache, G = 3 rows per audio; f32 to
    1e-6, bf16 (the same rounding points: logits in bf16, weights rounded
    before PV) to one bf16 step of the output.  x is small beside the
    attention, so the residual sum keeps the attention's error visible."""
    rng = np.random.default_rng(5)
    B, G, T, Ta, D, H = 2, 3, 2, 50, 128, 2
    x = 0.01 * rng.standard_normal((B * G, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Ta, D)).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tx, tk, tv = (torch.from_numpy(a).to(tdt) for a in (x, k, v))
    bp = _cross_only_block(D, H)
    self_kv = lambda: [torch.zeros(B * G, H, T, D // H, dtype=tdt)]
    cache = {"self_k": self_kv(), "self_v": self_kv(),
             "cross_k": [tmodel.scaled_heads(tk, H)], "cross_v": [tmodel._split_heads(tv, H)]}
    with torch.no_grad():
        ours = tmodel.decoder_layer(bp, tx, cache, 0, 0, torch.zeros(T, T), H, Ta)
        qn = tmodel.layer_norm(tx, bp.cross_attn_ln).float().numpy()
    assert ours.dtype == tdt and tuple(ours.shape) == (B * G, T, D)
    assert cache["cross_k"][0].shape[0] == B  # one cache row per audio
    ca = jmodel._grouped_cross_attention(*(jnp.asarray(a, jdt) for a in (qn, k, v)), H, G)
    ref = np.asarray((jnp.asarray(x, jdt) + ca).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
    else:
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_grouped_step_equals_repeated_cache(int8):
    """A decoder step over a grouped cache (one cross row per audio) equals
    the ungrouped step over the cache repeated G times; the grouped cache
    holds B rows, not B G."""
    dims = DIMS
    tm = torch_model(jax_params(1))
    dec = tm.module.decoder
    B, G = 2, 3
    xa = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, dims.n_audio_ctx, dims.n_audio_state)).astype(np.float32))
    toks = torch.randint(0, 50000, (B * G, 3), generator=torch.Generator().manual_seed(0))
    grouped = tmodel.precompute_cross_kv(
        dec, xa, tmodel.init_kv_cache(dims, B * G, device="cpu", cross_batch=B, ctx=16,
                                         cross_int8=int8))
    rep = tmodel.precompute_cross_kv(
        dec, xa.repeat_interleave(G, 0),
        tmodel.init_kv_cache(dims, B * G, device="cpu", ctx=16, cross_int8=int8))
    key = "cross_k8" if int8 else "cross_k"
    assert grouped[key][0].shape[0] == B and rep[key][0].shape[0] == B * G
    a, _ = tmodel.decoder_step(dec, toks, grouped, dims)
    b, _ = tmodel.decoder_step(dec, toks, rep, dims)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        tmodel.init_kv_cache(dims, 5, device="cpu", cross_batch=2)


def _transition_inputs(rng, B, K, V, W, cur, eot):
    """Random logits with planted ties: a row of duplicated values, two rows
    with equal top values at several ids, eot near the top in some rows."""
    logits = rng.standard_normal((B * K, V)).astype(np.float32) * 3
    logits[0, 100:110] = logits[0, 100:110].max() + 1.0  # ten-way tie at the top
    logits[1] = logits[0]  # two beams with identical rows
    logits[2, eot] = logits[2].max() + 0.5
    logits[3, [5, 7, eot]] = logits[3].max() + 0.25
    buf = np.full((B * K, W), eot, np.int64)
    buf[:, :cur] = rng.integers(0, 50000, (B * K, cur))
    return logits, buf


def test_beam_transition_matches_jax():
    """Three transitions on random logits, from the first step (beams 1..K-1
    at -inf, so their K + 1 candidates tie at -inf) with a finished set of
    C = 3 < K: the same parents, tokens, scores and finished sets."""
    jm, tm = _pair(jax_params(0))
    opts = NO_TS
    jcfg = JTask(jm, JOptions(fp16=False, beam_size=4, **opts)).loop_cfg
    tcfg = DecodingTask(tm, port.DecodingOptions(fp16=False, beam_size=4, **opts)).loop_cfg
    rng = np.random.default_rng(4)
    B, K, C, V, W = 2, 4, 3, DIMS.n_vocab, 20
    cur = tcfg.sample_begin
    logits, buf = _transition_inputs(rng, B, K, V, W, cur, EOT)
    sum_lp = np.tile(np.where(np.arange(K) == 0, 0.0, -np.inf), B).astype(np.float32)
    jstate = (jnp.asarray(buf, jnp.int32), jnp.asarray(sum_lp),
              jnp.full((B, C, W), EOT, jnp.int32), jnp.full((B, C), -jnp.inf),
              jnp.zeros((B,), jnp.int32), jnp.full((B * K,), -1, jnp.int32),
              jnp.full((B * K,), -1, jnp.int32), jnp.zeros((B * K,), jnp.int32))
    tstate = tloop.BeamState(
        torch.from_numpy(buf), torch.from_numpy(sum_lp),
        torch.full((B, C, W), EOT), torch.full((B, C), float("-inf")),
        torch.zeros(B, dtype=torch.long), torch.full((B * K,), -1),
        torch.full((B * K,), -1), torch.zeros(B * K, dtype=torch.long))
    for step in range(3):
        if step:
            logits, _ = _transition_inputs(rng, B, K, V, W, cur, EOT)
        out = jloop._beam_transition(
            jcfg, K, C, jnp.asarray(logits), jstate[0],
            jnp.full((B * K,), cur, jnp.int32), *jstate[1:])
        jstate = out[:8]
        tstate, src, tok = tloop.beam_transition(tcfg, K, C, torch.from_numpy(logits), cur,
                                                 tstate)
        np.testing.assert_array_equal(src.numpy(), np.asarray(out[8]))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(out[9]))
        for name, j, t in zip(("buf", "sum_logprobs", "fin_toks", "fin_scores", "fin_count",
                               "last", "prev", "max_ts"), jstate, tstate):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, err_msg=name)
        cur += 1
    assert int(tstate.fin_count.sum()) > 0  # the planted eots reached the set


@pytest.mark.parametrize("length_penalty", [None, 0.6])
def test_finalize_and_rank_match_jax(length_penalty):
    rng = np.random.default_rng(int(10 * (length_penalty or 0)))
    K, C, W = 4, 3, 12
    for fin_count in range(C + 1):
        fin_toks = rng.integers(0, 100, (C, W))
        fin_toks[:, rng.integers(2, W, C)] = EOT
        fin_scores = rng.standard_normal(C) * 5
        beams = rng.integers(0, 100, (K, W))
        beam_scores = rng.standard_normal(K) * 5
        beam_scores[1] = beam_scores[2]  # a tie in the top-up order
        args = (fin_toks, fin_scores, fin_count, beams, beam_scores, K, EOT)
        seqs, scores = finalize_beam_group(*args)
        jseqs, jscores = j_finalize(*args)
        assert [list(map(int, s)) for s in seqs] == [list(map(int, s)) for s in jseqs]
        assert scores == jscores
        sliced = [s[:int(rng.integers(1, W))] for s in seqs]
        assert rank_group(sliced, scores, length_penalty) == j_rank(
            sliced, scores, length_penalty)


def test_grouped_greedy_matches_jax_at_t0(models, mel):
    """The greedy loop over G = 3 rows per audio (best-of's loop) at T = 0,
    against JAX's grouped greedy loop on the same repeated initial tokens:
    the same tokens and sums, and no-speech per row."""
    jm, tm = models["eot"]
    G = 3
    jtask = JTask(jm, JOptions(fp16=False, **NO_TS))
    task = DecodingTask(tm, port.DecodingOptions(fp16=False, **NO_TS))
    init = np.repeat(np.tile(np.asarray(task.initial_tokens), (2, 1)), G, axis=0)
    feats = _audio_features(tm, torch.from_numpy(mel), False)
    jbuf, _, jsum, jns, _ = jloop.greedy_decode(
        jm.params, jtask.loop_cfg, jnp.asarray(feats.numpy()), jnp.asarray(init, jnp.int32),
        jax.random.PRNGKey(0), 0.0)
    buf, _, sum_lp, ns = tloop.greedy_decode(tm.module.decoder, task.loop_cfg, feats,
                                             torch.from_numpy(init))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_allclose(sum_lp.numpy(), np.asarray(jsum), atol=1e-4)
    np.testing.assert_allclose(ns.numpy(), np.asarray(jns), atol=1e-5)


def test_best_of_seeded_and_ranked(models, mel):
    """best_of = 3 at T = 0.5: one seed gives one result, and each result is
    ``rank_group``'s choice among its group's three samples."""
    tm = models["eot"][1]
    opts = port.DecodingOptions(fp16=False, best_of=3, temperature=0.5, **NO_TS)
    gen = lambda: torch.Generator().manual_seed(7)
    a = port.decode(tm, mel, opts, generator=gen())
    b = port.decode(tm, mel, opts, generator=gen())
    assert [r.tokens for r in a] == [r.tokens for r in b]
    task = DecodingTask(tm, opts)
    init = torch.tensor([task.initial_tokens] * 2).repeat_interleave(3, 0)
    feats = _audio_features(tm, torch.from_numpy(mel), False)
    groups, lps, _ = task._run_greedy(feats, init, gen())
    for r, group, lp in zip(a, groups, lps):
        sliced = [list(s[task.sample_begin:][:list(s[task.sample_begin:]).index(EOT)]
                       if EOT in s[task.sample_begin:] else s[task.sample_begin:])
                  for s in group]
        best = rank_group(sliced, lp, None)
        assert r.tokens == [int(t) for t in sliced[best]]
        assert r.avg_logprob == pytest.approx(lp[best] / (len(sliced[best]) + 1))
    assert len({tuple(map(int, s)) for g in groups for s in g}) > 2  # samples differ
