"""The greedy loop's CUDA-graph form, run eagerly on the CPU.

On the card ``decode.loop.greedy_decode`` replays each token step as one
CUDA graph over buffers at fixed addresses (``_StaticLoop``), with the
decoder's position a 0-d device tensor.  A CPU cannot capture a graph, but
it runs the same buffers and the same step eagerly (``_loop="static"``), so
here: the 0-d position form of ``decoder_step`` against the host int, bit
for bit; the kept buffers against a fresh plain loop over a second batch
of other audio (a step that read the first batch's cross K/V, or a stale
self cache, would differ); the entry's reuse and renewal.  The graph's
replay against the plain loop: ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch import profiling
from qasr_ijcnlp_tpu_torch.decode import DecodingTask
from qasr_ijcnlp_tpu_torch.decode import loop as tloop
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=2, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=48, n_text_state=64, n_text_head=2, n_text_layer=2,
)
TS = dict(language="en", without_timestamps=False)
NO_TS = dict(language="en", without_timestamps=True)


@pytest.fixture(scope="module")
def model():
    sd = tmodel.init_params(torch.Generator().manual_seed(3), DIMS)
    return WhisperModel.from_state_dict(sd, DIMS, "cpu")


def _features(seed: int, B: int = 3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, DIMS.n_audio_ctx, DIMS.n_audio_state, generator=g) * 2


def _task(model, sample_len=10, **opts):
    return DecodingTask(model, port.DecodingOptions(fp16=False, sample_len=sample_len, **opts))


def _init(task, B):
    return torch.tensor([task.initial_tokens] * B, dtype=torch.long)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_position_equals_host_int(model, dtype):
    """``decoder_step`` with ``cache['idx']`` a 0-d tensor gives the host
    int's logits and self cache bit for bit: a 3-token prompt at 0, then
    one-token steps at 3..6 and a 2-token slab at 7."""
    dec = model.decoder_for(dtype)
    g = torch.Generator().manual_seed(5)
    xa = torch.randn(2, DIMS.n_audio_ctx, DIMS.n_audio_state, generator=g)
    slabs = [torch.randint(0, 50000, (2, n), generator=g) for n in (3, 1, 1, 1, 1, 2)]
    caches = [tmodel.precompute_cross_kv(
        dec, xa, tmodel.init_kv_cache(DIMS, 2, dtype, "cpu", ctx=16)) for _ in range(2)]
    host, dev = caches[0], caches[1]
    for toks in slabs:
        pos = host["idx"]
        a, host = tmodel.decoder_step(dec, toks, host, DIMS, dtype)
        b, dev = tmodel.decoder_step(dec, toks, {**dev, "idx": torch.tensor(pos)}, DIMS, dtype)
        assert torch.equal(a, b)
        assert int(dev["idx"]) == host["idx"]
        for x, y in zip(host["self_k"] + host["self_v"], dev["self_k"] + dev["self_v"]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("opts", [TS, NO_TS], ids=["timestamps", "no_timestamps"])
def test_static_buffers_decode_a_second_batch_as_a_fresh_loop(model, opts):
    """The kept buffers, every step run eagerly: batch A, then batch B of
    other audio, gives B's tokens, sums and no-speech probabilities bit for
    bit as a fresh plain loop over B, in the same buffers (no new entry)."""
    task = _task(model, **opts)
    dec, cfg = model.decoder_for(torch.float32), task.loop_cfg
    init = _init(task, 3)
    a, b = _features(11), _features(12)
    tloop.greedy_decode(dec, cfg, a, init, _loop="static")
    entry = tloop._STATIC[dec][cfg.compute_dtype]
    cross = [t.data_ptr() for t in entry.cache["cross_k"]]
    got = tloop.greedy_decode(dec, cfg, b, init, _loop="static")
    want = tloop.greedy_decode(dec, cfg, b, init, _loop="plain")
    first = tloop.greedy_decode(dec, cfg, a, init, _loop="plain")
    assert tloop._STATIC[dec][cfg.compute_dtype] is entry
    assert [t.data_ptr() for t in entry.cache["cross_k"]] == cross
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    # the two batches differ, so a step that read A's keys would show
    assert not torch.equal(first[2], want[2])


def test_static_buffers_bf16_and_an_early_exit(model):
    """In bf16, with a sample length past the text context (the loop stops
    at the context) and an unroll of 1, the kept buffers give the plain
    loop's values; the returned tensors are copies, not the buffers."""
    task = _task(model, sample_len=60, **NO_TS)
    dec = model.decoder_for(torch.bfloat16)
    cfg = task.loop_cfg._replace(compute_dtype=torch.bfloat16, unroll=1)
    init = _init(task, 2)
    got = tloop.greedy_decode(dec, cfg, _features(21, 2), init, _loop="static")
    want = tloop.greedy_decode(dec, cfg, _features(21, 2), init, _loop="plain")
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    entry = tloop._STATIC[dec][torch.bfloat16]
    assert got[0].data_ptr() != entry.state.buf.data_ptr()


def test_static_entry_renewed_when_its_key_changes(model):
    """A new batch size or sample length makes the entry anew (the old one
    dropped); the same key keeps it."""
    task = _task(model, **NO_TS)
    dec, cfg = model.decoder_for(torch.float32), task.loop_cfg
    tloop.greedy_decode(dec, cfg, _features(1, 2), _init(task, 2), _loop="static")
    e2 = tloop._STATIC[dec][cfg.compute_dtype]
    tloop.greedy_decode(dec, cfg, _features(2, 2), _init(task, 2), _loop="static")
    assert tloop._STATIC[dec][cfg.compute_dtype] is e2
    tloop.greedy_decode(dec, cfg, _features(1, 4), _init(task, 4), _loop="static")
    e4 = tloop._STATIC[dec][cfg.compute_dtype]
    assert e4 is not e2 and e4.state.buf.shape[0] == 4
    tloop.greedy_decode(dec, cfg._replace(sample_len=5), _features(1, 4), _init(task, 4),
                        _loop="static")
    assert tloop._STATIC[dec][cfg.compute_dtype] is not e4


def test_counters_and_the_gate_off_the_card(model):
    """Off the card ``auto`` runs the plain loop: every token step is
    counted, none as a replay or a capture; ``static`` at a temperature
    above 0 (sampling draws from the caller's generator) runs it too."""
    task = _task(model, sample_len=6, **NO_TS)
    dec, cfg = model.decoder_for(torch.float32), task.loop_cfg
    init = _init(task, 2)
    with profiling.recording() as rec:
        tloop.greedy_decode(dec, cfg, _features(4, 2), init)
        tloop.greedy_decode(dec, cfg, _features(4, 2), init, 0.5,
                            torch.Generator().manual_seed(1), _loop="static")
    assert rec.counters == {"decode.token_steps": 2 * (cfg.sample_len - 1)}
    with profiling.recording() as rec:
        tloop.greedy_decode(dec, cfg, _features(4, 2), init, _loop="static")
    assert rec.counters == {"decode.token_steps": cfg.sample_len - 1}
    assert dec in tloop._STATIC


def test_decode_through_the_task_unchanged(model):
    """``port.decode`` (the plain loop on the CPU) and the kept buffers
    give the same results through ``DecodingTask``'s greedy call."""
    task = _task(model, **TS)
    feats = _features(31)
    want = task.run(feats)
    dec = model.decoder_for(torch.float32)
    buf, _, sum_lp, ns = tloop.greedy_decode(dec, task.loop_cfg, feats, _init(task, 3),
                                             _loop="static")
    for i, r in enumerate(want):
        row = buf[i, task.sample_begin:].tolist()
        row = row[:row.index(task.tokenizer.eot)] if task.tokenizer.eot in row else row
        assert row == r.tokens
        assert np.isclose(float(sum_lp[i]) / (len(r.tokens) + 1), r.avg_logprob, rtol=0,
                          atol=0)
        assert float(ns[i]) == r.no_speech_prob


def test_static_buffers_shared_by_threads(model):
    """Decodes from several threads through the kept buffers give each
    thread's batch the values it gets alone."""
    import concurrent.futures

    task = _task(model, **NO_TS)
    dec, cfg = model.decoder_for(torch.float32), task.loop_cfg
    init = _init(task, 3)
    seeds = [41, 42, 43, 44]
    want = [tloop.greedy_decode(dec, cfg, _features(s), init, _loop="plain") for s in seeds]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        got = list(pool.map(
            lambda s: tloop.greedy_decode(dec, cfg, _features(s), init, _loop="static"), seeds))
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[2], w[2]) and torch.equal(g[3], w[3])
