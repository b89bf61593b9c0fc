"""The port's meshes, sharding rules and sharded paths against the JAX
package (``qasr_ijcnlp_tpu/parallel``), on the CPU.

Without processes: ``param_specs`` leaf for leaf (tiny and a large-v3 tree,
three mesh shapes, with and without FSDP), the mesh degradation table,
``round_up_to_mesh`` / ``pad_batch_to_mesh``, ``shard_params``' slices, and
the head-sharded attention (K4's plain version at Dl < D) against the JAX
``fused_attention_ln`` on column-sliced weights, kernel in interpret mode.

In one spawn of four gloo ranks (``tests/torch_parallel_ranks.py``): the
tensor-parallel trunk at (2, 2) with the kernel gate admitting and
refusing, the sequence-parallel trunk at (1, 4) on six heads, the pipeline
trunk at (1, 2), each against the JAX trunk on the same mesh shape (the 8
virtual CPU devices of ``tests/conftest.py``); data-parallel greedy and
beam decode of a batch of 6 over 4 ranks, the data-parallel engine pool and
the micro-batcher against the unsharded port.  Tolerances are those of the
JAX tests of the same functions (``tests/test_shardmap_kernels.py``,
``tests/test_parallel.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import parallel as jpar
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.dims import ModelDimensions as JDims
from qasr_ijcnlp_tpu.ops import encoder_block as jeb
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch import parallel
from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine
from qasr_ijcnlp_tpu_torch.models import convert
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions, dims_for
from qasr_ijcnlp_tpu_torch.models.whisper import Whisper, init_params
from qasr_ijcnlp_tpu_torch.ops import encoder_block as eb
from tests.torch_parallel_ranks import run_ranks
from tests.torch_port_common import LF_DIMS, one_torch_thread, speechlike_pcm  # noqa: F401

# The JAX tests' trunk geometry: heads of 64 in pairs at tp = 2
TP_DIMS = JDims(n_mels=16, n_audio_ctx=500, n_audio_state=256, n_audio_head=4,
                n_audio_layer=2, n_vocab=128, n_text_ctx=16, n_text_state=256,
                n_text_head=4, n_text_layer=2)
# six heads, which four model ranks do not divide: sequence parallelism
SP_DIMS = JDims(n_mels=16, n_audio_ctx=500, n_audio_state=384, n_audio_head=6,
                n_audio_layer=2, n_vocab=128, n_text_ctx=16, n_text_state=384,
                n_text_head=6, n_text_layer=2)
T_REAL = 500
GREEDY = dict(language="en", without_timestamps=True, sample_len=8, fp16=False)
BEAM = dict(GREEDY, beam_size=2, sample_len=6)


def _port_dims(d) -> ModelDimensions:
    return ModelDimensions.from_dict(dataclasses.asdict(d))


def _jparams(dims, seed):
    return jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), dims))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jmesh(n, model_parallel):
    return jpar.make_mesh(jax.devices()[:n], model_parallel=model_parallel)


# ---------------------------------------------------------------------------
# Without processes
# ---------------------------------------------------------------------------


def _shape_tree(dims):
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, dims), jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: s, shapes)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", ["tiny", "large-v3"])
def test_param_specs_match_jax(name, fsdp):
    """Leaf for leaf at (8, 1), (4, 2) and (2, 4): the demotion of the 51865
    and 51866 vocabularies and the FSDP augmentation included."""
    jd = JDims(**dataclasses.asdict(dims_for(name)))
    tree = _shape_tree(jd)
    for mp in (1, 2, 4):
        jmesh = _jmesh(8, mp)
        want = jpar.param_specs(tree, jmesh, fsdp=fsdp)
        got = parallel.param_specs(tree, jmesh, fsdp=fsdp)
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat_w) == len(jax.tree_util.tree_leaves(tree))
        for path, spec in flat_w:
            node = got
            for p in path:
                node = node[p.key]
            assert tuple(spec) == node, (mp, path, spec, node)
    assert parallel.param_specs(tree)["decoder"]["tok_emb"] == ("model", None)


def test_param_specs_on_the_ports_layout():
    """The port's own module through ``to_jax_params`` gives the JAX tree's
    shapes, so its specs are JAX's."""
    sd = init_params(torch.Generator().manual_seed(0), _port_dims(TP_DIMS))
    ours = convert.to_jax_params(sd, _port_dims(TP_DIMS))
    tree = _jparams(TP_DIMS, 0)
    assert jax.tree.map(np.shape, ours) == jax.tree.map(np.shape, tree)
    jmesh = _jmesh(8, 2)
    got = parallel.param_specs(ours, jmesh)
    want = jpar.param_specs(tree, jmesh)
    assert jax.tree.map(tuple, want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)) \
        == got
    blocks = jax.tree.map(lambda a: a[0], tree["encoder"]["blocks"])
    assert parallel.encoder_block_specs(blocks) == jax.tree.map(
        tuple, jpar.encoder_block_specs(blocks),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))


def test_make_mesh_degrades_to_divisor():
    """The reference's degradation table (test_make_mesh_degrades_to_divisor)
    and the one-rank mesh of a process without a group."""
    for n, mp, want in ((6, 4, (2, 3)), (1, 2, (1, 1)), (4, 0, (4, 1)), (4, -1, (4, 1)),
                        (8, 2, (4, 2)), (8, 3, (4, 2)), (5, 4, (5, 1))):
        assert parallel.mesh_shape(n, mp) == want
        jm = jpar.make_mesh(jax.devices()[:n], model_parallel=mp)
        assert (jm.shape["data"], jm.shape["model"]) == want
    m = parallel.make_mesh(model_parallel=2)
    assert m.shape == {"data": 1, "model": 1} and m.size == 1 and m.is_leader
    parallel.initialize_distributed()  # no launcher, no arguments: a no-op
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_refuses_explicit_failure(tmp_path):
    with pytest.raises(RuntimeError, match="init_process_group failed"):
        parallel.initialize_distributed("bogus://x", world_size=2, rank=0)


def test_round_and_pad_batch_to_mesh():
    jm = _jmesh(8, 1)
    pm = type("M", (), {"shape": {"data": 8, "model": 1}})()
    for n in (1, 8, 10, 16, 17):
        assert parallel.round_up_to_mesh(n, pm) == jpar.round_up_to_mesh(n, jm)
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    want, real = jpar.pad_batch_to_mesh(jnp.asarray(x), jm)
    got, real2 = parallel.pad_batch_to_mesh(torch.from_numpy(x), pm)
    assert real == real2 == 10 and got.shape == (16, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = torch.from_numpy(x)
    (a, b), r = parallel.pad_batch_to_mesh((t, t[:, 0]), pm)
    assert r == 10 and a.shape == (16, 3) and b.shape == (16,)
    assert parallel.shard_batch(got, None) is got
    assert parallel.batch_spec(3) == tuple(jpar.batch_spec(3))


@pytest.mark.parametrize("d_head", [64, 128])
def test_head_sharded_attention_matches_jax(d_head):
    """K4 head-sharded (plain version here) against the JAX
    ``fused_attention_ln`` on (D, Dl) column slices, Dl < D, kernel in
    interpret mode: each rank's heads, in the weight columns' order."""
    D, tp, T = 256, 2, 500
    n_head = D // d_head
    blk = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(7), TP_DIMS)["encoder"]["blocks"])
    bp = jax.tree.map(lambda a: a[0], blk)
    x = _x((1, 512, D), 8)
    enc = _port_encoder(TP_DIMS, 7)
    for m in range(tp):
        cols = slice(m * D // tp, (m + 1) * D // tp)
        ap = {k: {kk: (vv[:, cols] if kk == "w" else vv[cols]) for kk, vv in bp["attn"][k].items()}
              for k in ("query", "key", "value")}
        assert jeb.attn_applicable(n_head // tp, D, 512, d_head=d_head) == (
            eb.attn_applicable(n_head // tp, D, 512, d_head=d_head))
        want = np.asarray(jeb.fused_attention_ln(jnp.asarray(x), bp["attn_ln"], ap,
                                                 n_head // tp, T))
        sliced = _port_slice(enc.blocks[0], tp, m)
        got = eb.fused_attention_ln(torch.from_numpy(x), sliced.attn_ln, sliced.attn,
                                    n_head // tp, T)
        assert got.shape == (1, 512, D // tp)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4)


def _port_encoder(jdims, seed):
    from qasr_ijcnlp_tpu_torch.models.whisper import AudioEncoder

    d = _port_dims(jdims)
    enc = AudioEncoder(d.n_mels, d.n_audio_ctx, d.n_audio_state, d.n_audio_head,
                       d.n_audio_layer)
    enc.load_state_dict(convert.from_jax_encoder(_jparams(jdims, seed)["encoder"], d, ""))
    return enc.requires_grad_(False)


def _port_slice(block, tp, m):
    """A copy of one block cut as ``shard_params`` cuts rank m of tp."""
    import copy

    holder = torch.nn.Module()
    holder.blocks = torch.nn.ModuleList([copy.deepcopy(block)])
    holder.ln_post = torch.nn.LayerNorm(1)
    mesh = type("M", (), {"shape": {"data": 1, "model": tp},
                          "index": lambda self, a: m})()
    parallel.shard_params(holder, mesh)
    return holder.blocks[0]


def test_shard_params_follows_the_specs():
    """A rank keeps the JAX layout's column (Q/K/V, fc) and row (out,
    proj) slices; biases of the row-parallel layers and the decoder stay
    whole; a mesh without a model axis changes nothing."""
    d = _port_dims(TP_DIMS)
    sd = init_params(torch.Generator().manual_seed(1), d)
    for m in range(2):
        w = Whisper(d)
        w.load_state_dict(sd)
        mesh = type("M", (), {"shape": {"data": 2, "model": 2},
                              "index": lambda self, a, m=m: m})()
        parallel.shard_params(w, mesh)
        b = w.encoder.blocks[1]
        cut = lambda k, dim: sd[f"encoder.blocks.1.{k}"].chunk(2, dim)[m]
        assert torch.equal(b.attn.query.weight, cut("attn.query.weight", 0))
        assert torch.equal(b.attn.query.bias, cut("attn.query.bias", 0))
        assert torch.equal(b.attn.key.weight, cut("attn.key.weight", 0))
        assert torch.equal(b.attn.out.weight, cut("attn.out.weight", 1))
        assert torch.equal(b.attn.out.bias, sd["encoder.blocks.1.attn.out.bias"])
        assert torch.equal(b.mlp[0].weight, cut("mlp.0.weight", 0))
        assert torch.equal(b.mlp[2].weight, cut("mlp.2.weight", 1))
        assert torch.equal(b.mlp[2].bias, sd["encoder.blocks.1.mlp.2.bias"])
        assert b.attn.query.out_features == 128 and b.mlp[2].in_features == 512
        assert w.decoder.blocks[0].attn.query.weight.shape == (256, 256)
        assert parallel.is_head_sharded(w.encoder)
    w = Whisper(d)
    parallel.shard_params(w, type("M", (), {"shape": {"data": 4, "model": 1}})())
    assert not parallel.is_head_sharded(w.encoder)


# ---------------------------------------------------------------------------
# Four gloo ranks, one spawn for the module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params as pinit

    tp_sd = convert.from_jax_encoder(_jparams(TP_DIMS, 3)["encoder"], _port_dims(TP_DIMS), "")
    sp_sd = convert.from_jax_encoder(_jparams(SP_DIMS, 6)["encoder"], _port_dims(SP_DIMS), "")
    lf = _port_dims(LF_DIMS)
    rng = np.random.default_rng(11)
    pcm = [speechlike_pcm(s, seed=i) for i, s in enumerate((4.0, 7.5, 2.0, 9.0, 5.5))]
    inputs = {
        "tp": {"sd": tp_sd, "dims": _port_dims(TP_DIMS), "x": torch.from_numpy(_x((2, 512, 256), 4)),
               "t_real": T_REAL},
        "sp": {"sd": sp_sd, "dims": _port_dims(SP_DIMS), "x": torch.from_numpy(_x((2, 512, 384), 14)),
               "t_real": T_REAL},
        "pp": {"sd": tp_sd, "dims": _port_dims(TP_DIMS), "x": torch.from_numpy(_x((4, 512, 256), 17)),
               "t_real": T_REAL},
        "dp": {"sd": pinit(torch.Generator().manual_seed(5), lf), "dims": lf,
               "mel": torch.from_numpy(rng.standard_normal((6, 80, 3000)).astype(np.float32)),
               "greedy": GREEDY, "beam": BEAM, "pcm": pcm},
    }
    outs = run_ranks("parallel", inputs, tmp_path_factory.mktemp("ranks"))
    return inputs, outs


def _jtrunk(fn, params_enc, x, dims, mesh, flash=None):
    jmodel.set_flash_attention(flash)
    try:
        return np.asarray(jax.jit(lambda p, xx: fn(p, xx, dims, T_REAL, mesh))(
            params_enc, jnp.asarray(x)))
    finally:
        jmodel.set_flash_attention(None)


@pytest.mark.parametrize("case,flash", [("tp_on", True), ("tp_off", False)])
def test_tp_trunk_matches_jax(ranks, case, flash):
    """(2, 2): every model rank of a data group returns its rows; the data
    groups' rows together equal the JAX trunk's on a (2, 2) mesh, with the
    gate admitting K4 head-sharded (2 heads of 64 a rank) and refusing it
    (kernels off)."""
    inputs, outs = ranks
    assert [o[case + "_kernel"] for o in outs] == [flash] * 4
    assert outs[0][case + "_shapes"] == ((128, 256), (256, 128), (256, 512))
    assert [o["tp_index"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    torch.testing.assert_close(outs[0][case], outs[1][case], rtol=0, atol=0)
    got = torch.cat([outs[0][case], outs[2][case]]).numpy()
    mesh = _jmesh(4, 2)
    want = _jtrunk(jpar.sharded.tp_trunk, jax.tree.map(jnp.asarray, _jparams(TP_DIMS, 3)["encoder"]),
                   inputs["tp"]["x"].numpy(), TP_DIMS, mesh, flash)
    assert got.shape == want.shape == (2, T_REAL, 256)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_sp_trunk_matches_jax(ranks):
    """(1, 4) on six heads: the dispatch refuses TP and takes the
    time-sharded trunk, on a model whose Q/K/V were cut for TP (gathered
    back first, as GSPMD gathers them)."""
    inputs, outs = ranks
    assert not any(o["sp_tp_applicable"] for o in outs)
    for o in outs[1:]:
        torch.testing.assert_close(o["sp"], outs[0]["sp"], rtol=0, atol=0)
    want = _jtrunk(jpar.sharded.sp_trunk, jax.tree.map(jnp.asarray, _jparams(SP_DIMS, 6)["encoder"]),
                   inputs["sp"]["x"].numpy(), SP_DIMS, _jmesh(4, 4), False)
    np.testing.assert_allclose(outs[0]["sp"].numpy(), want, atol=5e-4, rtol=5e-4)


def test_pp_trunk_matches_jax(ranks):
    """(1, 2) on ranks 0 and 1 (a sub-mesh; ranks 2 and 3 stay out): two
    stages of one layer, four microbatches."""
    inputs, outs = ranks
    assert "pp" not in outs[2] and "pp" not in outs[3]
    torch.testing.assert_close(outs[0]["pp"], outs[1]["pp"], rtol=0, atol=0)
    want = _jtrunk(jpar.sharded.pp_trunk, jax.tree.map(jnp.asarray, _jparams(TP_DIMS, 3)["encoder"]),
                   inputs["pp"]["x"].numpy(), TP_DIMS, _jmesh(2, 2), False)
    np.testing.assert_allclose(outs[0]["pp"].numpy(), want, atol=5e-4, rtol=5e-4)


@pytest.fixture(scope="module")
def plain_model(ranks):
    inputs, _ = ranks
    dp = inputs["dp"]
    return port.WhisperModel.from_state_dict(dp["sd"], dp["dims"], "cpu")


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_data_parallel_decode_matches_unsharded(ranks, plain_model, kind):
    """A batch of 6 over 4 data ranks (padded to 8, sliced back): every rank
    returns the unsharded decode's list, token for token, in order."""
    inputs, outs = ranks
    dp = inputs["dp"]
    want = port.decode(plain_model, dp["mel"], port.DecodingOptions(**dp[kind]))
    for o in outs:
        assert len(o[kind]) == 6
        for got, w in zip(o[kind], want):
            assert list(got[0]) == list(w.tokens)
            assert abs(got[1] - w.avg_logprob) < 1e-5
    for got, w in zip(outs[3]["greedy"], want):
        torch.testing.assert_close(got[2], w.audio_features, rtol=1e-5, atol=1e-5)


def test_data_parallel_kernels_see_local_rows(ranks):
    """Each data rank's encoder kernels run on its own 2 rows, exactly as a
    single-rank batch of 2 would (one stem and one attention per layer a
    decode), and the fused step (K10) never runs under a mesh even when
    switched on."""
    _, outs = ranks
    for o in outs:
        assert o["stem_rows"] == [2, 2]
        assert o["attn_rows"] == [2] * (2 * LF_DIMS.n_audio_layer)
        assert o["fused_calls"] == 0


def test_data_parallel_engine_matches_single_rank(ranks, plain_model):
    """8 slots over 4 ranks, 6 requests submitted on the leader: each
    result equals the single-rank engine's; the followers end when the
    leader closes; every rank admitted in its rows."""
    inputs, outs = ranks
    dp = inputs["dp"]
    eng = DecodeEngine(plain_model, port.DecodingOptions(**dp["greedy"]), slots=8)
    try:
        want = [eng.submit(m) for m in dp["mel"]]
    finally:
        eng.close()
    for got, w in zip(outs[0]["engine"], want):
        assert got["tokens"] == w["tokens"] and got["text"] == w["text"]
        assert abs(got["avg_logprob"] - w["avg_logprob"]) < 1e-5
    assert not any(o.get("engine_alive") for o in outs[1:])
    assert all(o["engine_admit_calls"] >= 1 for o in outs)


def test_data_parallel_transcriber_matches_decode(ranks):
    """Batch 3 rounded up to 4 over 4 ranks; five requests in two
    micro-batches equal a direct decode of their mels."""
    _, outs = ranks
    assert all(o["transcriber_batch"] == 4 for o in outs)
    got = [r["tokens"] for r in outs[0]["transcriber"]]
    assert got == [list(t) for t in outs[0]["direct"]]


def test_packs_follow_the_shard():
    """K4's weight pack, kept on the attention module, is made anew for the
    rank's slice: rank 0's slice starts where the whole weight did, so the
    pack must key on the shapes too, and the slice must be a copy."""
    d = _port_dims(TP_DIMS)
    enc = _port_encoder(TP_DIMS, 9)
    blk = enc.blocks[0]
    whole = eb.attention_pack(blk.attn_ln, blk.attn, torch.float32)
    assert whole["wqkv"].shape == (2, 3 * 256, 256)
    old = blk.attn.query.weight
    mesh = type("M", (), {"shape": {"data": 1, "model": 2}, "index": lambda self, a: 0})()
    parallel.shard_params(enc, mesh)
    assert blk.attn.query.weight.untyped_storage().data_ptr() != old.untyped_storage().data_ptr()
    assert blk.attn.query.weight.untyped_storage().nbytes() == 128 * 256 * 4
    cut = eb.attention_pack(blk.attn_ln, blk.attn, torch.float32)
    assert cut["wqkv"].shape == (2, 3 * 128, 256) and cut["bqkv"].shape == (3 * 128,)
    x = torch.from_numpy(_x((1, 512, 256), 10))
    assert eb.fused_attention_ln(x, blk.attn_ln, blk.attn, 2, T_REAL).shape == (1, 512, 128)
