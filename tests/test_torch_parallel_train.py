"""Sharded training in the port (``qasr_ijcnlp_tpu_torch/train/step.py``
``shard_state`` / ``make_sharded_train_step``, FSDP, sharded checkpoints,
distillation and the trainer CLI under a mesh) against the JAX package, on
the CPU.

One spawn of four gloo ranks (``tests/torch_parallel_ranks.py``, scenario
``train``) runs every case; JAX runs its functions on the 8 virtual CPU
devices of ``tests/conftest.py``.  The dims are those of JAX's
``tests/test_fsdp.py`` (width 16, 2 heads, 2 layers, vocabulary 64, FSDP
from 128 elements):

* the gradients through the tensor-parallel trunk at (2, 2) against
  ``jax.grad`` of JAX's ``tp_trunk`` on a (2, 2) mesh, ``attn_ln`` first
  (the port's collectives once had no autograd record, so this gradient
  held only each rank's own heads), and the sequence- (1, 4) and pipeline-
  (1, 2) trunks' against the single-device encoder's
  (``tests/test_shardmap_kernels.py``);
* one step under TP (2, 2) against JAX's ``make_sharded_train_step`` on a
  (2, 2) mesh, with rows whose valid-token counts differ per data rank;
  FSDP (4, 1), FSDP x TP (2, 2), FSDP with ``accum=2`` and SP (1, 4)
  against the single-device step, each rank holding 1/n of each sliced
  leaf and of its moments (``tests/test_fsdp.py``, ``test_parallel.py``);
* a non-finite batch on one data rank skipping on every rank;
* an FSDP state saved whole, resumed on the mesh, restored on one rank, and
  a one-rank state restored onto a mesh;
* the expert-parallel step (``tests/test_moe.py``) and one sharded
  distillation step against JAX's;
* the trainer CLI with ``--model_parallel 2`` and ``--fsdp`` on the four
  ranks, one epoch, against the JAX CLI on one device (both on the
  synthetic sets).

Tolerances are those of the JAX tests of the same functions, or tighter.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qasr_ijcnlp_tpu import parallel as jpar, train as jtrain
from qasr_ijcnlp_tpu.cli import train_classical_whisper_asr as jtc
from qasr_ijcnlp_tpu.data import SyntheticLibriSpeech as JLibri
from qasr_ijcnlp_tpu.models import moe as jmoe, whisper as jmodel
from qasr_ijcnlp_tpu.models.dims import ModelDimensions as JDims
from qasr_ijcnlp_tpu.train import distill as jdistill
from qasr_ijcnlp_tpu_torch.models import convert
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
from tests.torch_parallel_ranks import run_ranks

DIMS = JDims(n_mels=8, n_audio_ctx=16, n_audio_state=16, n_audio_head=2, n_audio_layer=2,
             n_vocab=64, n_text_ctx=8, n_text_state=16, n_text_head=2, n_text_layer=2)
MOE_DIMS = dataclasses.replace(DIMS, n_audio_ctx=64)
MOE_CFG = dict(n_experts=4, capacity_factor=4.0, aux_weight=0.0)
# the CLI's audio is 30 s of 80 mel bins, its tokens the 51865-token vocabulary
CLI_DIMS = JDims(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                 n_audio_layer=1, n_vocab=51865, n_text_ctx=32, n_text_state=64,
                 n_text_head=2, n_text_layer=1)
CLI_ARGV = ["--model_size", "tiny", "--epochs", "1", "--batch_size", "4", "--max_samples",
            "8", "--max_tokens", "24", "--save_every", "1", "--warmup_epochs", "1", "--lr",
            "1e-3", "--device", "cpu", "--checkpoint_dir", "ck"]
HISTORY = "classical_whisper_asr_training_history.json"


def _pdims(d) -> ModelDimensions:
    return ModelDimensions.from_dict(dataclasses.asdict(d))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(n, mp):
    return jpar.make_mesh(jax.devices()[:n], model_parallel=mp)


def _batch():
    rng = np.random.default_rng(11)
    mel = rng.standard_normal((8, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    tokens = np.full((8, DIMS.n_text_ctx), -100, np.int32)
    tokens[:, :5] = rng.integers(1, DIMS.n_vocab, (8, 5))
    # valid-token counts that differ between the data ranks' rows
    tokens[1, 3:] = -100
    tokens[5, 2:] = -100
    tokens[6, 4:] = -100
    return mel, tokens


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX reference, computed once."""
    params = _np(jmodel.init_params(jax.random.PRNGKey(0), DIMS))
    teacher = _np(jmodel.init_params(jax.random.PRNGKey(1), DIMS))
    mel, tokens = _batch()
    rng = np.random.default_rng(5)
    gm = rng.standard_normal((4, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    # sum(out * proj): the JAX trunk tests' sum(out^2) of a LayerNorm output
    # is nearly constant, so its gradient is rounding noise
    proj = rng.standard_normal((4, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)
    old = jmodel._USE_FLASH
    jmodel.set_flash_attention(False)
    try:
        def sq(p, m, mesh=None):
            out = jmodel.encoder_apply(p, m, DIMS, mesh=mesh).astype(jnp.float32)
            return jnp.sum(out * jnp.asarray(proj))

        g_base = jax.jit(jax.grad(sq))(params["encoder"], jnp.asarray(gm))
        jm = _jmesh(4, 2)
        sp = jpar.shard_params(jax.tree.map(jnp.asarray, params), jm)
        g_tp = jax.jit(jax.grad(lambda p, m: sq(p, m, jm)))(
            sp["encoder"], jpar.shard_batch(jnp.asarray(gm), jm))

        tx = jtrain.make_optimizer(1e-3)
        loss_fn = jtrain.whisper_loss_fn(DIMS)
        state = jtrain.init_state(jax.tree.map(jnp.asarray, params), tx)
        ref_state, ref_m = jtrain.make_train_step(loss_fn, tx)(
            state, jnp.asarray(mel), jnp.asarray(tokens))
        state = jtrain.shard_state(jtrain.init_state(jax.tree.map(jnp.array, params), tx), jm)
        with jm:
            sh_state, sh_m = jtrain.make_sharded_train_step(loss_fn, tx, jm)(
                state, jnp.asarray(mel), jnp.asarray(tokens))

        cfg = jmoe.MoEConfig(**MOE_CFG)
        moe_params = _np(jax.jit(lambda k: jmoe.init_moe_whisper_params(k, MOE_DIMS, cfg))(
            jax.random.PRNGKey(2)))
        moe_mel = np.asarray(jax.random.normal(
            jax.random.PRNGKey(10), (4, MOE_DIMS.n_mels, 2 * MOE_DIMS.n_audio_ctx))) * 0.1
        moe_tokens = np.full((4, MOE_DIMS.n_text_ctx), -100, np.int32)
        moe_tokens[:, :4] = [[1, 5, 6, 2]] * 4
        moe_state, moe_m = jax.jit(jtrain.make_train_step(
            jmoe.moe_whisper_loss_fn(MOE_DIMS, cfg), tx))(
            jtrain.init_state(jax.tree.map(jnp.asarray, moe_params), tx),
            jnp.asarray(moe_mel), jnp.asarray(moe_tokens))

        dtx = optax.adamw(1e-3, b1=0.9, b2=0.98, eps=1e-6)
        d_state, d_m = jax.jit(jtrain.make_train_step(
            jdistill.distill_loss_fn(DIMS, DIMS), dtx))(
            jtrain.init_state(jax.tree.map(jnp.asarray, params), dtx),
            jax.tree.map(jnp.asarray, teacher), jnp.asarray(mel), jnp.asarray(tokens))
    finally:
        jmodel.set_flash_attention(old)
    return dict(
        params=params, teacher=teacher, mel=mel, tokens=tokens, gm=gm, proj=proj,
        g_base=_np(g_base), g_tp=_np(g_tp),
        ref_params=_np(ref_state.params), ref_loss=float(ref_m["loss"]),
        ref_norm=float(ref_m["grad_norm"]),
        sh_params=_np(sh_state.params), sh_loss=float(sh_m["loss"]),
        moe_params=moe_params, moe_mel=moe_mel.astype(np.float32), moe_tokens=moe_tokens,
        moe_ref_params=_np(moe_state.params), moe_ref_loss=float(moe_m["loss"]),
        d_params=_np(d_state.params), d_loss=float(d_m["loss"]))


@pytest.fixture(scope="module")
def cli_tree():
    return _np(jax.jit(lambda k: jmodel.init_params(k, CLI_DIMS))(jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def jax_cli(cli_tree, tmp_path_factory):
    """The JAX trainer CLI on one device: one epoch on the synthetic sets."""
    mp = pytest.MonkeyPatch()
    run = tmp_path_factory.mktemp("jax_cli")
    try:
        mp.setattr(jtc, "dims_for", lambda name: CLI_DIMS)
        mp.setattr(jtc, "load_librispeech", lambda split, n: JLibri(split, n))
        mp.setattr(jmodel, "init_params", lambda key, dims: jax.tree.map(jnp.asarray, cli_tree))
        mp.chdir(run)
        jtc.main(CLI_ARGV)
        with open(HISTORY) as f:
            return json.load(f)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ranks(jax_side, cli_tree, tmp_path_factory):
    j = jax_side
    tmp = tmp_path_factory.mktemp("train_ranks")
    pd = _pdims(DIMS)
    sd = convert.from_jax_params(j["params"], pd)
    inputs = dict(
        dims=pd, sd=sd, mel=torch.from_numpy(j["mel"]),
        tokens=torch.from_numpy(j["tokens"]).long(), grad_mel=torch.from_numpy(j["gm"]),
        grad_proj=torch.from_numpy(j["proj"]),
        enc_sd={k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")},
        teacher_sd=convert.from_jax_params(j["teacher"], pd), tmp=str(tmp),
        moe_dims=_pdims(MOE_DIMS), moe_cfg=MOE_CFG,
        moe_sd=convert.from_jax_params(j["moe_params"], _pdims(MOE_DIMS)),
        moe_mel=torch.from_numpy(j["moe_mel"]),
        moe_tokens=torch.from_numpy(j["moe_tokens"]).long(),
        cli=dict(dims=_pdims(CLI_DIMS), sd=convert.from_jax_params(cli_tree, _pdims(CLI_DIMS)),
                 argv=CLI_ARGV, tmp=str(tmp / "cli")))
    return run_ranks("train", inputs, tmp, timeout=600.0)


def _close_trees(got, want, atol, relative=False):
    """Leaf for leaf within ``atol``; ``relative``: of each leaf's largest
    magnitude (gradients, whose leaves span orders of magnitude)."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        scale = float(np.max(np.abs(w))) if relative else 1.0
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _encoder_tree(grads):
    return convert.to_jax_encoder({k: v.detach() for k, v in grads.items()})


def _params_tree(sd, dims=DIMS):
    return convert.to_jax_params({k: v.detach() for k, v in sd.items()}, _pdims(dims))


def test_tp_trunk_attn_ln_gradient_matches_jax(ranks, jax_side):
    """The gradient of ``attn_ln`` (whose K4 shard sees only this rank's
    heads) through the (2, 2) tensor-parallel trunk equals ``jax.grad`` of
    JAX's ``tp_trunk``: the column-parallel entry sums it over ``model``."""
    for r in ranks:
        got = _encoder_tree(r["tp_grads"])["blocks"]["attn_ln"]
        _close_trees(got, jax_side["g_tp"]["blocks"]["attn_ln"], 1e-4, relative=True)


@pytest.mark.parametrize("kind", ["tp", "sp", "pp"])
def test_trunk_gradients_match_jax(ranks, jax_side, kind):
    """Every encoder leaf's gradient of sum(out * proj) over the global
    batch, within 1e-4 of the leaf's largest: TP at (2, 2) against JAX's TP
    trunk, SP at (1, 4) (two heads, which four ranks do not divide) and PP
    at (1, 2) against the single-device encoder."""
    want = jax_side["g_tp" if kind == "tp" else "g_base"]
    got_ranks = ranks[:2] if kind == "pp" else ranks
    if kind == "sp":
        assert ranks[0]["sp_applicable"] == (False, True)
    for r in got_ranks:
        _close_trees(_encoder_tree(r[f"{kind}_grads"]), want, 1e-4, relative=True)


@pytest.mark.parametrize("name", ["tp", "fsdp", "fsdp_tp", "fsdp_accum", "sp"])
def test_sharded_step_matches_jax(ranks, jax_side, name):
    """One step on the mesh: the loss (rtol 1e-5) and every updated
    parameter (1e-5) of JAX's step, on every rank.  TP at (2, 2) against
    JAX's ``make_sharded_train_step`` on a (2, 2) mesh; the others against
    the single-device step, which JAX's own tests hold the sharded one to."""
    j = jax_side
    loss, params = ((j["sh_loss"], j["sh_params"]) if name == "tp"
                    else (j["ref_loss"], j["ref_params"]))
    for r in ranks:
        m = r[f"step_{name}"]
        np.testing.assert_allclose(m["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], j["ref_norm"], rtol=1e-5)
        assert m["skipped"] == 0
        _close_trees(_params_tree(r[f"params_{name}"]), params, 1e-5)


@pytest.mark.parametrize("name,n", [("fsdp", 4), ("fsdp_tp", 2), ("tp", 2)])
def test_each_rank_holds_its_share(ranks, name, n):
    """Under FSDP (4, 1) each rank holds 1/4 of every sliced leaf and of its
    two moments; under FSDP x TP (2, 2) and TP (2, 2) a leaf cut along one
    axis 1/2 and along both 1/4; the transformer weights are covered."""
    shares = ranks[0][f"shares_{name}"]
    assert len(shares) > 10
    for leaf, (p, mu, nu) in shares.items():
        assert p == mu == nu, leaf
        assert p in ((1 / n,) if name == "fsdp" else (1 / 2, 1 / 4)), (leaf, p)
    if name == "fsdp_tp":
        assert any(s[0] == 1 / 4 for s in shares.values())
        assert "decoder.token_embedding.weight" in shares


def test_nonfinite_batch_on_one_data_rank_skips_everywhere(ranks):
    for r in ranks:
        assert r["nan_skipped"] == 1 and r["nan_unchanged"] and r["nan_count"] == 0


def test_fsdp_resume_round_trip(ranks):
    """Saved whole from (4, 1) FSDP: resumed into a fresh template placed on
    the mesh (JAX's default FSDP threshold, so whole leaves) and into one
    already sliced (its layout kept), the next step's loss equals the
    uninterrupted run's; restored on one rank, the parameters are the
    gathered ones; a one-rank state restored onto (2, 2) with ``fsdp``
    slices again and gathers back to the same parameters."""
    for r in ranks:
        for kind in ("fresh", "sliced"):
            np.testing.assert_allclose(r["resumed_loss"][kind], r["after_loss"], rtol=1e-6)
        assert r["restored_shares_fresh"] == {}
        assert r["restored_shares_sliced"] and all(
            s == (0.25, 0.25, 0.25) for s in r["restored_shares_sliced"].values())
        assert r["one_rank_step"] == 1 and r["onto_mesh_count"] == 1
        for k, v in r["saved_params"].items():
            assert torch.equal(r["one_rank_params"][k], v), k
            assert torch.equal(r["onto_mesh_params"][k], v), k
        # (JAX's default FSDP threshold leaves these leaves whole along data)
        assert r["onto_mesh_layout"] and all(
            m is not None and d is None for m, d in r["onto_mesh_layout"].values())


def test_expert_parallel_step_matches_jax(ranks, jax_side):
    """The MoE step with its encoder expert-parallel at (2, 2), ample
    capacity and no load-balance term (JAX's
    ``test_ep_train_step_runs_and_matches_single_device``: loss rtol 1e-4),
    and its parameters against the single-device step's."""
    j = jax_side
    for r in ranks:
        assert r["ep_applicable"]
        np.testing.assert_allclose(r["ep_loss"], j["moe_ref_loss"], rtol=1e-4)
        _close_trees(_params_tree(r["ep_params"], MOE_DIMS), j["moe_ref_params"], 1e-5)


def test_sharded_distillation_step_matches_jax(ranks, jax_side):
    """One distillation step at (2, 2), student and teacher sharded: JAX's
    bare adamw step on one device."""
    j = jax_side
    for r in ranks:
        np.testing.assert_allclose(r["distill_loss"], j["d_loss"], rtol=1e-5)
        _close_trees(_params_tree(r["distill_params"]), j["d_params"], 1e-5)


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_trainer_cli_on_four_ranks_matches_jax(ranks, jax_cli, name):
    """``--model_parallel 2`` ((2, 2)) and ``--fsdp`` ((4, 1)): one epoch's
    losses and validation against the JAX CLI on one device; only the
    leader wrote, once."""
    for r in ranks:
        got = r["cli"][name]
        assert len(got["epochs"]) == len(jax_cli["epochs"]) == 1
        g, w = got["epochs"][0], jax_cli["epochs"][0]
        assert g["skipped"] == w["skipped"] == 0
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, err_msg=k)
        assert np.isfinite(g["val_wer"]) and np.isfinite(g["val_cer"])
        assert got["config"] == jax_cli["config"]
        assert {"ck", HISTORY} <= set(r["cli"][name + "_files"])


def test_a_fresh_view_carries_no_weight_pack():
    """The hazard "stale packs under FSDP", on the kernels' pack cache: two
    steps' gathered weights taken as fresh inference tensors at one address
    (version 0) share the key ``ops.encoder_block._kept`` packs by, so a
    module object kept across the steps keeps the first step's K4 and K5
    packs; ``parallel._view`` (what ``fsdp_view`` makes per use) starts
    without one and packs the second step's weights."""
    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock
    from qasr_ijcnlp_tpu_torch.ops import encoder_block as eb

    torch.manual_seed(0)
    blk = ResidualAttentionBlock(128, 2).requires_grad_(False)
    named = dict(blk.named_parameters())
    buf = {n: torch.empty_like(p) for n, p in named.items()}

    def gathered(scale):
        for n, p in named.items():
            buf[n].copy_(p * scale)
        return {n: torch.empty(0).set_(b.untyped_storage(), 0, b.shape, b.stride())
                for n, b in buf.items()}

    packs = lambda m: (eb.attention_pack(m.attn_ln, m.attn, torch.float32),
                       eb.finish_pack(m, torch.float32))
    with torch.inference_mode():
        kept = parallel._view(blk, gathered(1.0))
        first = packs(kept)
        second = gathered(1.5)
        fresh = packs(parallel._view(blk, second))
        for name, t in second.items():
            *path, leaf = name.split(".")
            m = kept
            for part in path:
                m = m._modules[part]
            m._parameters[leaf] = t
        stale = packs(kept)
    assert stale[0] is first[0] and stale[1] is first[1]
    assert fresh[0] is not first[0] and fresh[1] is not first[1]
    torch.testing.assert_close(fresh[0]["g"], named["attn_ln.weight"] * 1.5)
    torch.testing.assert_close(fresh[1]["bo"], named["attn.out.bias"] * 1.5)
    assert "_encoder_packs" not in parallel._view(kept, {"attn_ln.bias": second[
        "attn_ln.bias"]}).__dict__
