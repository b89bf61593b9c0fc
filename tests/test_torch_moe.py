"""The port's MoE encoder (``models/moe.py``) and its expert-parallel trunk
against the JAX package's (``qasr_ijcnlp_tpu/models/moe.py``,
``parallel/sharded.py`` ``ep_trunk``), on the CPU.

Without processes: top-1 routing (queue slots, dropped overflow, ``valid``
masking, the load-balance loss), the MoE MLP and the single-rank trunk on
padded rows, the capacity rule and the weight tree both ways.  In one spawn
of four gloo ranks (``tests/torch_parallel_ranks.py``): ``ep_trunk`` at
(2, 2) with a capacity that overflows (the capacity is per (rank, expert),
so this is held to JAX's ``ep_trunk`` on a (2, 2) mesh, not to the dense
trunk) and ``moe_encoder_apply(mesh=)`` at (1, 4) with the experts cut by
``shard_params``.  Inputs are random normals, so no two router
probabilities tie.  Tolerances are those of ``tests/test_moe.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import parallel as jpar
from qasr_ijcnlp_tpu.models import moe as jmoe
from qasr_ijcnlp_tpu.models.dims import ModelDimensions as JDims
from qasr_ijcnlp_tpu_torch.models import convert, moe
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
from tests.torch_parallel_ranks import run_ranks
from tests.torch_port_common import one_torch_thread  # noqa: F401

DIMS = JDims(n_mels=8, n_audio_ctx=64, n_audio_state=16, n_audio_head=2, n_audio_layer=2,
             n_vocab=64, n_text_ctx=8, n_text_state=16, n_text_head=2, n_text_layer=2)
AMPLE = dict(n_experts=4, capacity_factor=4.0)
TIGHT = dict(n_experts=4, capacity_factor=1.0)


def _pdims():
    return ModelDimensions.from_dict(dataclasses.asdict(DIMS))


@pytest.fixture(scope="module")
def trees():
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jmoe.init_moe_whisper_params(
        k, DIMS, jmoe.MoEConfig(**AMPLE)))(jax.random.PRNGKey(0)))
    module = moe.moe_whisper_from_state_dict(convert.from_jax_params(params, _pdims()),
                                             _pdims(), moe.MoEConfig(**AMPLE), "cpu")
    return params, module


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_capacity_rule():
    for n_tokens in (1, 10, 33, 256, 1000):
        for cf in (1.0, 1.25, 4.0):
            assert moe.MoEConfig(4, cf).capacity(n_tokens) == jmoe.MoEConfig(4, cf).capacity(
                n_tokens)


@pytest.mark.parametrize("capacity,valid", [(32, False), (8, False), (8, True)])
def test_route_matches_jax(capacity, valid):
    """Dispatch, combine and aux equal JAX's: ample capacity, an
    overflowing one (the first tokens of each queue kept) and padding rows
    masked out of the routing."""
    t, rw = _x((40, 16), 1), _x((16, 4), 2)
    v = (np.arange(40) < 29) if valid else None
    cfg = moe.MoEConfig(4)
    jd, jc, ja = jmoe.route(jnp.asarray(t), jnp.asarray(rw), jmoe.MoEConfig(4), capacity,
                            valid=None if v is None else jnp.asarray(v))
    d, c, a = moe.route(torch.from_numpy(t), torch.from_numpy(rw.T.copy()), cfg, capacity,
                        valid=None if v is None else torch.from_numpy(v))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    if capacity == 8:
        assert d.sum() < 40  # tokens were dropped
    if valid:
        assert float(d[29:].sum()) == 0.0


@pytest.mark.parametrize("cfg", [AMPLE, TIGHT])
def test_moe_mlp_matches_jax(trees, cfg):
    params, module = trees
    x = _x((2, 24, 16), 3)
    mp = jax.tree.map(lambda a: a[0], params["encoder"]["blocks"]["mlp"])
    valid = np.broadcast_to(np.arange(24) < 20, (2, 24))
    want, waux = jmoe.moe_mlp(mp, jnp.asarray(x), jmoe.MoEConfig(**cfg),
                              valid=jnp.asarray(valid))
    got, aux = moe.moe_mlp(module.encoder.blocks[0].mlp, torch.from_numpy(x),
                           moe.MoEConfig(**cfg), valid=torch.from_numpy(valid.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_moe_trunk_masks_padding_as_jax(trees):
    """Padded rows (>= t_real) are masked from attention and routing and cut
    off, with a capacity that overflows."""
    params, module = trees
    x = _x((2, 80, 16), 4)
    want, waux = jmoe.moe_trunk(jax.tree.map(jnp.asarray, params["encoder"]), jnp.asarray(x),
                                DIMS, jmoe.MoEConfig(**TIGHT), t_real=64)
    got, aux = moe.moe_trunk(module.encoder, torch.from_numpy(x), _pdims(),
                             moe.MoEConfig(**TIGHT), t_real=64)
    assert got.shape == (2, 64, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_moe_encoder_and_loss_match_jax(trees):
    params, module = trees
    mel = _x((2, 8, 128), 5)
    cfg = jmoe.MoEConfig(**AMPLE)
    want, waux = jmoe.moe_encoder_apply(params["encoder"], jnp.asarray(mel), DIMS, cfg)
    got, aux = moe.moe_encoder_apply(module.encoder, torch.from_numpy(mel), _pdims(),
                                     moe.MoEConfig(**AMPLE))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    tokens = np.array([[1, 5, 9, 3, -100], [2, 7, 7, 4, 6]], np.int32)
    wl = jmoe.moe_whisper_loss_fn(DIMS, cfg)(params, jnp.asarray(mel), jnp.asarray(tokens))
    pl = moe.moe_whisper_loss_fn(_pdims(), moe.MoEConfig(**AMPLE))(
        module, torch.from_numpy(mel), torch.from_numpy(tokens).long())
    np.testing.assert_allclose(float(pl), float(wl), rtol=1e-5)


def test_moe_tree_round_trip(trees):
    """The MoE leaves both ways: the port's state dict -> the JAX tree is
    the JAX package's tree, leaf for leaf; the specs shard the expert axis."""
    params, module = trees
    back = convert.to_jax_params(module, _pdims())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    from qasr_ijcnlp_tpu_torch import parallel

    jmesh = jpar.make_mesh(jax.devices()[:8], model_parallel=2)
    specs = parallel.param_specs(back, jmesh)["encoder"]["blocks"]["mlp"]
    assert specs["experts"]["fc"]["w"] == (None, "model", None, None)
    assert specs["router"]["w"] == ()
    ours = moe.init_moe_whisper_params(torch.Generator().manual_seed(0), _pdims(),
                                       moe.MoEConfig(**AMPLE))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    params, module = trees
    inputs = {"sd": convert.from_jax_params(params, _pdims()), "dims": _pdims(),
              "moe": moe.MoEConfig(**AMPLE), "moe_small": moe.MoEConfig(**TIGHT),
              "x": torch.from_numpy(_x((4, 64, 16), 6)),
              "mel": torch.from_numpy(_x((2, 8, 128), 7))}
    return inputs, run_ranks("moe", inputs, tmp_path_factory.mktemp("moe_ranks"))


def test_ep_trunk_matches_jax(trees, ranks):
    """(2, 2), capacity per (rank, expert) overflowing: the data groups'
    rows and the rank-averaged aux equal JAX's ``ep_trunk`` on (2, 2)."""
    params, _ = trees
    inputs, outs = ranks
    assert [o["ep_index"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    torch.testing.assert_close(outs[0]["ep"], outs[1]["ep"], rtol=0, atol=0)
    mesh = jpar.make_mesh(jax.devices()[:4], model_parallel=2)
    want, waux = jax.jit(lambda p, x: jpar.sharded.ep_trunk(
        p, x, DIMS, jmoe.MoEConfig(**TIGHT), 64, mesh))(
        jax.tree.map(jnp.asarray, params["encoder"]), jnp.asarray(inputs["x"].numpy()))
    got = torch.cat([outs[0]["ep"], outs[2]["ep"]]).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    for o in outs:
        np.testing.assert_allclose(o["ep_aux"], float(waux), rtol=1e-5)


def test_moe_encoder_apply_on_a_mesh_matches_jax(trees, ranks):
    """(1, 4): each rank keeps one expert of four (``shard_params``) and
    the encoder runs expert-parallel, as JAX's on a (1, 4) mesh."""
    params, _ = trees
    inputs, outs = ranks
    assert all(o["expert_rows"] == (1, 64, 16) for o in outs)
    mesh = jpar.make_mesh(jax.devices()[:4], model_parallel=4)
    cfg = jmoe.MoEConfig(**AMPLE)
    assert jpar.sharded.ep_trunk_applicable(DIMS, cfg, mesh, 2, 64)
    want, waux = jax.jit(lambda p, m: jmoe.moe_encoder_apply(p, m, DIMS, cfg, mesh=mesh))(
        jax.tree.map(jnp.asarray, params["encoder"]), jnp.asarray(inputs["mel"].numpy()))
    for o in outs:
        np.testing.assert_allclose(o["apply"].numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(o["apply_aux"], float(waux), rtol=1e-5)
