"""The port's training core (qasr_ijcnlp_tpu_torch/train/{schedule,step,
checkpoint}.py, the kernels' autograd Functions, the model's switches) vs
the JAX package.

Every model starts from one JAX ``init`` tree moved to the port through
numpy (``models.convert``), at narrow dims (``torch_port_common.DIMS``:
n_audio_ctx 500, width 128, two layers each side), on numpy-seeded batches
in f32 with dropout off.  The JAX side runs its own jitted step (optax
AdamW after ``clip_by_global_norm``, ``multi_transform`` masks).

Tolerances: losses 1e-5 relative (the same f32 ops in another summation
order); gradients 1e-4 of each leaf's largest magnitude (summation order
through two layers, an LSTM or a circuit); parameters after Adam steps
1e-2 of the learning rate (1e-5 at 1e-3): Adam moves each element by at
most ~lr, and an element whose gradient is near eps = 1e-6 moves by
g / (|g| + eps), as sensitive as 1 / eps to the gradient's last bits;
schedules 1e-6 relative (float32 cosines).  The autograd Functions are
held to 1e-6 of the plain version's autograd, and the padding contract to
1e-5 of each gradient's largest magnitude (the softmax sums over 512 keys
instead of 500, the extra ones exactly zero).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qasr_ijcnlp_tpu.data import CharVocabulary as JVocab
from qasr_ijcnlp_tpu.models import asr as jasr, classifier as jclf, quantum as jqm
from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.train import checkpoint as jckpt, loops as jloops
from qasr_ijcnlp_tpu.train import schedule as jsched, step as jstep
from qasr_ijcnlp_tpu_torch.models import asr, convert, quantum, whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.ops import conv_stem, encoder_block, flash
from qasr_ijcnlp_tpu_torch.train import checkpoint, loops, schedule, step as tstep
from tests.torch_port_common import DIMS, one_torch_thread  # noqa: F401

LR, HIDDEN, TEXT = 1e-3, 32, 16
P_TOL = 1e-2 * LR  # parameters after Adam steps (see above)
TEXTS = ["HELLO WORLD", "THE CAT SAT", "A QUICK TEST", "ON THE MAT", "DOGS RUN", "NO"]


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, rel, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    tol = rel * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{name}: max err {err} > {tol}"


def _port_named(module):
    return {n: p.detach().numpy().copy() for n, p in module.named_parameters()}


# -- schedules ------------------------------------------------------------------------

@pytest.mark.parametrize("kind,args", [
    ("warmup_cosine", (1e-3, 5, 50, 0.1)), ("warmup_cosine", (2e-4, 0, 20, 0.1)),
    ("warmup_cosine", (1e-3, 1, 1, 0.0)), ("cosine", (1e-3, 30, 1e-5)), ("cosine", (0.0, 4, 0.0)),
], ids=["warmup", "zero_warmup", "one_step", "cosine", "zero_peak"])
def test_schedules_equal_optax(kind, args):
    ours, ref = getattr(schedule, kind)(*args), getattr(jsched, kind)(*args)
    for s in range(0, 64):
        want = float(ref(s))
        for arg in (s, torch.tensor(s, dtype=torch.int32)):
            got = ours(arg)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), (s, want)


# -- the optimizer alone, on a linear loss whose gradient is the batch ------------------

def test_optimizer_equals_optax_with_clip_mask_and_skip():
    """AdamW after the clip, a frozen leaf and a NaN batch between two
    finite ones: the parameters equal optax's after each step; the clip is
    active (norm > 1); the skipped batch moves nothing, not even the
    schedule's count, while the step advances."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "frozen": rng.standard_normal(2).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    grads[1]["a"][0, 0] = np.nan
    mask = {"a": True, "b": True, "frozen": False}
    sched = jsched.warmup_cosine(LR, 1, 4)
    loss = lambda p, c: sum(jnp.sum(p[k] * c[k]) for k in p)
    tx = jstep.make_optimizer(sched, trainable_mask=mask)
    jstate = jstep.init_state(jax.tree.map(jnp.asarray, params), tx)
    jfn = jax.jit(jstep.make_train_step(loss, tx))

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    module["frozen"].requires_grad_(False)
    ttx = tstep.make_optimizer(schedule.warmup_cosine(LR, 1, 4), trainable_mask={"a", "b"})
    state = tstep.init_state(module, ttx)
    tfn = tstep.make_train_step(
        lambda m, c: sum(torch.sum(m[k] * c[k]) for k in m.keys()), ttx)
    for i, g in enumerate(grads):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, g))
        before = {k: v.detach().clone() for k, v in module.items()}
        opt_before = copy.deepcopy(state.opt_state)
        state, m = tfn(state, {k: torch.from_numpy(v) for k, v in g.items()})
        assert int(m["skipped"]) == int(jm["skipped"]) == (i == 1)
        assert int(state.step) == i + 1
        if i == 1:
            for k, v in module.items():
                assert torch.equal(v, before[k]), k
            for a, b in zip(state.opt_state["mu"] + state.opt_state["nu"],
                            opt_before["mu"] + opt_before["nu"]):
                assert torch.equal(a, b)
            assert int(state.opt_state["count"]) == int(opt_before["count"]) == 1
            continue
        assert float(m["grad_norm"]) > 1.0  # the clip scales this batch
        jnorm = optax.global_norm({k: g[k] for k in ("a", "b")})
        assert float(m["grad_norm"]) == pytest.approx(float(jnorm), rel=1e-6)
        for k in params:
            _close(module[k].detach().numpy(), np.asarray(jstate.params[k]), 1e-6, k)
        assert torch.equal(module["frozen"], torch.from_numpy(params["frozen"]))
    assert int(state.opt_state["count"]) == 2


# -- whole models: one and three steps against JAX's ---------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    vocab = JVocab.build(TEXTS)
    mel = (rng.standard_normal((6, 80, 2 * DIMS.n_audio_ctx)) * 0.5).astype(np.float32)
    chars = np.stack([vocab.encode(t, TEXT) for t in TEXTS]).astype(np.int32)
    tokens = np.full((6, 12), -100, np.int32)
    for i in range(6):
        n = 5 + i
        tokens[i, :n] = [50258, 50359, *rng.integers(220, 5000, n - 3), 50257]
    labels = rng.integers(0, 35, 6).astype(np.int32)
    return {"vocab": vocab, "mel": mel, "chars": chars, "tokens": tokens, "labels": labels}


def _batches(d, field):
    return [(d["mel"][i:i + 2], d[field][i:i + 2]) for i in (0, 2, 4)]


def _jax_run(loss_fn, params, mask, sched, batches):
    """JAX's per-leaf gradients on batch 0 and its (metrics, params) after
    each of the batches."""
    tx = jstep.make_optimizer(sched, trainable_mask=mask)
    state = jstep.init_state(params, tx)
    step = jstep.make_train_step(loss_fn, tx)
    # one program for the gradients and the step (one compile, not two)
    fn = jax.jit(lambda st, *b: (jax.grad(loss_fn)(st.params, *b), step(st, *b)))
    out, grads = [], None
    for b in batches:
        g, (state, m) = fn(state, *map(jnp.asarray, b))
        grads = g if grads is None else grads
        out.append(({k: float(v) for k, v in m.items()}, _tree(state.params)))
    return _tree(grads), out


def _port_run(loss_fn, module, mask, sched, batches, ids=True):
    """The port's gradients on batch 0 and its (metrics, parameters, state)
    after each batch, with the mask's requires_grad flags."""
    tx = tstep.make_optimizer(sched, trainable_mask=mask)
    with loops._trainable(module, tx.trainable_mask):
        named = tx.trainable(module)
        b0 = [torch.from_numpy(b) for b in batches[0]]
        b0[1] = b0[1].long() if ids else b0[1]
        grads = torch.autograd.grad(loss_fn(module, *b0), [p for _, p in named],
                                    materialize_grads=True)
        grads = {n: g.numpy() for (n, _), g in zip(named, grads)}
        state = tstep.init_state(module, tx)
        step = tstep.make_train_step(loss_fn, tx)
        out = []
        for b in batches:
            state, m = step(state, torch.from_numpy(b[0]), torch.from_numpy(b[1]).long())
            out.append(({k: float(v) for k, v in m.items()}, _port_named(module),
                        copy.deepcopy(state.opt_state)))
    return grads, out


@pytest.fixture(scope="module")
def qtree():
    """A JAX quantum model tree (3 qubits), numpy leaves."""
    return _tree(jqm.init_quantum_params(jax.random.PRNGKey(0), DIMS, 3))


def _char_models(q, kind, vocab):
    D = DIMS.n_audio_state
    head = _tree(jasr.init_lstm_decoder(jax.random.PRNGKey(2), D, vocab.num_chars, HIDDEN, 2)
                 if kind == "lstm" else
                 jasr.init_mlp_head(jax.random.PRNGKey(3), D, vocab.num_chars, D, 1))
    tm = quantum.QuantumWhisperModel.from_state_dict(convert.from_jax_params(q, DIMS), DIMS, "cpu")
    th = (asr.LSTMDecoder(D, vocab.num_chars, HIDDEN, 2) if kind == "lstm"
          else asr.MLPHead(D, vocab.num_chars, D, 1))
    th.load_state_dict(convert.from_jax_head(head))
    jparams = {"encoder": jax.tree.map(jnp.asarray, q["encoder"]),
               "head": jax.tree.map(jnp.asarray, head)}
    jm = jqm.QuantumWhisperModel(jax.tree.map(jnp.asarray, q), DIMS, n_qubits=3)
    return jparams, jm, torch.nn.ModuleDict({"encoder": tm.module.encoder, "head": th}), tm


def _to_port_names(jtree):
    """A JAX {"encoder", "head"} tree (numpy) -> the port's parameter names."""
    out = {k: v.numpy() for k, v in
           convert.from_jax_encoder(jtree["encoder"], DIMS, "encoder").items()}
    out.update({k: v.numpy() for k, v in convert.from_jax_head(jtree["head"], "head.").items()})
    return out


@pytest.fixture(scope="module")
def char_runs(data, qtree):
    """The quantum char-ASR model with each head, its mask, three cosine
    steps on both sides."""
    runs = {}
    for kind in ("lstm", "mlp"):
        jparams, jm, module, tm = _char_models(qtree, kind, data["vocab"])
        mask = jqm.trainable_mask(jparams, extra_names=("head",))
        batches = _batches(data, "chars")
        jg, jout = _jax_run(jloops.char_asr_loss_fn(jloops.encoder_fn_for(jm), kind),
                            jparams, mask, jsched.cosine(LR, 3), batches)
        before = _port_named(module)
        tmask = quantum.trainable_mask(module, extra_names=("head",))
        tg, tout = _port_run(loops.char_asr_loss_fn(loops.encoder_fn_for(tm), kind), module,
                             tmask, schedule.cosine(LR, 3), batches)
        runs[kind] = dict(jg=jg, jout=jout, tg=tg, tout=tout, before=before, mask=tmask,
                          jmask=mask)
    return runs


def _check_steps(jg, jout, tg, tout, to_port):
    jgrads = to_port(jg)
    assert set(tg) <= set(jgrads)
    for n, g in tg.items():
        assert np.isfinite(g).all(), n
        _close(g, jgrads[n], 1e-4, n)
    for i in (0, 2):  # after one step and after three
        jm, jp = jout[i]
        tm, tp = tout[i][:2]
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5), i
        assert tm["skipped"] == jm["skipped"] == 0
        jp = to_port(jp)
        for n in tg:
            _close(tp[n], jp[n], P_TOL / max(float(np.abs(jp[n]).max()), 1e-30), f"{i}:{n}")


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_char_asr_steps_match_jax(char_runs, kind):
    r = char_runs[kind]
    _check_steps(r["jg"], r["jout"], r["tg"], r["tout"], _to_port_names)
    # the port reports the norm over the trainable leaves: JAX's over the same
    jnorm = optax.global_norm(jax.tree.map(lambda g, m: g if m else jnp.zeros(()),
                                           r["jg"], r["jmask"]))
    assert set(r["tg"]) == r["mask"]
    assert r["tout"][0][0]["grad_norm"] > 0
    assert np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in r["tg"].values())) == \
        pytest.approx(float(jnorm), rel=1e-4)


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_frozen_leaves_stay_bit_identical(char_runs, kind):
    r = char_runs[kind]
    after = r["tout"][2][1]
    frozen = [n for n in after if n not in r["mask"]]
    assert len(frozen) > 20 and any(n.startswith("encoder.blocks.") for n in frozen)
    for n in frozen:
        assert np.array_equal(after[n], r["before"][n]), n
    assert all(not np.array_equal(after[n], r["before"][n]) for n in r["mask"])


@pytest.fixture(scope="module")
def clf_runs(data, qtree):
    """Quantum encoder + classifier head, batches 0, NaN, 2 on both sides."""
    q = qtree
    head = _tree(jclf.init_classifier_head(jax.random.PRNGKey(4), DIMS.n_audio_state, 35))
    jparams = {"encoder": jax.tree.map(jnp.asarray, q["encoder"]),
               "head": jax.tree.map(jnp.asarray, head)}
    jm = jqm.QuantumWhisperModel(jax.tree.map(jnp.asarray, q), DIMS, n_qubits=3)
    tm = quantum.QuantumWhisperModel.from_state_dict(convert.from_jax_params(q, DIMS), DIMS, "cpu")
    th = torch.nn.Linear(DIMS.n_audio_state, 35)
    th.load_state_dict(convert.from_jax_head(head))
    module = torch.nn.ModuleDict({"encoder": tm.module.encoder, "head": th})
    batches = _batches(data, "labels")
    batches[1] = (batches[1][0] * np.nan, batches[1][1])
    mask = jqm.trainable_mask(jparams, extra_names=("head",))
    jg, jout = _jax_run(jloops.classifier_loss_fn(jloops.encoder_fn_for(jm)), jparams, mask,
                        jsched.cosine(LR, 3), batches)
    tg, tout = _port_run(loops.classifier_loss_fn(loops.encoder_fn_for(tm)), module,
                         quantum.trainable_mask(module, extra_names=("head",)),
                         schedule.cosine(LR, 3), batches, ids=False)
    return dict(jg=jg, jout=jout, tg=tg, tout=tout)


def test_classifier_steps_match_jax(clf_runs):
    r = clf_runs
    _check_steps(r["jg"], r["jout"], r["tg"], r["tout"], _to_port_names)


def test_nonfinite_batch_changes_nothing_but_the_step(clf_runs):
    r = clf_runs
    (m1, p1, o1), (m2, p2, o2) = r["tout"][0], r["tout"][1]
    assert m2["skipped"] == r["jout"][1][0]["skipped"] == 1 and not np.isfinite(m2["loss"])
    for n in p1:
        assert np.array_equal(p1[n], p2[n]), n
    for a, b in zip(o1["mu"] + o1["nu"], o2["mu"] + o2["nu"]):
        assert torch.equal(a, b)
    assert int(o1["count"]) == int(o2["count"]) == 1 and int(r["tout"][2][2]["count"]) == 2
    # the next step runs at the schedule's second value, as JAX's does
    jp = _to_port_names(r["jout"][2][1])
    for n in r["tg"]:
        _close(r["tout"][2][1][n], jp[n], P_TOL / max(float(np.abs(jp[n]).max()), 1e-30), n)


@pytest.fixture(scope="module")
def token_setup(data):
    tree = _tree(jmodel.init_params(jax.random.PRNGKey(1), DIMS))
    return tree, _batches(data, "tokens")


def _token_module(tree):
    return WhisperModel.from_state_dict(convert.from_jax_params(tree, DIMS), DIMS, "cpu").module


def _token_names(jtree):
    return {k: v.numpy() for k, v in convert.from_jax_params(jtree, DIMS).items()}


@pytest.fixture(scope="module")
def token_runs(token_setup):
    tree, batches = token_setup
    jp = jax.tree.map(jnp.asarray, tree)
    jg, jout = _jax_run(jstep.whisper_loss_fn(DIMS), jp, None, jsched.warmup_cosine(LR, 1, 3),
                        batches)
    module = _token_module(tree)
    tg, tout = _port_run(tstep.whisper_loss_fn(DIMS), module, None,
                         schedule.warmup_cosine(LR, 1, 3), batches)
    return dict(jg=jg, jout=jout, tg=tg, tout=tout)


def test_token_steps_match_jax(token_runs):
    r = token_runs
    _check_steps(r["jg"], r["jout"], r["tg"], r["tout"], _token_names)
    assert "encoder.positional_embedding" in r["tg"]  # a JAX parameter, trained
    jnorm = optax.global_norm(r["jg"])
    assert r["tout"][0][0]["grad_norm"] == pytest.approx(float(jnorm), rel=1e-5)
    assert r["tout"][0][0]["grad_norm"] > 1.0  # the clip scales the first update


def test_accumulation_equals_the_full_batch(token_setup):
    """accum=2 over a batch of 4 (unequal valid counts per half) equals one
    step on the batch of 4.  (Against JAX's accumulation step: the
    classical trainer CLI with ``--grad_accum 2`` on both sides,
    tests/test_torch_train_cli.py.)"""
    tree, _ = token_setup
    rng = np.random.default_rng(3)
    mel = (rng.standard_normal((4, 80, 2 * DIMS.n_audio_ctx)) * 0.5).astype(np.float32)
    tokens = np.full((4, 10), -100, np.int32)
    for i, n in enumerate((4, 9, 6, 10)):
        tokens[i, :n] = [50258, 50359, *rng.integers(220, 5000, n - 3), 50257]
    got = []
    for accum in (2, 1):
        module = _token_module(tree)
        tx = tstep.make_optimizer(LR)
        fn = (tstep.make_accum_train_step(tstep.whisper_sum_loss_fn(DIMS), tx, 2) if accum > 1
              else tstep.make_train_step(tstep.whisper_loss_fn(DIMS), tx))
        with loops._trainable(module, None):
            _, m = fn(tstep.init_state(module, tx), torch.from_numpy(mel),
                      torch.from_numpy(tokens).long())
        got.append((m, _port_named(module)))
    (ma, pa), (mf, pf) = got
    assert float(ma["loss"]) == pytest.approx(float(mf["loss"]), rel=1e-6)
    assert float(ma["grad_norm"]) == pytest.approx(float(mf["grad_norm"]), rel=1e-5)
    for n in pa:
        _close(pa[n], pf[n], P_TOL / max(float(np.abs(pf[n]).max()), 1e-30), n)
    with pytest.raises(ValueError, match="micro-batches"):
        fn = tstep.make_accum_train_step(tstep.whisper_sum_loss_fn(DIMS), tx, 3)
        fn(tstep.init_state(module, tx), torch.from_numpy(mel), torch.from_numpy(tokens))


# -- checkpoints ------------------------------------------------------------------------

def test_port_checkpoint_is_read_by_jax(token_setup, tmp_path):
    """A token model after one port step, written as the trainers write
    their best checkpoints (``to_jax_params`` through ``save_pytree``): the
    JAX package's ``load_pytree`` reads it, and JAX's loss on it equals
    the port's."""
    tree, batches = token_setup
    module = _token_module(tree)
    tx = tstep.make_optimizer(LR)
    with loops._trainable(module, None):
        tstep.make_train_step(tstep.whisper_loss_fn(DIMS), tx)(
            tstep.init_state(module, tx), *(torch.from_numpy(b).long() if i else
                                             torch.from_numpy(b)
                                             for i, b in enumerate(batches[0])))
    path = str(tmp_path / "best_wer")
    checkpoint.save_pytree(path, convert.to_jax_params(module, DIMS), {"epoch": 0})
    restored = jckpt.load_pytree(path)
    assert jckpt.load_metadata(path) == {"epoch": 0}
    assert jax.tree.structure(restored) == jax.tree.structure(tree)
    mel, tok = batches[1]
    jloss = jstep.whisper_loss_fn(DIMS)(jax.tree.map(jnp.asarray, restored), jnp.asarray(mel),
                                        jnp.asarray(tok))
    with torch.no_grad():
        tloss = tstep.whisper_loss_fn(DIMS)(module, torch.from_numpy(mel),
                                            torch.from_numpy(tok).long())
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    pt = str(tmp_path / "model.pt")
    checkpoint.save_whisper_pt(pt, module, DIMS)
    sd, dims = convert.load_torch_checkpoint(pt)
    assert vars(dims) == vars(DIMS) and all(torch.equal(sd[k], v) for k, v in module.state_dict().items())


def test_restore_train_state_resumes_exactly(token_setup, tmp_path):
    """Three steps straight equal one step, a save, a restore into a fresh
    model and optimizer, and two more: bit for bit."""
    tree, batches = token_setup
    tx = tstep.make_optimizer(schedule.warmup_cosine(LR, 1, 3))
    step = tstep.make_train_step(tstep.whisper_loss_fn(DIMS), tx)
    args = [(torch.from_numpy(m), torch.from_numpy(t).long()) for m, t in batches]

    def run(state, bs):
        for b in bs:
            state, _ = step(state, *b)
        return state

    straight, first = _token_module(tree), _token_module(tree)
    resumed = _token_module(_tree(jmodel.init_params(jax.random.PRNGKey(9), DIMS)))
    with loops._trainable(straight, None), loops._trainable(first, None), \
            loops._trainable(resumed, None):
        s = run(tstep.init_state(straight, tx), args)
        checkpoint.save_train_state(str(tmp_path / "state"),
                                    run(tstep.init_state(first, tx), args[:1]), {"epoch": 0})
        s2 = checkpoint.restore_train_state(str(tmp_path / "state"),
                                            tstep.init_state(resumed, tx))
        assert int(s2.step) == 1 and int(s2.opt_state["count"]) == 1
        s2 = run(s2, args[1:])
    assert int(s2.step) == int(s.step) == 3
    for (n, a), b in zip(straight.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(s.opt_state["mu"] + s.opt_state["nu"], s2.opt_state["mu"] + s2.opt_state["nu"]):
        assert torch.equal(a, b)


# -- the kernels' autograd Functions, the padding contract, packs and switches -----------

def _grads(fn, tensors):
    with torch.enable_grad():
        xs = [t.detach().clone().requires_grad_(True) for t in tensors]
        out = fn(*xs)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
        return out.detach(), torch.autograd.grad(out, xs, g)


def _ns(**kw):
    from types import SimpleNamespace

    return SimpleNamespace(**kw)


def _function_case(kernel, monkeypatch):
    """(Function call, plain version, inputs) of one kernel, its launcher
    replaced by the plain version (a CPU has no kernel)."""
    torch.manual_seed(0)
    D, H, Tp, tr = 128, 2, 256, 200
    blk = tmodel.ResidualAttentionBlock(D, H)
    x = torch.randn(2, Tp, D)
    if kernel == "stem":
        enc = tmodel.AudioEncoder(80, 300, D, H, 1)
        monkeypatch.setattr(conv_stem, "_launch_stem", conv_stem._plain_stem)
        stem_ns = lambda w1, b1, w2, b2, pos: _ns(
            conv1=_ns(weight=w1, bias=b1), conv2=_ns(weight=w2, bias=b2),
            positional_embedding=pos)
        return (lambda mel, *w: conv_stem.ConvStemFunction.apply(mel, *w, enc, Tp,
                                                                 torch.float32),
                lambda mel, *w: conv_stem._plain_stem(stem_ns(*w), mel, Tp, torch.float32),
                [torch.randn(2, 80, 400), *conv_stem._stem_weights(enc)])
    if kernel == "attn_ln":
        monkeypatch.setattr(encoder_block, "_launch_attention", encoder_block._plain_attn_ln)
        attn_ns = lambda g, b, wq, bq, wk, wv, bv: (
            _ns(weight=g, bias=b), _ns(query=_ns(weight=wq, bias=bq),
                                       key=_ns(weight=wk, bias=None),
                                       value=_ns(weight=wv, bias=bv)))
        return (lambda x, *w: encoder_block.AttentionLNFunction.apply(
                    x, *w, blk.attn_ln, blk.attn, H, tr),
                lambda x, *w: encoder_block._plain_attn_ln(x, *attn_ns(*w), H, tr),
                [x, *encoder_block._attention_weights(blk.attn_ln, blk.attn)])
    if kernel == "finish":
        monkeypatch.setattr(encoder_block, "_launch_finish", encoder_block._plain_finish)
        block_ns = lambda wo, bo, g, b, wf, bf, wp, bp: _ns(
            attn=_ns(out=_ns(weight=wo, bias=bo)), mlp_ln=_ns(weight=g, bias=b),
            mlp=[_ns(weight=wf, bias=bf), None, _ns(weight=wp, bias=bp)])
        return (lambda x, a, *w: encoder_block.BlockFinishFunction.apply(x, a, *w, blk),
                lambda x, a, *w: encoder_block._plain_finish(x, a, block_ns(*w)),
                [x, torch.randn_like(x), *encoder_block._finish_weights(blk)])
    if kernel == "packed":
        monkeypatch.setattr(flash, "_launch_packed", flash._plain_attention_packed)
        return (lambda q, k, v: flash.PackedAttentionFunction.apply(q, k, v, H, tr),
                lambda q, k, v: flash._plain_attention_packed(q, k, v, H, tr),
                [x, torch.randn_like(x), torch.randn_like(x)])
    monkeypatch.setattr(flash, "_launch_4d", flash._plain_attention)
    base = torch.randn(3, 2, Tp, H, 96)  # strided head views, as the trunk passes them
    return (lambda q, k, v: flash.FlashAttentionFunction.apply(q, k, v, tr),
            lambda q, k, v: flash._plain_attention(q, k, v, tr),
            [base[i].transpose(1, 2) for i in range(3)])


@pytest.mark.parametrize("kernel", ["stem", "attn_ln", "finish", "packed", "flash4d"])
def test_kernel_functions_differentiate_the_plain_version(monkeypatch, kernel):
    """Each Function with its launcher standing in as the plain version: its
    forward and the gradients of every input equal autograd through the
    plain version itself; an input that needs no gradient gets none."""
    fn, plain, ins = _function_case(kernel, monkeypatch)
    out, got = _grads(fn, ins)
    want_out, want = _grads(plain, ins)
    assert torch.equal(out, want_out)
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=f"input {i}")
    xs = [t.detach().clone().requires_grad_(i == 0) for i, t in enumerate(ins)]
    (gx,) = torch.autograd.grad(fn(*xs).sum(), xs[:1])
    assert gx.shape == ins[0].shape and torch.isfinite(gx).all()


def test_padding_rows_do_not_reach_a_gradient():
    """The trunk at 500 rows padded to 512 (keys >= 500 masked, rows sliced
    off) against the same blocks on the 500 rows alone: equal, finite
    gradients for the input and every weight."""
    torch.manual_seed(0)
    enc = tmodel.AudioEncoder(80, 500, 128, 2, 2)
    x = torch.randn(2, 500, 128)

    def unpadded(x):
        for bp in enc.blocks:
            x = encoder_block._plain_finish(
                x, encoder_block._plain_attn_ln(x, bp.attn_ln, bp.attn, 2, 500), bp)
        return tmodel.layer_norm(x, enc.ln_post)

    g = torch.randn(2, 500, 128, generator=torch.Generator().manual_seed(2))
    ws = list(enc.blocks.parameters()) + list(enc.ln_post.parameters())
    res = []
    for fn in (lambda x: tmodel.transformer_trunk(enc, x, DIMS, t_real=500), unpadded):
        xi = x.clone().requires_grad_(True)
        out = fn(xi)
        res.append((out, torch.autograd.grad(out, [xi, *ws], g)))
    (o1, g1), (o2, g2) = res
    torch.testing.assert_close(o1, o2, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g2):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-5)


def test_packs_and_the_decoder_copy_follow_in_place_updates():
    """An optimizer step updates weights in place: the kernel packs and
    ``decoder_for``'s cast copy are rebuilt from the new values."""
    torch.manual_seed(0)
    blk = tmodel.ResidualAttentionBlock(128, 2).requires_grad_(False)
    p = encoder_block.attention_pack(blk.attn_ln, blk.attn, torch.float32)
    f = encoder_block.finish_pack(blk, torch.float32)
    assert encoder_block.attention_pack(blk.attn_ln, blk.attn, torch.float32) is p
    with torch.no_grad():
        blk.attn.value.bias.add_(1.0)
        blk.mlp_ln.weight.mul_(2.0)
    p2 = encoder_block.attention_pack(blk.attn_ln, blk.attn, torch.float32)
    f2 = encoder_block.finish_pack(blk, torch.float32)
    assert p2 is not p and torch.equal(p2["bqkv"][256:], blk.attn.value.bias)
    assert f2 is not f and torch.equal(f2["g"], blk.mlp_ln.weight)
    enc = tmodel.AudioEncoder(80, 300, 128, 2, 1)
    s = conv_stem.stem_pack(enc, torch.bfloat16)
    with torch.no_grad():
        enc.positional_embedding.add_(1.0)
    assert torch.equal(conv_stem.stem_pack(enc, torch.bfloat16)["pos"],
                       enc.positional_embedding.to(torch.bfloat16)) and s["pos"] is not None
    m = WhisperModel.from_state_dict(tmodel.init_params(torch.Generator().manual_seed(0), DIMS),
                                     DIMS, "cpu")
    dec = m.decoder_for(torch.bfloat16)
    assert m.decoder_for(torch.bfloat16) is dec
    with torch.no_grad():
        m.module.decoder.blocks[0].mlp[0].weight.mul_(-1)
    dec2 = m.decoder_for(torch.bfloat16)
    assert dec2 is not dec and torch.equal(
        dec2.blocks[0].mlp[0].weight, m.module.decoder.blocks[0].mlp[0].weight.bfloat16())


def test_switches_and_remat_keep_the_numbers(token_setup):
    """``set_flash_attention(False)`` and ``set_fused_mel(False)`` (the plain
    versions; on the CPU the same functions run) and ``set_remat(True)``
    (blocks recomputed in the backward) give the same loss and gradients."""
    from qasr_ijcnlp_tpu_torch import audio

    tree, batches = token_setup
    module = _token_module(tree)
    mel, tok = torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]).long()
    loss_fn = tstep.whisper_loss_fn(DIMS)
    pcm = np.random.default_rng(0).standard_normal(32000).astype(np.float32) * 0.1
    res = []
    for flash_on, remat in ((None, False), (False, False), (None, True)):
        tmodel.set_flash_attention(flash_on)
        tmodel.set_remat(remat)
        audio.set_fused_mel(flash_on)
        try:
            with loops._trainable(module, None):
                loss = loss_fn(module, mel, tok)
                grads = torch.autograd.grad(loss, list(module.parameters()))
            res.append((loss.detach(), grads, audio.log_mel_spectrogram(pcm, device="cpu")))
        finally:
            tmodel.set_flash_attention(None)
            tmodel.set_remat(False)
            audio.set_fused_mel(None)
    for loss, grads, m in res[1:]:
        assert torch.equal(loss, res[0][0]) and torch.equal(m, res[0][2])
        for a, b in zip(grads, res[0][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not any(p.requires_grad for p in module.parameters())


def test_simulator_tables_built_in_inference_mode_serve_training():
    """The simulator's device tables, first built under ``inference_mode``
    (an evaluation before training), are normal tensors: a later training
    step saves them for its backward."""
    from qasr_ijcnlp_tpu_torch.ops import qsim

    qsim._tables.cache_clear()
    x, w = torch.randn(5, 3), torch.randn(3, 3)
    with torch.inference_mode():
        qsim.quantum_expvals(x, w, 3)
    wg = w.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(qsim.quantum_expvals(x, wg, 3).sum(), wg)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
