"""Rank processes of the port's multi-rank CPU tests (test_torch_parallel.py,
test_torch_moe.py).

The port runs one process per rank; these tests start four, joined by gloo
through a ``file://`` store in the test's temporary directory (never a
fixed port), with one torch thread each.  :func:`run_ranks` writes the
cases' inputs, starts the ranks on this file as a script and returns every
rank's results; :func:`main` is a rank: it runs every case of one scenario
in order and writes its results.  This module imports no JAX: the ranks
load only torch and the port, and the test file holds their results
against the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(scenario: str, inputs: dict, tmp, world: int = 4, timeout: float = 300.0):
    """Run ``scenario`` on ``world`` rank processes; returns their result
    dicts in rank order.  A rank that fails fails the call with its
    output."""
    tmp = str(tmp)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    # a rank still running just before the timeout prints every thread's stack
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               QASR_RANK_DEADLINE=str(max(timeout - 15.0, 1.0)))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, tmp,
                               str(r), str(world)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    if bad:
        raise AssertionError("rank(s) failed:\n" + "\n".join(
            f"--- rank {r} (exit {rc})\n{log[-4000:]}" for r, rc, log in bad))
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Scenarios (run on every rank)
# ---------------------------------------------------------------------------


def _encoder(sd, dims):
    from qasr_ijcnlp_tpu_torch.models.whisper import AudioEncoder

    enc = AudioEncoder(dims.n_mels, dims.n_audio_ctx, dims.n_audio_state,
                       dims.n_audio_head, dims.n_audio_layer)
    enc.load_state_dict(sd)
    return enc.eval().requires_grad_(False)


def _record_rows(out: dict):
    """Count the rows each encoder-kernel wrapper sees on this rank (the
    stem and the fused block's attention): a data rank's kernels must see
    only its local batch.  Returns the function that stops counting."""
    from qasr_ijcnlp_tpu_torch.models import whisper as w
    from qasr_ijcnlp_tpu_torch.ops import encoder_block as eb

    out["stem_rows"], out["attn_rows"] = [], []
    stem, attn = w.fused_conv_stem, eb.fused_attention_ln

    def stem_rec(enc, mel, *a, **k):
        out["stem_rows"].append(int(mel.shape[0]))
        return stem(enc, mel, *a, **k)

    def attn_rec(x, *a, **k):
        out["attn_rows"].append(int(x.shape[0]))
        return attn(x, *a, **k)

    w.fused_conv_stem = stem_rec
    eb.fused_attention_ln = attn_rec  # the fused block's global

    def restore():
        w.fused_conv_stem, eb.fused_attention_ln = stem, attn
    return restore


def scenario_parallel(inp: dict, rank: int) -> dict:
    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.decode import DecodingOptions, decode
    from qasr_ijcnlp_tpu_torch.decode import loop as dloop
    from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine
    from qasr_ijcnlp_tpu_torch.models import whisper as w
    from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
    from qasr_ijcnlp_tpu_torch.ops import decoder_step
    from qasr_ijcnlp_tpu_torch.parallel import sharded
    from qasr_ijcnlp_tpu_torch.serving import BatchingTranscriber

    out: dict = {}
    # -- tensor parallel at (2, 2), the kernel gate admitting and refusing
    tp = inp["tp"]
    mesh = parallel.make_mesh(model_parallel=2)
    for name, flash in (("tp_on", None), ("tp_off", False)):
        w.set_flash_attention(flash)
        enc = parallel.shard_params(_encoder(tp["sd"], tp["dims"]), mesh)
        out[name + "_kernel"] = sharded.tp_uses_kernel(tp["dims"], mesh, tp["t_real"])
        out[name + "_shapes"] = (tuple(enc.blocks[0].attn.query.weight.shape),
                                 tuple(enc.blocks[0].attn.out.weight.shape),
                                 tuple(enc.blocks[0].mlp[2].weight.shape))
        with torch.inference_mode():
            out[name] = w.transformer_trunk(enc, parallel.shard_batch(tp["x"], mesh),
                                            tp["dims"], t_real=tp["t_real"], mesh=mesh)
    w.set_flash_attention(None)
    out["tp_index"] = (mesh.index("data"), mesh.index("model"))

    # -- sequence parallel at (1, 4), 6 heads (TP refused), on a sharded model
    sp = inp["sp"]
    mesh4 = parallel.make_mesh(model_parallel=4)
    enc = parallel.shard_params(_encoder(sp["sd"], sp["dims"]), mesh4)
    out["sp_tp_applicable"] = sharded.tp_trunk_applicable(sp["dims"], mesh4, 2)
    with torch.inference_mode():
        out["sp"] = w.transformer_trunk(enc, sp["x"], sp["dims"], t_real=sp["t_real"],
                                        mesh=mesh4)

    # -- pipeline parallel at (1, 2) on ranks 0 and 1
    pp = inp["pp"]
    mesh_pp = parallel.make_mesh(model_parallel=2, group=[0, 1])
    if mesh_pp.member:
        with torch.inference_mode():
            out["pp"] = sharded.pp_trunk(_encoder(pp["sd"], pp["dims"]), pp["x"], pp["dims"],
                                         pp["t_real"], mesh_pp)

    # -- data-parallel decode at (4, 1): greedy (K10 requested) and beam
    dp = inp["dp"]
    mesh_dp = parallel.make_mesh(model_parallel=1)
    model = WhisperModel.from_state_dict(dp["sd"], dp["dims"], "cpu").shard(mesh_dp)
    stop_counting = _record_rows(out)
    fused_calls = []
    fused = dloop.fused_decoder_step
    dloop.fused_decoder_step = lambda *a, **k: fused_calls.append(1) or fused(*a, **k)
    decoder_step.set_fused_decoder_step(True)
    try:
        greedy = decode(model, dp["mel"], DecodingOptions(**dp["greedy"]))
    finally:
        decoder_step.set_fused_decoder_step(False)
    out["fused_calls"] = len(fused_calls)
    beam = decode(model, dp["mel"], DecodingOptions(**dp["beam"]))
    stop_counting()
    out["greedy"] = [(r.tokens, r.avg_logprob, r.audio_features.clone()) for r in greedy]
    out["beam"] = [(r.tokens, r.avg_logprob) for r in beam]

    # -- the data-parallel engine pool: 8 slots over 4 ranks
    plain = WhisperModel.from_state_dict(dp["sd"], dp["dims"], "cpu")
    engine = DecodeEngine(plain, DecodingOptions(**dp["greedy"]), slots=8, mesh=mesh_dp)
    if rank == 0:
        out["engine"] = _submit_all(engine.submit, list(dp["mel"]))
        out["engine_admit_calls"] = engine.admit_calls
        engine.close()
    else:
        engine.join(timeout=240)
        out["engine_alive"] = engine._worker.is_alive()
        out["engine_admit_calls"] = engine.admit_calls

    # -- the data-parallel micro-batcher: batch 3 -> 4 over 4 ranks
    tr = BatchingTranscriber(plain, batch_size=3, max_wait_ms=200.0,
                             options=DecodingOptions(**dp["greedy"]), mesh=mesh_dp)
    out["transcriber_batch"] = tr.batch_size
    if rank == 0:
        out["transcriber"] = _submit_all(tr.transcribe, list(dp["pcm"]))
        from qasr_ijcnlp_tpu_torch.audio import wire_log_mel, wire_pcm16

        wires = [wire_pcm16(a) for a in dp["pcm"]]
        mels = wire_log_mel(torch.from_numpy(np.stack([a for a, _ in wires])),
                            torch.tensor([s for _, s in wires]), dp["dims"].n_mels)
        out["direct"] = [r.tokens for r in decode(plain, mels, DecodingOptions(**dp["greedy"]))]
        tr.close()
    else:
        tr.join(timeout=240)
    return out


def _submit_all(submit, items):
    """Submit every item from its own thread; the results in item order."""
    results = [None] * len(items)

    def one(i):
        results[i] = submit(items[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    return results


def scenario_moe(inp: dict, rank: int) -> dict:
    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.models import moe
    from qasr_ijcnlp_tpu_torch.parallel import sharded

    out: dict = {}
    cfg, dims = inp["moe"], inp["dims"]
    module = moe.moe_whisper_from_state_dict(inp["sd"], dims, cfg, "cpu")
    # ep_trunk at (2, 2) with an overflowing capacity
    mesh = parallel.make_mesh(model_parallel=2)
    with torch.inference_mode():
        x, aux = sharded.ep_trunk(module.encoder, parallel.shard_batch(inp["x"], mesh), dims,
                                  inp["moe_small"], dims.n_audio_ctx, mesh)
    out["ep"], out["ep_aux"] = x, float(aux)
    out["ep_index"] = (mesh.index("data"), mesh.index("model"))
    # moe_encoder_apply at (1, 4), experts sharded by shard_params
    mesh4 = parallel.make_mesh(model_parallel=4)
    parallel.shard_params(module, mesh4)
    out["expert_rows"] = tuple(module.encoder.blocks[0].mlp.experts.fc.weight.shape)
    with torch.inference_mode():
        y, aux = moe.moe_encoder_apply(module.encoder, inp["mel"], dims, cfg, mesh=mesh4)
    out["apply"], out["apply_aux"] = y, float(aux)
    return out


def _whole_grads(module, loss, mesh) -> dict:
    """Every trainable parameter's gradient of this rank's ``loss``, summed
    over the data ranks and whole."""
    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.train.step import reduce_gradients

    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named], materialize_grads=True)
    layout = parallel.param_layout(module)
    lay = [layout.get(n, (None, None)) for n, _ in named]
    grads = reduce_gradients(grads, lay, mesh)
    return {n: parallel.full_tensor(g, lt, mesh) for (n, _), g, lt in zip(named, grads, lay)}


def _trained_encoder(sd, dims):
    enc = _encoder(sd, dims)
    return enc.train().requires_grad_(True)


def _whisper(sd, dims):
    from qasr_ijcnlp_tpu_torch.models.whisper import Whisper

    m = Whisper(dims)
    m.load_state_dict(sd)
    return m


def _clone(sd: dict) -> dict:
    return {k: v.clone() for k, v in sd.items()}


def _slice_shares(module, state, mesh) -> dict:
    """{name: (param, mu, nu) element counts on this rank over the whole
    leaf's} of every sliced leaf."""
    from qasr_ijcnlp_tpu_torch import parallel

    layout = parallel.param_layout(module)
    named = dict(module.named_parameters())
    opt = state.opt_state
    out = {}
    for n, mu, nu in zip(opt["names"], opt["mu"], opt["nu"]):
        if n in layout:
            whole = parallel.full_tensor(named[n].detach(), layout[n], mesh).numel()
            out[n] = (named[n].numel() / whole, mu.numel() / whole, nu.numel() / whole)
    return out


def scenario_train(inp: dict, rank: int) -> dict:
    import torch.distributed as dist

    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.models import moe, whisper as w
    from qasr_ijcnlp_tpu_torch.ops.conv_stem import _plain_stem
    from qasr_ijcnlp_tpu_torch.parallel import sharded
    from qasr_ijcnlp_tpu_torch.train import checkpoint as ck, distill, step as st

    out: dict = {}
    dims, sd, mel, tokens = inp["dims"], inp["sd"], inp["mel"], inp["tokens"]
    T = dims.n_audio_ctx
    # the trunks' loss: sum(out * proj) over this data rank's rows
    sq = lambda y, mesh: torch.sum(y.float() * parallel.shard_batch(inp["grad_proj"], mesh))
    # every mesh of the scenario, built in the same order on every rank
    mesh22 = parallel.make_mesh(model_parallel=2)
    mesh14 = parallel.make_mesh(model_parallel=4)
    mesh41 = parallel.make_mesh(model_parallel=1)
    mesh_pp = parallel.make_mesh(model_parallel=2, group=[0, 1])

    # -- trunk gradients: TP (2, 2), SP (1, 4), PP (1, 2) on ranks 0 and 1
    gm = inp["grad_mel"]
    enc = parallel.shard_params(_trained_encoder(inp["enc_sd"], dims), mesh22)
    y = w.encoder_apply(enc, parallel.shard_batch(gm, mesh22), dims, mesh=mesh22)
    out["tp_grads"] = _whole_grads(enc, sq(y, mesh22), mesh22)
    enc = parallel.shard_params(_trained_encoder(inp["enc_sd"], dims), mesh14)
    out["sp_applicable"] = (sharded.tp_trunk_applicable(dims, mesh14, len(gm)),
                            sharded.sp_trunk_applicable(dims, mesh14, len(gm), T))
    out["sp_grads"] = _whole_grads(
        enc, sq(w.encoder_apply(enc, gm, dims, mesh=mesh14), mesh14), mesh14)
    if mesh_pp.member:
        enc = _trained_encoder(inp["enc_sd"], dims)
        x = _plain_stem(enc, gm, T, torch.float32)
        y = sharded.pp_trunk(enc, x, dims, T, mesh_pp, n_micro=2)
        out["pp_grads"] = _whole_grads(enc, sq(y, mesh_pp), mesh_pp)

    # -- one sharded step under each layout, every rank the global batch
    tx = st.make_optimizer(1e-3)
    for name, mesh, fsdp, accum in (("tp", mesh22, False, 1), ("fsdp", mesh41, True, 1),
                                    ("fsdp_tp", mesh22, True, 1),
                                    ("fsdp_accum", mesh41, True, 2), ("sp", mesh14, False, 1)):
        module = _whisper(sd, dims)
        state = st.shard_state(st.init_state(module, tx), mesh, fsdp=fsdp, fsdp_min_size=128)
        if accum > 1:
            body = st.make_accum_train_step(st.whisper_sum_loss_fn(dims), tx, accum)
            step = st.make_sharded_train_step(None, tx, mesh, step_fn=body)
        else:
            step = st.make_sharded_train_step(st.whisper_loss_fn(dims), tx, mesh)
        state, m = step(state, mel, tokens)
        out[f"step_{name}"] = {k: float(v) for k, v in m.items()}
        out[f"params_{name}"] = parallel.full_state_dict(module)
        out[f"shares_{name}"] = _slice_shares(module, state, mesh)

    # -- a non-finite batch on one data rank: every rank skips
    module = _whisper(sd, dims)
    state = st.shard_state(st.init_state(module, tx), mesh22)
    before = _clone(parallel.full_state_dict(module))
    bad = mel.clone()
    bad[len(bad) // 2:] = float("nan")  # data rank 1's rows
    state, m = st.make_sharded_train_step(st.whisper_loss_fn(dims), tx, mesh22)(
        state, bad, tokens)
    out["nan_skipped"] = int(m["skipped"])
    out["nan_unchanged"] = all(torch.equal(v, before[k])
                               for k, v in parallel.full_state_dict(module).items())
    out["nan_count"] = int(state.opt_state["count"])

    # -- checkpoints: an FSDP state saved whole, restored on the mesh and on one rank
    tmp = inp["tmp"]
    path = os.path.join(tmp, "fsdp_state")
    module = _whisper(sd, dims)
    state = st.shard_state(st.init_state(module, tx), mesh41, fsdp=True, fsdp_min_size=128)
    step = st.make_sharded_train_step(st.whisper_loss_fn(dims), tx, mesh41)
    state, _ = step(state, mel, tokens)
    ck.save_train_state(path, state)
    out["saved_params"] = _clone(parallel.full_state_dict(module))
    state, after = step(state, mel, tokens)
    out["after_loss"] = float(after["loss"])
    resumed = {}
    for kind in ("fresh", "sliced"):
        m2 = _whisper(sd, dims)
        tmpl = st.init_state(m2, tx)
        if kind == "sliced":  # a template already on the mesh keeps its layout
            tmpl = st.shard_state(tmpl, mesh41, fsdp=True, fsdp_min_size=128)
        restored = ck.restore_train_state(path, tmpl, mesh=mesh41, fsdp=True)
        out[f"restored_shares_{kind}"] = _slice_shares(m2, restored, mesh41)
        restored, r = step(restored, mel, tokens)
        resumed[kind] = float(r["loss"])
    out["resumed_loss"] = resumed
    one = _whisper(sd, dims)
    restored = ck.restore_train_state(path, st.init_state(one, tx))
    out["one_rank_params"] = {k: v.clone() for k, v in one.state_dict().items()}
    out["one_rank_step"] = int(restored.step)
    # a one-rank state restored on a (2, 2) FSDP x TP mesh
    path1 = os.path.join(tmp, "one_rank_state")
    if rank == 0:
        ck.save_train_state(path1, restored)
    dist.barrier()
    m3 = _whisper(sd, dims)
    onto = ck.restore_train_state(path1, st.init_state(m3, tx), mesh=mesh22, fsdp=True)
    out["onto_mesh_params"] = parallel.full_state_dict(m3)
    out["onto_mesh_layout"] = parallel.param_layout(m3)
    out["onto_mesh_count"] = int(onto.opt_state["count"])

    # -- the expert-parallel step at (2, 2)
    cfg = moe.MoEConfig(**inp["moe_cfg"])
    module = moe.moe_whisper_from_state_dict(inp["moe_sd"], inp["moe_dims"], cfg,
                                             "cpu").requires_grad_(True)
    state = st.shard_state(st.init_state(module, tx), mesh22)
    out["ep_applicable"] = sharded.ep_trunk_applicable(
        inp["moe_dims"], cfg, mesh22, len(inp["moe_mel"]) // 2, inp["moe_dims"].n_audio_ctx)
    step = st.make_sharded_train_step(moe.moe_whisper_loss_fn(inp["moe_dims"], cfg), tx,
                                      mesh22)
    state, m = step(state, inp["moe_mel"], inp["moe_tokens"])
    out["ep_loss"] = float(m["loss"])
    out["ep_params"] = parallel.full_state_dict(module)

    # -- one sharded distillation step at (2, 2), the teacher sharded too
    teacher = parallel.shard_params(_whisper(inp["teacher_sd"], dims).requires_grad_(False),
                                    mesh22)
    student = _whisper(sd, dims)
    dtx = st.make_optimizer(1e-3, weight_decay=1e-4, clip_norm=None)
    state = st.shard_state(st.init_state(student, dtx), mesh22)
    step = st.make_sharded_train_step(distill.distill_loss_fn(dims, dims), dtx, mesh22)
    state, m = step(state, teacher, mel, tokens)
    out["distill_loss"] = float(m["loss"])
    out["distill_params"] = parallel.full_state_dict(student)

    # -- the trainer CLI on the four ranks, one epoch each
    out["cli"] = _cli_runs(inp["cli"], rank)
    return out


def _cli_runs(cli: dict, rank: int) -> dict:
    import json

    import torch.distributed as dist

    from qasr_ijcnlp_tpu_torch.cli import train_classical_whisper_asr as ttc
    from qasr_ijcnlp_tpu_torch.data import SyntheticLibriSpeech
    from qasr_ijcnlp_tpu_torch.models import whisper as w

    ttc.dims_for = lambda name: cli["dims"]
    ttc.load_librispeech = lambda split, n: SyntheticLibriSpeech(split, n)
    init = w.init_params
    w.init_params = lambda gen, dims: {k: v.clone() for k, v in cli["sd"].items()}
    out = {}
    here = os.getcwd()
    try:
        for name, flags in (("tp", ["--model_parallel", "2"]), ("fsdp", ["--fsdp"])):
            run_dir = os.path.join(cli["tmp"], name)
            os.makedirs(run_dir, exist_ok=True)
            dist.barrier()
            os.chdir(run_dir)
            ttc.main(cli["argv"] + flags)
            dist.barrier()
            hist = "classical_whisper_asr_training_history.json"
            with open(hist) as f:
                out[name] = json.load(f)
            out[name + "_files"] = sorted(os.listdir(run_dir))
            os.chdir(here)
    finally:
        w.init_params = init
        os.chdir(here)
    return out


def scenario_card_collectives(inp: dict, rank: int) -> dict:
    """Every collective's forward and backward on CUDA tensors (gloo on one
    card) and on CPU tensors, from the same values, over a (1, 2) mesh."""
    from qasr_ijcnlp_tpu_torch import parallel

    mesh = parallel.make_mesh(model_parallel=2)
    g = torch.Generator().manual_seed(rank)
    x0 = torch.randn(2, 3, 4, generator=g)
    ops = {
        "psum": lambda x: parallel.psum(x, mesh, "model"),
        "psum_mesh": lambda x: parallel.psum(x, mesh, None),
        "to_model_region": lambda x: parallel.to_model_region(mesh, x)[0] * (rank + 1),
        "all_gather": lambda x: parallel.all_gather(x, mesh, "model", 1) * (rank + 1),
        "all_gather_slice": lambda x: parallel.all_gather(x, mesh, "model", 1, grad="slice"),
        "all_to_all": lambda x: parallel.all_to_all(x, mesh, "model") * (rank + 1),
        "shift_next": lambda x: parallel.shift_next(x, mesh, "model") * (rank + 1),
        "gather_leaves": lambda x: torch.cat([t.reshape(-1) for t in parallel.gather_leaves(
            [x, x * 2], [0, None], mesh, "model", region=True)]) * (rank + 1),
    }
    out = {}
    for dev in ("cpu", "cuda"):
        for name, op in ops.items():
            x = x0.to(dev).requires_grad_(True)
            y = op(x)
            cot = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape).to(dev)
            grad, = torch.autograd.grad(y, x, cot)
            out[(dev, name)] = (y.detach().cpu(), grad.cpu())
    return out


def scenario_card_tp_step(inp: dict, rank: int) -> dict:
    """The tensor-parallel (1, 2) trunk's gradients on the card (K4
    head-sharded, f32) with the kernels on and off: every parameter's
    gradient of the global loss, this rank's slices."""
    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.models import whisper as w
    from qasr_ijcnlp_tpu_torch.ops import encoder_block
    from qasr_ijcnlp_tpu_torch.parallel import sharded
    from qasr_ijcnlp_tpu_torch.train import step as st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = inp["dims"]
    mesh = parallel.make_mesh(model_parallel=2)
    out = {"kernel": sharded.tp_uses_kernel(dims, mesh, dims.n_audio_ctx)}
    mel, tokens = inp["mel"].cuda(), inp["tokens"].cuda()
    for name, flash in (("on", None), ("off", False)):
        w.set_flash_attention(flash)
        try:
            module = _whisper(inp["sd"], dims).cuda()
            parallel.shard_params(module, mesh)
            before = encoder_block.attn_launches
            with parallel.use_mesh(mesh):
                loss = st.whisper_loss_fn(dims)(module, mel, tokens)
            out[f"k4_{name}"] = encoder_block.attn_launches - before
            named = list(module.named_parameters())
            grads = torch.autograd.grad(loss, [p for _, p in named])
            out[name] = {n: g.cpu() for (n, _), g in zip(named, grads)}
            out[f"loss_{name}"] = float(loss)
        finally:
            w.set_flash_attention(None)
    return out


SCENARIOS = {"parallel": scenario_parallel, "moe": scenario_moe, "train": scenario_train,
             "card_collectives": scenario_card_collectives,
             "card_tp_step": scenario_card_tp_step}


def main():
    import torch.distributed as dist

    import faulthandler

    scenario, tmp, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    if "QASR_RANK_DEADLINE" in os.environ:
        faulthandler.dump_traceback_later(float(os.environ["QASR_RANK_DEADLINE"]), exit=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = SCENARIOS[scenario](inputs, rank)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
