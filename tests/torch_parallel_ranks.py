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
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
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


SCENARIOS = {"parallel": scenario_parallel, "moe": scenario_moe}


def main():
    import torch.distributed as dist

    scenario, tmp, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
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
