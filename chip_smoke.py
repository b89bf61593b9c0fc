#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's request path (qasr_ijcnlp_tpu_torch) once at the full
width of Whisper tiny with random weights from a seed:

1. device lines: the card's name and power limit, torch/CUDA versions,
   whether ``regex`` imports;
2. builds the hand-written kernels from ``qasr_ijcnlp_tpu_torch/csrc`` and
   prints the nvcc command, its time and the ptxas register/smem lines;
3. per kernel (K1 mel, K2 stem, K4 attention, K5 finish) at the main path's
   shapes (B=8 clips of 30 s: mel (8, 80, 3000), trunk (8, 1536, 384),
   t_real 1500): kernel vs its plain PyTorch version on the card in f32 and
   bf16 (K1 is f32 only, as in the reference), max abs error against the
   stated tolerance, and both times from CUDA events after warm-up;
4. end to end in f32: 16 requests of seeded synthetic 30-s PCM through
   ``log_mel_spectrogram`` -> ``decode`` with the bench options; every
   kernel's launch count must have risen, and two requests must give
   exactly the tokens of the same model run on the CPU (plain path);
5. end to end in bf16: token agreement with f32, and wall time per batch at
   B=16 and B=64 (host clock ending in a synchronize) as audio-s/s;
6. prints the per-kernel JSON line, then ``{"ok": true, "device": ...}`` as
   the last line.

Any failure raises (non-zero exit) and nothing is printed as a result.  There
is no CPU fallback: without a CUDA device the script exits non-zero at once.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BENCH_OPTIONS = dict(language="en", without_timestamps=True, sample_len=64,
                     suppress_blank=False)
EOT = 50257
# Max abs error allowed between a kernel and its plain version on the card.
# f32: both sides are fp32 FMA products summed in different orders (and the
# plain stem goes through cuDNN), on O(1) values with K <= 1536.  bf16: the
# bound of tests/test_encoder_block.py (0.08) for rounding-order differences
# of bf16 intermediates, plus 2 bf16 ulps relative (2^-7 |x|) for the
# larger residual-stream values of the full-width model.  K1 is compared
# after the clamp and scaling, at the repo's mel bound (tests/test_ops.py).
TOL = {"f32": 1e-4, "bf16": 0.08, "bf16_rel": 2.0 ** -7, "mel": 2e-4}


def log(*a):
    print(*a, flush=True)


def device_lines():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    try:
        import regex  # noqa: F401

        log("regex: importable")
    except ImportError:
        log("regex: not installed (decode needs none; prompt/prefix encoding does)")
    return smi


def build_kernels():
    from qasr_ijcnlp_tpu_torch import _kernels

    lib = _kernels.library()
    log("build:", " ".join(lib.command))
    log(f"build seconds: {lib.build_seconds:.1f}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line:
            log("  " + line.strip())
    return lib


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, dtype, kernel_fn, plain_fn, tol_key):
    k = kernel_fn()
    p = plain_fn()
    torch.cuda.synchronize()
    if k.shape != p.shape or not torch.isfinite(k).all():
        raise AssertionError(f"{name} {dtype}: bad shape or non-finite output")
    diff = (k.float() - p.float()).abs()
    err = float(diff.max())
    if tol_key == "bf16":
        excess = float((diff - TOL["bf16"] - TOL["bf16_rel"] * p.float().abs()).max())
        ok = excess <= 0
        tol_txt = f"{TOL['bf16']} + {TOL['bf16_rel']}*|plain|"
    else:
        ok = err <= TOL[tol_key]
        tol_txt = str(TOL[tol_key])
    ms = cuda_ms(kernel_fn)
    plain_ms = cuda_ms(plain_fn)
    log(f"{name} {dtype}: max_abs_err {err:.3e} (tol {tol_txt}) kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms")
    if not ok:
        raise AssertionError(f"{name} {dtype}: error {err} outside tolerance {tol_txt}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_phase(model, dev):
    from qasr_ijcnlp_tpu_torch.ops import conv_stem, encoder_block, melfront

    rng = np.random.default_rng(SEED)
    B, dims = 8, model.dims
    T, Tp, D, H = dims.n_audio_ctx, 1536, dims.n_audio_state, dims.n_audio_head
    enc = model.module.encoder
    blk = enc.blocks[0]
    pcm = torch.from_numpy((rng.standard_normal((B, 480000)) * 0.1).astype(np.float32)).to(dev)
    mel = torch.from_numpy(rng.standard_normal((B, 80, 3000)).astype(np.float32)).to(dev)
    x32 = torch.from_numpy(rng.standard_normal((B, Tp, D)).astype(np.float32)).to(dev)
    res = {}

    padded = melfront.reflect_pad(pcm)
    res["K1"] = {"f32": compare(
        "K1 mel", "f32",
        lambda: melfront.clamp_and_scale(melfront.log10_mel(padded)),
        lambda: melfront.clamp_and_scale(melfront._plain_log10_mel(padded, 80)),
        "mel")}
    for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = x32.to(dt)
        attn = encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T)
        res.setdefault("K2", {})[key] = compare(
            "K2 stem", key, lambda: conv_stem.fused_conv_stem(enc, mel, Tp, dt),
            lambda: conv_stem._plain_stem(enc, mel, Tp, dt), key)
        res.setdefault("K4", {})[key] = compare(
            "K4 attention", key,
            lambda: encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, T),
            lambda: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T), key)
        res.setdefault("K5", {})[key] = compare(
            "K5 finish", key, lambda: encoder_block.fused_block_finish(x, attn, blk),
            lambda: encoder_block._plain_finish(x, attn, blk), key)
    return res


def synthetic_pcm(n, seed):
    """Seeded 30-s clips: a few tones under noise, different per clip."""
    rng = np.random.default_rng(seed)
    t = np.arange(480000, dtype=np.float32) / 16000
    out = np.empty((n, 480000), np.float32)
    for i in range(n):
        f = rng.uniform(100, 3000, size=3)
        tones = sum(np.sin(2 * np.pi * fi * t) for fi in f) * 0.05
        out[i] = tones + rng.standard_normal(480000).astype(np.float32) * 0.02
    return out


def run_requests(port, model, pcm, fp16):
    opts = port.DecodingOptions(fp16=fp16, suppress_tokens=[EOT], **BENCH_OPTIONS)
    mel = port.log_mel_spectrogram(pcm, device=model.device)
    return port.decode(model, mel, opts)


def check_results(results, n, D):
    if len(results) != n:
        raise AssertionError(f"expected {n} results, got {len(results)}")
    for r in results:
        if len(r.tokens) != BENCH_OPTIONS["sample_len"] or not np.isfinite(r.avg_logprob):
            raise AssertionError(f"bad result: {len(r.tokens)} tokens, {r.avg_logprob}")
        if r.audio_features.shape != (1500, D) or not torch.isfinite(r.audio_features).all():
            raise AssertionError("bad audio features")


def time_batch(port, model, pcm, fp16, repeats=3):
    run_requests(port, model, pcm, fp16)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        run_requests(port, model, pcm, fp16)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / repeats
    return dt, pcm.shape[0] * 30.0 / dt


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this "
                         "check runs only on an NVIDIA GPU")
    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params
    from qasr_ijcnlp_tpu_torch.ops import conv_stem, encoder_block, melfront

    # TF32 off for every plain fp32 product and convolution on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = device_lines()
    build_kernels()

    dims = tiny_dims()
    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    gpu_model = port.WhisperModel.from_state_dict(sd, dims, dev, name="tiny (random)")
    cpu_model = port.WhisperModel.from_state_dict(sd, dims, "cpu", name="tiny (random)")

    with torch.inference_mode():
        kres = kernel_phase(gpu_model, dev)

    # -- end to end, f32 ----------------------------------------------------
    pcm16 = synthetic_pcm(16, SEED)
    counters = {"K1": (melfront, "launches"), "K2": (conv_stem, "launches"),
                "K4": (encoder_block, "attn_launches"),
                "K5": (encoder_block, "finish_launches")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    res32 = run_requests(port, gpu_model, pcm16, fp16=False)
    torch.cuda.synchronize()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    log("main-path launches (f32, 16 requests):", json.dumps(launches))
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    check_results(res32, 16, dims.n_audio_state)

    cpu_res = run_requests(port, cpu_model, pcm16[:2], fp16=False)
    for i in range(2):
        if cpu_res[i].tokens != res32[i].tokens:
            raise AssertionError(f"request {i}: GPU f32 tokens differ from the CPU "
                                 f"plain path:\n{res32[i].tokens}\n{cpu_res[i].tokens}")
    log("f32 tokens identical to the CPU plain path for requests 0, 1")
    log("request 0 text:", repr(res32[0].text[:120]))

    # -- end to end, bf16, and wall time --------------------------------------
    res16 = run_requests(port, gpu_model, pcm16, fp16=True)
    check_results(res16, 16, dims.n_audio_state)
    same = sum(a == b for r, s in zip(res32, res16) for a, b in zip(r.tokens, s.tokens))
    total = sum(len(r.tokens) for r in res32)
    log(f"bf16 vs f32 token agreement: {same}/{total} = {same / total:.4f}")
    pcm64 = np.concatenate([pcm16] * 4)
    for B, pcm in ((16, pcm16), (64, pcm64)):
        for fp16 in (True, False):
            sec, rate = time_batch(port, gpu_model, pcm, fp16)
            log(f"end to end B={B} {'bf16' if fp16 else 'f32'}: {sec * 1000:.1f} ms/batch, "
                f"{rate:.1f} audio-s/s ({smi})")

    sources = {"K1": ("mel", "qasr_ijcnlp_tpu_torch/csrc/melfront.cu",
                      "qasr_ijcnlp_tpu/ops/melfront.py:48"),
               "K2": ("conv_stem", "qasr_ijcnlp_tpu_torch/csrc/conv_stem.cu",
                      "qasr_ijcnlp_tpu/ops/conv_stem.py:82"),
               "K4": ("encoder_attention", "qasr_ijcnlp_tpu_torch/csrc/encoder_block.cu",
                      "qasr_ijcnlp_tpu/ops/encoder_block.py:148"),
               "K5": ("encoder_finish", "qasr_ijcnlp_tpu_torch/csrc/encoder_block.cu",
                      "qasr_ijcnlp_tpu/ops/encoder_block.py:238")}
    kernels = []
    for k, (name, src, rep) in sources.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": launches[k], **kres[k]["f32"]}
        if "bf16" in kres[k]:
            entry.update({f"bf16_{key}": v for key, v in kres[k]["bf16"].items()})
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
