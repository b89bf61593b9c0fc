#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --stem            # K1 and the stem alone (and the encoder stage)
    python3 chip_smoke.py --k9 [--stages]   # K9 alone (and the int8 decode stages)
    python3 chip_smoke.py --k10 [--stages]  # K10 alone (and the fused decode stages)
    python3 chip_smoke.py --attn            # K4, K7, K8 alone, with output digests
    python3 chip_smoke.py --diag            # K11 and K12 alone (the diagnostics)
    python3 chip_smoke.py --longform        # the long-form paths alone (tiny, large-v3)
    python3 chip_smoke.py --services        # the decode services alone (engine, speculative, HTTP)
    python3 chip_smoke.py --quantum         # the source paper's model alone (quantum, char ASR)
    python3 chip_smoke.py --train           # training and the classical evaluation CLIs alone
    python3 chip_smoke.py --export          # deployment artifacts alone (tiny, large-v3)
    python3 chip_smoke.py --distill         # distillation, the from-scratch step, the new CLIs
    python3 chip_smoke.py --parallel        # K4 head-sharded and the sharded paths, ranks on cuda:0

Drives the port's request path (qasr_ijcnlp_tpu_torch) at the full width of
three Whisper sizes and of two head geometries at small's width, with random
weights from a seed and seeded synthetic 30-s PCM, through its three
decode-loop paths (the fp cross cache, the int8 cross cache of ``kv_int8``
and the opt-in fused step) and its grouped decodes (beam search, best-of):

1. device lines: the card's name and power limit, torch/CUDA versions,
   whether ``regex`` imports;
2. builds the hand-written kernels from ``qasr_ijcnlp_tpu_torch/csrc`` (one
   nvcc per source, all at once) and prints the commands, the time and the
   ptxas register, smem and spill lines;
3. **tiny** (4 + 4 layers, D 384): per kernel (K1 mel, K2 stem, K4
   attention, K5 finish) at B=8 (mel (8, 80, 3000), trunk (8, 1536, 384),
   t_real 1500), kernel vs its plain PyTorch version on the card in f32 and
   bf16 (K1 is f32 only, as in the reference; K1 to K8 run on the tensor
   cores, so their bound counts f32 products as three TF32 products at 495
   TFLOP/s; each stem row prints beside it its two ``F.conv1d`` calls
   alone, cuDNN with TF32 off, as context); the int8 cross attention
   (K9) at B=16, 6 heads, and the fused decoder layer (K10) at B=16 and
   B=64 and at base's width (D 512, B=8), each K10 row timed by CUDA-graph
   replay cold (rotating over >= 128 MB of distinct inputs) and hot, beside
   its eager time; then 16 requests end to end in
   f32 (every kernel must launch, K8 never; two requests must give exactly
   the CPU plain path's tokens), bf16 token agreement, and wall time at B=16
   and B=64, with one more batch split into its stages (log-mel, encoder,
   decode); then one counted f32 batch of 16 with ``kv_int8`` (K9 exactly
   4 x 64 times), and the fused step (``set_fused_decoder_step(True)``) at
   B=16 and B=64 (K10 exactly 4 x 63 times per batch, requests 0 and 1
   teacher-forced against the CPU plain path within K10's f32 parity
   tolerance, times and stages in f32 and bf16); then, with the fused step
   still switched on, beam_size 5 (and patience 2.0) at B=16, tokens of
   requests 0 and 1 equal to the CPU plain path's, and best_of 5 at T 0.5
   from a seeded generator (two calls equal; each result ``rank_group``'s
   choice of its group), K10 never launched, times and stages; then the
   long-form path (``transcribe``) with ``batch_windows`` and word
   timestamps over a seeded speech-like 5-min file (ten windows in one
   batch): K1 at the file's length against its plain version, then f32
   and bf16 runs with exact launch counts (K1 once per file, the stem once
   and K4 / K5 once a layer per encoder pass, the bf16 run's f32
   re-encodes for the alignment included), the f32 transcript equal to the
   CPU plain path's and its word times within tests/test_align.py's rule,
   and the stages of each run (file mel, window decodes, alignment, host
   assembly; audio-s/s);
4. **medium** (24 + 24 layers, D 1024, full depth): the stem at D 1024 (K3),
   K4 with 16 heads, the finish at D 1024 (K6) and the whole 24-layer trunk
   (8, 1536, 1024) against their plain versions, and the fused block's
   tensor-core GEMM alone at its four products (QKV, out-projection, fc,
   proj over 12,288 rows) beside ``torch.matmul`` in f32 and bf16; then a batch of 8 end to
   end in f32 and bf16 (wall time and stages), where the stem, K4 and the
   finish must launch and K8 never;
5. **large-v3** (D 1280, 128 mels, vocab 51866; the kernel rows at full
   width, the end-to-end paths at LARGE_PATH_LAYERS of its 32 + 32 layers,
   a depth cut that keeps the whole run within its time limit):
   K1 at 128 mels, the stem at D 1280, K8 on (8, 1536, 1280) with 20 heads
   and t_real 1500 (timed beside ``scaled_dot_product_attention`` as its
   library yardstick), and K9 at B=8, 20 heads, for one query row (a step)
   and four (the prompt), and at G=5 (five beam rows per request), each
   K9 row timed cold (rotating over >= 128 MB of distinct caches, as the
   decode loop reads each layer's cache from device memory: ``ms``) and
   hot (one cache in L2: ``hot_ms``); then a
   batch of 8 end to end, where K1 and the stem must launch, K8 exactly
   once a layer, K4 and the finish never; then the same batch with
   ``kv_int8`` in f32 and bf16 (K9 exactly once a layer a token), request 0 teacher-forced
   against the CPU plain int8 path, int8 vs fp token agreement and
   avg_logprob gap, times and stages; then beam_size 5 (40 hypothesis rows
   over a cross cache of 8), fp and int8 (K9 at G=5 once a layer a token,
   K10 never), request 0 against the CPU plain path's beam (equal, or a
   near tie where they diverge), int8 vs fp avg_logprob gap, bf16, times
   and stages; then the sequential long-form loop with word timestamps on
   a 55-s file (three windows, the last partial) in f32 and bf16 (K8
   exactly once a layer per encoder pass), every f32 window teacher-forced
   against the CPU plain path under its own options (prompt, timestamp
   rules) and window 0's alignment matrix, words and times held against
   the CPU's.
   In every kernel phase the padding rows of the trunk inputs are one
   repeated row, as the trunk leaves them, and bf16 is held to twice the
   plain bf16 version's own distance from f32 (``compare``).  Two rounding
   probes (medium: K4, large-v3: K8) check in bf16, bit for bit, the one
   rounding point where K4 and K8 differ;
6. **small-h96** (small's 12 + 12 layers and D 768, the encoder in 8 heads
   of 96, which neither fuse nor pack): K7 (the 4D attention) on (8, 8,
   1536, 96) head views and on an odd count of 64-wide heads (8, 5, 1536,
   64), t_real 1500, timed beside SDPA; then a batch of 8 end to end, where
   K7 must launch exactly 12 times and K4, the finish and K8 never;
7. **small-h128** (small with 6 heads of 128 in encoder and decoder): K4 at
   (8, 1536, 768) with heads of 128, K8 at heads of 128 (8, 1536, 1280) and
   32 (8, 1536, 384), K9 at q (8, 1, 768) over codes (8, 6, 1536, 128);
   then a batch of 8 end to end (K4 and the finish exactly 12 times each,
   K7 and K8 never) and again with ``kv_int8`` (K9 exactly 12 x 64 times),
   as for large-v3;
8. **K11**, the attention core's diagnostic split (``diagnostics.
   attn_parts``): its three modes against their plain versions at B=8 in
   bf16 (bounds with one exponential per pair for softmax and full, at the
   card's special-function rate), then the diagnostic's own run at the TPU
   script's B=512 (no plain version there: its fp32 logits would take 29
   GB), counted like a path; then **K12**, the decode step's
   cross-attention formulations (``diagnostics.step_formulations``): dma,
   vpu, mxu_t and mxu_r against their plain versions at the TPU script's
   B=64 (bf16; dma's output fp32), SDPA timed beside the attention modes,
   the attention modes also on wide inputs N(0, 0.5^2) and on peaked ones
   (one position per row and head planted 6 above the row's other logits
   in the last split), then the diagnostic's own run counted like a path
   (K12 exactly 4 x 21 times: a warm-up and 20 launches captured in a CUDA
   graph, whose replays are timed);
9. for medium, large-v3 and the small geometries, request 0's f32 tokens
   are checked against the CPU plain path (log-mel, encoder and decoder on
   the CPU), teacher-forced on the card's tokens: at every step the card's
   token must be the CPU's argmax or within a stated tie of its top logit;
   the smallest top-2 margin is printed;
10. the decode services, each at full width and depth with exact launch
   counts from the run's own admissions, steps and rounds, and every
   result against the port's own decode of the same request on the card
   (equal f32 tokens, or the CPU teacher-forced check where a request
   differs): large-v3 behind a ``DecodeEngine`` of 8 slots (unroll 4, the
   audio front end: K1 and K8 at each admission), 12 requests from threads
   in two waves, in f32, f32 ``kv_int8`` (K9 in every step) and bf16, with
   per-request latency and the stage split (CUDA events); medium
   as the speculative target of a tiny draft (B=8, gamma 4, f32; and on
   the int8 cross cache, K9 over the 5-row verify slab), tiny with itself
   as draft and with prompt lookup (rounds, tokens per round, draft and
   verify device time beside plain greedy); tiny behind a beam pool (beam
   5, 4 groups, 6 requests); ``serving.serve`` at tiny on 127.0.0.1 (4
   requests on the engine route, 2 on a micro-batch server, a 40-s
   long-form request through the long-form pool, an online session in 1-s
   chunks through the session pool, ``/metrics``; the routes counted
   alone, before any direct call); and, for large-v3 and tiny, the greedy
   loop's body timed with the position as a host int and as a per-row
   tensor;
11. the source paper's model: (a) quantum tiny at full width (D 384, 4 +
   4 layers, 4 qubits), 16 requests end to end in f32 and bf16 with
   exact launches (K1 once, the classical stem kernel never, K4 = K5 =
   4), requests 0 and 1 against the CPU plain path, times, the stage
   split by CUDA events (mel, quantum stem, trunk, decode) and the stem
   alone beside its bound and beside K2 on the same mel; (b) a quantum
   large-v3 encoder pass at B=2 (its quantum stem against the CPU's, K8
   exactly 32 times, the stem kernel and K4 never); (c) char ASR
   evaluation at quantum tiny over 16 synthetic LibriSpeech items (LSTM
   head, MLP head teacher-forced and decoding; each card char within
   1e-4 of the CPU's top logit); (d) both evaluation CLIs in this
   process with ``--device cuda`` on a numpy-pickle checkpoint written
   here (the classification CLI on classical tiny and on quantum tiny);
12. training (``--train``): (a) one step of the quantum tiny char-ASR model
   (LSTM head, B=8, f32; trainable: the quantum layers and the head) and
   of the classical tiny token model on the card and on the CPU plain
   path from equal weights and batch: the loss, every trainable gradient
   (none missing, finite) and each update against the CPU's, the frozen
   trunk bit-identical, the forward's kernels counted and none in the
   backward; (b) the three trainer CLIs with ``--device cuda`` from a
   temporary directory (2 epochs over 16 synthetic items; the token
   trainer with ``--grad_accum 2 --remat``): exact K1, stem, K4 and K5
   counts, checkpoints, finite histories with no skipped batch, then the
   token trainer resumed from its epoch-1 state for a third epoch (the
   step count carries on); (c) token train steps at large-v3's full width
   and depth (B=2, f32, remat: the stem once, K8 32 + 32 times a step),
   step times and peak memory, the loss against the kernels-off path's;
   (d) the tiny token step from PCM at B=8 in f32 and bf16 with the
   kernels on and off (``set_flash_attention(False)`` +
   ``set_fused_mel(False)``), in turns, median of 3; (e) the two classical
   evaluation CLIs at tiny (16 items at B=16; ``transcribe`` on 4, no
   failure sentinel);
13. deployment artifacts (``--export``): large-v3 at B=8, f32,
   from 30-s PCM, exported with its kernels (K1 at 128 bins, the stem and
   K8 as ``qasr::`` ops) and called without saving, token-exact against the
   live decode with the live path's launches; tiny at B=8 (64 tokens): a
   kernel-free fp artifact (against the live decode with the kernels off),
   a kernels fp and a kernels int8 artifact (against the live decode, and
   the live decode of the dequantized weights), each saved and loaded, with
   export, save and load seconds, file sizes, call time beside the live
   decode's (CUDA events) and the kernels artifact's device time and
   launches (``torch.profiler``); prompt encoding with the native BPE core
   and in pure Python.  The exporting processes (``--export-child``,
   ``--export-large``, the export CLI) trace on the host while this process
   runs the earlier paths (the full run starts them just after the build);
   large-v3's does its device work only when handed the card;
14. distillation (``--distill``): ``distill_draft`` with a
   medium teacher and a tiny draft (B=8, 48 tokens, 6 steps, counted),
   each step's KL against the same step on the kernels-off plain path,
   ms a step, the agreement before and after, and the draft under medium's
   speculative decode, token-exact; one step of the from-scratch model (8
   qubits, nothing frozen) card against CPU; the three new CLIs
   (``distill_draft``, ``train_whisper_from_scratch``, ``export_decode``,
   whose artifact is called over 16 items) with ``--device cuda``;
15. parallelism (``--parallel``): K4 head-sharded alone at the Dl of each
   tensor-parallel case (512, 640, 384, 256), f32 and bf16, against its
   plain version, and its tp shards side by side against the full-width
   launch bit for bit; then four rank processes on cuda:0 over gloo (started
   just after the build, handed the card here): the medium, large-v3 and
   small-h128 encoders (full width and depth, B=8) head-sharded over (1, 2)
   ranks and medium over (1, 4), against the single-rank kernel encoder,
   with exact launches per rank (the stem once, K4 once a layer, K5/K6 and
   K8 never); tiny's trunk sequence-parallel over (1, 4) and pipelined over
   (1, 2) and a tiny MoE trunk expert-parallel over (1, 2), each against its
   single-rank form; tiny greedy decode of 16 requests data-parallel over 2
   ranks with the fused step on (K10 never), token-exact against the
   single-rank decode; the data-parallel engine (8 slots over 2 ranks, 12
   requests) token-exact per request against the single-rank engine; then
   sharded training: the single-rank references in this process before
   the ranks take the card (the tiny trainer CLI, two medium steps), the
   tiny trainer CLI at full width and depth with ``--model_parallel 2``
   over (2, 2) and ``--fsdp`` over (4, 1) (2 epochs and a resumed third:
   each step's loss, its exact launches), and medium at full width and
   depth, B=2 f32 remat, two steps under TP (1, 2) and FSDP (4, 1) (the
   losses, this rank's slice of every parameter, ms a step, peak memory,
   parameter-plus-moment bytes).  The ranks share one card: their times
   are not scaling figures;
16. prints the long-form, service, quantum, training, export, distillation and
   parallel stages as JSON lines, the whole script's seconds, the per-kernel JSON line (every ported kernel with its
   launches, times, error and bound), the card line, then ``{"ok": true,
   "device": ...}`` as the last line.

Launch counts are read from each path's own f32 batch, with every counter
set to 0 just before it.  Any failure raises (non-zero exit) and nothing is
printed as a result.  There is no CPU fallback: without a CUDA device the
script exits non-zero at once.
"""

import copy
import gc
import json
import math
import subprocess
import sys
import threading
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

SEED = 0
BENCH_OPTIONS = dict(language="en", without_timestamps=True, sample_len=64,
                     suppress_blank=False)
EOT = 50257
# Max abs error allowed between a kernel and its plain version on the card.
# f32: both sides are fp32 FMA products summed in different orders (and the
# plain stem goes through cuDNN), on O(1) values with K <= 4096; the
# 24-layer medium trunk (ending in ln_post) allows 1e-3 for 24 layers of
# such reorderings.  K1 is compared after the clamp and scaling, at the
# repo's mel bound (tests/test_ops.py).  bf16: NOISE_FACTOR times the plain
# bf16 version's own distance from the plain version run in f32 on the same
# bf16-valued inputs, i.e. rounding noise of the size bf16 itself brings at
# the values compared (attention outputs of ~0.03 get a limit of their
# size, not the 0.08 that suits O(1) activations).
TOL = {"f32": 1e-4, "mel": 2e-4, "trunk_f32": 1e-3}
NOISE_FACTOR = 2.0
# Teacher-forced token check: the card's token may trail the CPU's top
# logit by this much (near-ties of random-weight logits).
TOKEN_TIE = 1e-4
# ... on the fused step: its f32 parity tolerance against the unfused step
# (tests/test_decoder_step_kernel.py), which the CPU plain path runs.
FUSED_TOKEN_TIE = 5e-4
# ... on the int8 cross cache: the card and the CPU project the cross K/V in
# different fp32 summation orders, and a value that lands near a rounding
# midpoint of its code can round the other way.  One flipped code moves one
# dequantized value by a whole scale step (max |x| / 127, ~1% of its row's
# largest value), where the fp path differs by ~1e-6 relative: the top
# logit may move by up to ~1e-2.
INT8_TOKEN_TIE = 1e-2
# int8 vs fp avg_logprob per request: the JAX package's own bound
# (tests/test_ops.py test_decode_with_kv_int8_runs_and_is_close).
INT8_LOGPROB_GAP = 0.15
# H100 SXM datasheet peaks: fp32 on the CUDA cores, bf16
# dense on the tensor cores, HBM3 bandwidth.  "tf32x3": an fp32 product
# done as three TF32 products on the tensor cores (K7 and K8 in f32).
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
B_KERNEL = 8
# The large-v3 end-to-end paths' depth (of 32 + 32): its kernel rows run at
# full width whatever the depth; the whole run must end within 1,200 s on a
# slow host too.
LARGE_PATH_LAYERS = 4
# ``--attn`` records a digest of every kernel output (two trees compared
# bit for bit).
DIGESTS = False


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
    for cmd in lib.commands:
        log("build:", " ".join(cmd))
    log(f"build seconds: {lib.build_seconds:.1f}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
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


def graph_ms(fns, rounds=6, replays=3):
    """Device ms of one call of ``fns[i % n]``: ``rounds`` passes through
    the n functions captured once in a CUDA graph and the graph replayed,
    so the host's launch overhead is not timed (an eager loop of a kernel
    shorter than its wrapper's host time measures the host).  With each
    function on inputs of its own and n chosen so that the inputs exceed
    the 50-MB L2 twice over, every call reads its inputs from device
    memory, as the decode loop does (cold); with n = 1, from L2 (hot)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * rounds * len(fns))


def bound(flops, nbytes, key):
    """Least time (ms) the card could take: the larger of the operations at
    the peak rate of their type and the bytes at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[key] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name, key, kernel_fn, plain_fn, work, tol="f32", plain32_fn=None,
            library_fn=None, iters=10, warmup=2, peak=None, library_same=True,
            bound_ms_by=None):
    """Kernel vs its plain version on the same inputs; ``work`` is (flops,
    bytes) of the function at these shapes, its operations counted at the
    ``peak`` rate (default: ``key``'s), or ``bound_ms_by`` (ms, what bounds
    it) where the kernel's module computes its own.  f32 is held to ``TOL[tol]``, bf16
    to NOISE_FACTOR times the distance of the plain bf16 version from
    ``plain32_fn`` (the plain version in f32 on the same bf16-valued
    inputs).  A library yardstick must agree with the plain version within
    the same limit, or its time is not this function's; with
    ``library_same=False`` it is a labelled near neighbour whose distance is
    only printed."""
    k = kernel_fn()
    p = plain_fn()
    torch.cuda.synchronize()
    if k.shape != p.shape or not torch.isfinite(k).all():
        raise AssertionError(f"{name} {key}: bad shape or non-finite output")
    err = float((k.float() - p.float()).abs().max())
    if key == "bf16":
        noise = float((p.float() - plain32_fn().float()).abs().max())
        limit = NOISE_FACTOR * noise
        tol_txt = f"{limit:.3e} = {NOISE_FACTOR:g} x plain bf16 vs f32 {noise:.3e}"
    else:
        limit = TOL[tol]
        tol_txt = f"{limit:.3e}"
    lib_err = None
    if library_fn is not None:
        lib_err = float((library_fn().float().reshape(p.shape) - p.float()).abs().max())
    digest = digest_of(k) if DIGESTS else None
    del k, p
    if err > limit:
        raise AssertionError(f"{name} {key}: error {err} outside tolerance {tol_txt}")
    if library_same and lib_err is not None and lib_err > limit:
        raise AssertionError(f"{name} {key}: the library call is {lib_err} from the "
                             f"plain version, outside {tol_txt}: not the same function")
    ms = cuda_ms(kernel_fn, iters, warmup)
    plain_ms = cuda_ms(plain_fn, iters, warmup)
    lib_ms = cuda_ms(library_fn, iters, warmup) if library_fn is not None else None
    bound_ms, bound_by = bound_ms_by or bound(*work, peak or key)
    log(f"{name} {key}: max_abs_err {err:.3e} (tol {tol_txt}) kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms"
        + (f" library {lib_ms:.4f} ms (its max_abs_err {lib_err:.3e})"
           if lib_ms is not None else "")
        + f" bound {bound_ms:.4f} ms ({bound_by}: {work[0] / 1e9:.2f} GFLOP, "
          f"{work[1] / 1e6:.1f} MB)")
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": lib_ms}
    if digest is not None:
        res["digest"] = digest
    return res


def digest_of(t):
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import hashlib

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


# -- work of each kernel at its inputs (flops, bytes) -------------------------

def mel_work(B, L, frames, n_mels):
    return (2 * B * frames * 400 * 402 + 2 * B * frames * 201 * n_mels,
            4 * (B * L + B * n_mels * frames))


def stem_work(B, C0, Tm, D, t_out, Tp, s):
    flops = 2 * B * Tm * D * 3 * C0 + 2 * B * t_out * D * 3 * D
    weights = D * C0 * 3 + D * D * 3 + 2 * D + t_out * D
    return flops, 4 * B * C0 * Tm + s * (weights + B * Tp * D)


def attn_work(B, Tp, D, H, t_real, s):
    # the QKV projections of every row, attention among the t_real real rows
    flops = 2 * B * Tp * D * 3 * D + 4 * B * H * t_real * t_real * (D // H)
    return flops, s * (2 * B * Tp * D + 3 * D * D + 3 * D) + 8 * D


def finish_work(B, Tp, D, s):
    return 18 * B * Tp * D * D, s * (3 * B * Tp * D + 9 * D * D + 6 * D) + 8 * D


def packed_work(B, Tq, Tk, D, H, t_real, s):
    # query rows past t_real are the encoder's padding, which the caller drops
    flops = 4 * B * H * min(Tq, t_real) * t_real * (D // H)
    return flops, s * (2 * B * Tq * D + 2 * B * Tk * D)


def int8_work(B, H, R, t_real, dh=64):
    # codes and scales of the positions < t_real, fp32 q in and out
    flops = 4 * B * H * R * t_real * dh
    return flops, 2 * B * H * t_real * (dh + 4) + 8 * B * R * H * dh


def step_work(B, D, t_self, Ta, s):
    # the layer's weights (14 D^2) and biases (11 D) once, fp32 LN
    # parameters, x in and out, the self cache's t_self - 1 old positions
    # read and the fresh one written and read, the cross K/V
    flops = 2 * B * 14 * D * D + 4 * B * D * (t_self + Ta)
    return flops, s * (14 * D * D + 11 * D) + 24 * D + s * B * D * (2 * t_self + 2 + 2 * Ta)


def geometry(dims):
    """(t_real, Tp, D, heads, mel bins, mel frames) of an encoder."""
    T = dims.n_audio_ctx
    return (T, (T + 127) // 128 * 128, dims.n_audio_state, dims.n_audio_head,
            dims.n_mels, 2 * T)


def randn(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def rows(rng, B, Tp, D, t_real, dev):
    """(B, Tp, D) N(0, 1) rows whose padding rows (>= t_real) are one
    repeated row, as the trunk leaves them (the stem zeroes them and every
    block maps equal rows to equal rows), so that a key mask that lets them
    in moves the output coherently."""
    x = randn(rng, (B, Tp, D), dev)
    x[:, t_real:] = randn(rng, (1, 1, D), dev)
    return x


# -- rounding probes ---------------------------------------------------------------
#
# K4 and K8 differ in one rounding point: K8's denominator sums the fp32 p,
# K4's the p rounded to bf16 (the TPU kernels' rules).  On random inputs the
# two are far under a bf16 ulp apart.  The probes build inputs where every p
# of a row rounds by the same large step, so the two rules give outputs one
# bf16 ulp apart and the kernel must give its own exactly.

def _bf16(x):
    """Values -> their nearest bfloat16, as float64."""
    return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32).to(
        torch.bfloat16).double().numpy()


def _stable_bf16(x, rel=5e-4):
    """x rounded to bf16, or None where x lies within ``rel`` of a rounding
    midpoint (an expf ulp or fp32 summation order could flip it there)."""
    lo, mid, hi = _bf16([x * (1 - rel), x, x * (1 + rel)])
    return float(mid) if lo == mid == hi else None


def probe_gaps(n):
    """Logit gaps for a row of one key at the row max (p = 1) and ``n``
    keys a gap s < 0 below it (p = exp(s)), all with value c: a list of
    (s, c, k8_out), one with rnd(p) > p and one with rnd(p) < p, where
    k8_out = bf16(c (1 + n rnd(p)) / (1 + n p)) is K8's output and c, K4's,
    is one bf16 ulp away."""
    found = {}
    for s in np.unique(_bf16(-np.linspace(0.05, 3.0, 6000))):
        e = float(np.exp(np.float32(s)))
        pr = _stable_bf16(e)
        if pr is None:
            continue
        ratio = (1 + n * pr) / (1 + n * e)
        c = 2 - 2 ** -7 if ratio > 1 else 1.0  # a binade's top or bottom
        out = _stable_bf16(c * ratio)
        if out is not None and out != c:
            found.setdefault(ratio > 1, (float(s), c, out))
    if len(found) != 2:
        raise AssertionError(f"probe_gaps({n}): found {len(found)} of 2 gaps")
    return [found[True], found[False]]


def k8_probe(dev, n_head, Tq, Tk, t_real):
    """bf16 q, k, v for K8 and its exact output: per head, key 0 has logit
    0, keys 1..t_real-1 the probe gap s, and the padding keys logit -s > 0
    with value -c, so that a dropped mask shows as well."""
    D = n_head * 64
    q, k, v, want = (torch.zeros(1, t, D) for t in (Tq, Tk, Tk, Tq))
    for h, (s, c, out) in zip(range(n_head), probe_gaps(t_real - 1) * n_head):
        col = slice(h * 64, (h + 1) * 64)
        q[:, :, h * 64] = s
        k[:, 1:t_real, h * 64] = 1.0
        k[:, t_real:, h * 64] = -1.0
        v[:, :t_real, col], v[:, t_real:, col] = c, -c
        want[:, :, col] = out
    return [t.to(dev, torch.bfloat16) for t in (q, k, v, want)]


def k4_probe(dev, D, n_head, Tp, t_real):
    """bf16 x with a LayerNorm and Q/K/V weights for K4, and its exact
    output.  LN maps row 0 to +-1 (half +1024, half -1024) and every other
    row to its negation; the key weight maps those to k = +-1 in each head's
    first column after the bf16 dh^-0.25 scale; q is its bias alone,
    q0 = -s / 2 > 0 in each head's first column, and v its bias alone, c.
    Key 0 thus has logit q0, the row max, and every other key q0 + s; K4
    gives exactly c."""
    from types import SimpleNamespace

    from qasr_ijcnlp_tpu_torch.ops import head_scale

    sc = head_scale(64, torch.bfloat16)
    omega = 2.828125
    if _bf16(np.float32(omega) * np.float32(sc)) != 1.0:
        raise AssertionError("k4_probe: the key weight does not give k = 1")
    x = torch.full((1, Tp, D), -1024.0)
    x[:, 0] = 1024.0
    x[:, :, D // 2:] *= -1
    ln = torch.nn.LayerNorm(D)
    lin = lambda bias: torch.nn.Linear(D, D, bias=bias).requires_grad_(False)
    attn = SimpleNamespace(query=lin(True), key=lin(False), value=lin(True))
    for m in attn.__dict__.values():
        m.weight.zero_()
    attn.query.bias.zero_()
    for h, (s, c, _) in zip(range(n_head), probe_gaps(t_real - 1) * n_head):
        q0 = -s / 2
        betas = [b for b in _bf16(q0 / sc * (1 + np.arange(-4, 5) * 2.0 ** -9))
                 if _bf16(np.float32(b) * np.float32(sc)) == q0]
        if not betas:
            raise AssertionError(f"k4_probe: no query bias gives q0 = {q0}")
        attn.query.bias[h * 64] = float(betas[0])
        attn.key.weight[h * 64, 0] = omega
        attn.value.bias[h * 64:(h + 1) * 64] = c
    want = attn.value.bias.expand(1, Tp, D).clone()
    return (x.to(dev, torch.bfloat16), ln.to(dev),
            SimpleNamespace(**{n: m.to(dev) for n, m in attn.__dict__.items()}),
            want.to(dev, torch.bfloat16))


def check_probe(name, got, want, t_real):
    """A probe's kernel output must be its rounding rule's, bit for bit."""
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name} rounding probe: {bad} of {want.numel()} outputs "
                             f"differ from its rounding rule's")
    log(f"{name} rounding probe (bf16, {tuple(got.shape)}, t_real {t_real}): exact; "
        f"(gap, c, K8 output) {probe_gaps(t_real - 1)}")


def dtypes():
    return ((torch.float32, "f32"), (torch.bfloat16, "bf16"))


def elem_size(key):
    return 4 if key == "f32" else 2


# -- kernel phases ---------------------------------------------------------------

def stem_rows(res, kid, enc, mel, Tp):
    """The stem against its plain version in f32 and bf16, bound at the
    tensor-core peaks, recorded under ``kid``; beside each row, as context,
    the time of its two ``F.conv1d`` calls alone (cuDNN, TF32 off: no one
    call adds the GELUs and the position rows), ``conv1d_ms``."""
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.ops import conv_stem, gelu

    B, C0, Tm = mel.shape
    D, T = enc.conv1.weight.shape[0], Tm // 2
    for dt, key in dtypes():
        r = res.setdefault(kid, {})[key] = compare(
            f"{kid} stem D{D} {C0} mels", key,
            lambda: conv_stem.fused_conv_stem(enc, mel, Tp, dt),
            lambda: conv_stem._plain_stem(enc, mel, Tp, dt),
            stem_work(B, C0, Tm, D, T, Tp, elem_size(key)), peak=tc_peak(key),
            plain32_fn=lambda: conv_stem._plain_stem(enc, mel, Tp, torch.float32))
        x = mel.to(dt)
        w1, b1, w2, b2 = (p.to(dt) for p in (enc.conv1.weight, enc.conv1.bias,
                                               enc.conv2.weight, enc.conv2.bias))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = gelu(F.conv1d(x, w1, b1, padding=1))
            r["conv1d_ms"] = cuda_ms(lambda: (F.conv1d(x, w1, b1, padding=1),
                                              F.conv1d(y, w2, b2, stride=2, padding=1)))
        log(f"{kid} stem D{D} {key}: its two F.conv1d calls alone (cuDNN, TF32 off) "
            f"{r['conv1d_ms']:.4f} ms beside the kernel's {r['ms']:.4f} ms")
        del x, y, w1, b1, w2, b2
    return res


def block_phase(res, ids, enc, mel, x32, dims, dev):
    """The stem, K4 and the finish against their plain versions in f32 and
    bf16, recorded under ``ids`` (stem, attention, finish)."""
    from qasr_ijcnlp_tpu_torch.ops import encoder_block

    T, Tp, D, H, C0, Tm = geometry(dims)
    B, blk = x32.shape[0], enc.blocks[0]
    stem_rows(res, ids[0], enc, mel, Tp)
    for dt, key in dtypes():
        s = elem_size(key)
        x = x32.to(dt)
        attn = encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T)
        res.setdefault(ids[1], {})[key] = compare(
            f"{ids[1]} attention {H} heads", key,
            lambda: encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, T),
            lambda: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T),
            attn_work(B, Tp, D, H, T, s), peak=tc_peak(key),
            plain32_fn=lambda: encoder_block._plain_attn_ln(
                x.float(), blk.attn_ln, blk.attn, H, T))
        res.setdefault(ids[2], {})[key] = compare(
            f"{ids[2]} finish D{D}", key,
            lambda: encoder_block.fused_block_finish(x, attn, blk),
            lambda: encoder_block._plain_finish(x, attn, blk), finish_work(B, Tp, D, s),
            peak=tc_peak(key),
            plain32_fn=lambda: encoder_block._plain_finish(x.float(), attn.float(), blk))
        del attn
    return res


def tiny_kernel_phase(model, dev):
    from qasr_ijcnlp_tpu_torch.ops import melfront

    rng = np.random.default_rng(SEED)
    dims = model.dims
    T, Tp, D, H, C0, Tm = geometry(dims)
    pcm = randn(rng, (B_KERNEL, Tm * 160), dev, 0.1)
    mel = randn(rng, (B_KERNEL, C0, Tm), dev)
    x32 = rows(rng, B_KERNEL, Tp, D, T, dev)
    padded = melfront.reflect_pad(pcm)
    res = {"K1": {"f32": compare(
        "K1 mel", "f32",
        lambda: melfront.clamp_and_scale(melfront.log10_mel(padded, C0)),
        lambda: melfront.clamp_and_scale(melfront._plain_log10_mel(padded, C0)),
        mel_work(B_KERNEL, padded.shape[1], Tm, C0), tol="mel", peak="tf32x3")}}
    return block_phase(res, ("K2", "K4", "K5"), model.module.encoder, mel, x32, dims, dev)


def small_h96_kernel_phase(model, dev):
    """K7 at small-h96's geometry (8 heads of 96) and at an odd count of
    64-wide heads (5)."""
    res = k7_phase({}, "K7", B_KERNEL, model.dims.n_audio_head, 96, dev, SEED + 13)
    return k7_phase(res, "K7_h5", B_KERNEL, 5, 64, dev, SEED + 14)


def small_h128_kernel_phase(model, dev):
    """K4 at small-h128's geometry (6 heads of 128), K8 at head widths 128
    (D 1280, 10 heads) and 32 (D 384, 12 heads), K9 at the decoder's 6
    heads of 128 (B 8, one query row)."""
    from qasr_ijcnlp_tpu_torch.ops import encoder_block

    rng = np.random.default_rng(SEED + 15)
    dims, blk = model.dims, model.module.encoder.blocks[0]
    T, Tp, D, H, _, _ = geometry(dims)
    x32 = rows(rng, B_KERNEL, Tp, D, T, dev)
    res = {}
    for dt, key in dtypes():
        x = x32.to(dt)
        res.setdefault("K4_d128", {})[key] = compare(
            f"K4_d128 attention {H} heads of {D // H}", key,
            lambda: encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, T),
            lambda: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T),
            attn_work(B_KERNEL, Tp, D, H, T, elem_size(key)), peak=tc_peak(key),
            plain32_fn=lambda: encoder_block._plain_attn_ln(
                x.float(), blk.attn_ln, blk.attn, H, T))
    packed_phase(res, "K8_d128", B_KERNEL, 1280, 10, dev, SEED + 16)
    packed_phase(res, "K8_d32", B_KERNEL, 384, 12, dev, SEED + 17)
    return int8_phase(res, "K9_d128", B_KERNEL, dims.n_text_head, dev, SEED + 18,
                      dh=dims.n_text_state // dims.n_text_head)


def plain_trunk(enc, x, dims, t_real):
    """The encoder trunk through every block's plain version."""
    from qasr_ijcnlp_tpu_torch.ops import encoder_block, layer_norm

    for blk in enc.blocks:
        a = encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, dims.n_audio_head, t_real)
        x = encoder_block._plain_finish(x, a, blk)
    return layer_norm(x[:, :t_real], enc.ln_post)


def medium_kernel_phase(model, dev):
    from qasr_ijcnlp_tpu_torch.models.whisper import transformer_trunk
    from qasr_ijcnlp_tpu_torch.ops import encoder_block

    rng = np.random.default_rng(SEED + 1)
    dims, enc = model.dims, model.module.encoder
    T, Tp, D, H, C0, Tm = geometry(dims)
    mel = randn(rng, (B_KERNEL, C0, Tm), dev)
    x32 = rows(rng, B_KERNEL, Tp, D, T, dev)
    res = block_phase({}, ("K3", "K4_16h", "K6"), enc, mel, x32, dims, dev)
    gemm_phase(dev, B_KERNEL * Tp, D)
    x, ln, attn, want = k4_probe(dev, D, H, Tp, T)
    check_probe("K4", encoder_block.fused_attention_ln(x, ln, attn, H, T), want, T)

    L = dims.n_audio_layer
    for dt, key in dtypes():
        s = elem_size(key)
        x = x32.to(dt)
        a_f, a_b = attn_work(B_KERNEL, Tp, D, H, T, s)
        f_f, f_b = finish_work(B_KERNEL, Tp, D, s)
        res.setdefault("trunk", {})[key] = compare(
            f"trunk ({L} layers)", key,
            lambda: transformer_trunk(enc, x, dims, t_real=T),
            lambda: plain_trunk(enc, x, dims, T), (L * (a_f + f_f), L * (a_b + f_b)),
            tol="trunk_f32", peak=tc_peak(key),
            plain32_fn=lambda: plain_trunk(enc, x.float(), dims, T),
            iters=2, warmup=1)
    return res


def gemm_phase(dev, M, D):
    """The fused block's tensor-core GEMM alone at the four products of
    width D over M rows (QKV, out-projection, fc, proj, each with its
    epilogue) beside ``torch.matmul`` of the same operands (cuBLAS, TF32
    off), as context for K4 and K6: no one call computes LN + QKV +
    attention or the whole finish.  Weights N(0, 1/K), activations and
    residuals N(0, 1), biases N(0, 0.1^2); the GEMM is held to its plain
    version as ``compare`` holds a kernel."""
    from qasr_ijcnlp_tpu_torch.ops import encoder_block as eb, head_scale

    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    shapes = {"qkv": (3 * D, D), "out_proj": (D, D), "fc": (4 * D, D), "proj": (D, 4 * D)}
    for dt, key in dtypes():
        sc, parts = head_scale(64, dt), []
        for ep, (N, K) in shapes.items():
            randn_ = lambda *shape, sd=1.0: (torch.randn(*shape, generator=g, device=dev)
                                             * sd).to(dt)
            a, w, bias = randn_(M, K), randn_(N, K, sd=K ** -0.5), randn_(N, sd=0.1)
            res = randn_(M, N) if ep in ("out_proj", "proj") else None
            a_op, w_op = eb.gemm_operand(a, dt), eb.gemm_operand(w, dt)
            run = lambda: eb.block_gemm(a_op, w_op, bias, ep, res, sc)
            out = run()
            out = out[0] + out[1] if out.dim() == 3 else out  # f32 t's hi/lo slabs
            plain = eb.block_gemm_plain(a, w, bias, ep, res, sc)
            err = float((out.float() - plain.float()).abs().max())
            if key == "f32":
                limit = TOL["f32"]
            else:
                r32 = None if res is None else res.float()
                plain32 = eb.block_gemm_plain(a.float(), w.float(), bias.float(), ep, r32, sc)
                limit = NOISE_FACTOR * float((plain.float() - plain32).abs().max())
                del plain32
            if not torch.isfinite(out).all() or err > limit:
                raise AssertionError(f"GEMM {ep} {key}: error {err} outside {limit}")
            del out, plain
            ms = cuda_ms(run)
            mm_ms = cuda_ms(lambda: torch.matmul(a, w.t()))
            tf = lambda t: 2 * M * N * K / t / 1e9
            parts.append(f"{ep} ({M}, {N}, {K}) kernel {ms:.4f} ms ({tf(ms):.0f} TFLOP/s, "
                         f"err {err:.2e} of {limit:.2e}), torch.matmul {mm_ms:.4f} ms "
                         f"({tf(mm_ms):.0f} TFLOP/s)")
            del a, w, bias, res, a_op, w_op
        log(f"GEMM D{D} {key} (torch.matmul with allow_tf32 off): " + "; ".join(parts))


def large_kernel_phase(model, dev):
    from qasr_ijcnlp_tpu_torch.ops import flash, melfront

    rng = np.random.default_rng(SEED + 2)
    B, dims = B_KERNEL, model.dims
    T, Tp, D, H, C0, Tm = geometry(dims)
    enc = model.module.encoder
    pcm = randn(rng, (B, Tm * 160), dev, 0.1)
    mel = randn(rng, (B, C0, Tm), dev)
    res = {}

    padded = melfront.reflect_pad(pcm)
    res["K1_128"] = {"f32": compare(
        f"K1 mel {C0} bins", "f32",
        lambda: melfront.clamp_and_scale(melfront.log10_mel(padded, C0)),
        lambda: melfront.clamp_and_scale(melfront._plain_log10_mel(padded, C0)),
        mel_work(B, padded.shape[1], Tm, C0), tol="mel", peak="tf32x3")}
    stem_rows(res, "stem_1280", enc, mel, Tp)
    packed_phase(res, "K8", B, D, H, dev, SEED + 19, T, Tp)
    q, k, v, want = k8_probe(dev, H, 128, Tp, T)
    check_probe("K8", flash.flash_attention_packed(q, k, v, H, T), want, T)
    # K9 at the decoder's geometry: a step (one query row) and the prompt (four),
    # and a beam step (five rows of each request)
    int8_phase(res, "K9", B, dims.n_text_head, dev, SEED + 9, row_counts=(1, 4))
    return int8_phase(res, "K9_g5", B, dims.n_text_head, dev, SEED + 23, groups=5)


COLD_BYTES = 128e6  # the inputs a cold K9 or K10 timing rotates over: > 2 x L2


def int8_phase(res, kid, B, H, dev, seed, row_counts=(1,), dh=64, groups=1):
    """K9 against its plain version in f32 (its arithmetic is fp32 whatever
    the compute dtype) for each query row count in ``rows``, recorded under
    ``kid`` (one row, a decode step) and ``kid + "_prompt"`` (four rows);
    ``groups`` query rows of each count share each cached segment (beam).
    K9's device time is taken from CUDA-graph replays (``graph_ms``) cold
    (``ms``), rotating over at least 4 distinct quantized caches of
    ``COLD_BYTES`` in all, so that each call reads from device memory as
    the decode loop does, and hot (``hot_ms``), one cache in L2; beside
    them ``eager_ms``, eager calls on one cache (the earlier timing of K9), which
    include the wrapper's host time where it is the longer.  Beside it,
    SDPA over the f32 fp cross cache is timed as the fp path's
    cross-attention, which the int8 path replaces (not the same function,
    so not its library yardstick: K9 has none)."""
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.ops import decode_attn

    rng = np.random.default_rng(seed)
    T, D = 1500, H * dh
    k, v = randn(rng, (B, T, D), dev), randn(rng, (B, T, D), dev)
    k8, sk = decode_attn.quantize_kv(k, H)
    v8, sv = decode_attn.quantize_kv(v, H)
    heads = lambda z: z.view(B, -1, H, dh).transpose(1, 2)
    kh, vh = (heads(k) * dh ** -0.25).contiguous(), heads(v).contiguous()
    cache_bytes = 2 * (k8.numel() + 4 * sk.numel())
    caches = [(k8, sk, v8, sv)]
    while len(caches) < max(4, math.ceil(COLD_BYTES / cache_bytes)):
        caches.append((*decode_attn.quantize_kv(randn(rng, (B, T, D), dev), H),
                       *decode_attn.quantize_kv(randn(rng, (B, T, D), dev), H)))
    for R in row_counts:
        q = randn(rng, (B * groups, R, D), dev)
        qh = (heads(q) * dh ** -0.25).contiguous()
        r = compare(
            f"{kid} int8 cross attention B={B} G={groups} {H} heads of {dh} R={R}", "f32",
            lambda: decode_attn.int8_cross_attention(q, k8, sk, v8, sv, H, T),
            lambda: decode_attn.int8_cross_attention_plain(q, k8, sk, v8, sv, H, T),
            int8_work(B, H, R * groups, T, dh))
        calls = [lambda c=c: decode_attn.int8_cross_attention(q, *c, H, T) for c in caches]
        r["eager_ms"] = r["ms"]
        r["ms"] = graph_ms(calls)
        r["hot_ms"] = graph_ms(calls[:1], rounds=6 * len(calls))
        r["fp_path_sdpa_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0))
        r["split"] = decode_attn._card_split(dev, 0, groups, R, dh, T, B * H)
        log(f"{kid} R={R}: S, cs = {r['split']}; cold {r['ms']:.4f} ms over {len(caches)} "
            f"caches of {cache_bytes / 1e6:.1f} MB, hot {r['hot_ms']:.4f} ms (graph replays), eager "
            f"{r['eager_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.0%} "
            f"of it cold); the fp path's cross-attention (SDPA over the f32 cache of "
            f"{2 * B * T * D * 4 / 1e6:.1f} MB) {r['fp_path_sdpa_ms']:.4f} ms")
        res[kid if R == 1 else f"{kid}_prompt"] = {"f32": r}
    return res


def tc_peak(key):
    """The peak that bounds the tensor-core kernels (K1-K8) in ``key``."""
    return "tf32x3" if key == "f32" else "bf16"


def k7_phase(res, kid, B, H, dh, dev, seed, T=1500, Tp=1536):
    """K7 against its plain version in f32 and bf16 on the (B, H, Tp, dh)
    head views of (B, Tp, H dh) rows, as the unfused trunk hands them over
    (scaled by the rounded dh^-0.25, padding rows repeated, t_real T), with
    SDPA on the same views and key mask as its library yardstick."""
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.ops import flash, head_scale

    rng = np.random.default_rng(seed)
    q32, k32, v32 = (rows(rng, B, Tp, H * dh, T, dev) for _ in range(3))
    keep = (torch.arange(Tp, device=dev) < T)[None]  # (1, Tk), True = attend
    heads = lambda z: z.view(B, Tp, H, dh).transpose(1, 2)
    for dt, key in dtypes():
        sc = head_scale(dh, dt)
        q, k, v = heads(q32.to(dt)) * sc, heads(k32.to(dt)) * sc, heads(v32.to(dt))
        res.setdefault(kid, {})[key] = compare(
            f"{kid} 4D attention {H} heads of {dh}", key,
            lambda: flash.flash_attention(q, k, v, T),
            lambda: flash._plain_attention(q, k, v, T),
            packed_work(B, Tp, Tp, H * dh, H, T, elem_size(key)), peak=tc_peak(key),
            plain32_fn=lambda: flash._plain_attention(q.float(), k.float(), v.float(), T),
            library_fn=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                              scale=1.0))
        del q, k, v
    return res


def packed_phase(res, kid, B, D, H, dev, seed, T=1500, Tp=1536):
    """K8 against its plain version in f32 and bf16 at D = H dh, with SDPA
    as its library yardstick (as in ``large_kernel_phase``)."""
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.ops import flash, head_scale

    rng = np.random.default_rng(seed)
    q32, k32, v32 = (rows(rng, B, Tp, D, T, dev) for _ in range(3))
    keep = (torch.arange(Tp, device=dev) < T)[None]
    heads = lambda z: z.view(B, Tp, H, D // H).transpose(1, 2)
    for dt, key in dtypes():
        sc = head_scale(D // H, dt)
        q, k, v = q32.to(dt) * sc, k32.to(dt) * sc, v32.to(dt)
        res.setdefault(kid, {})[key] = compare(
            f"{kid} packed attention {H} heads of {D // H}", key,
            lambda: flash.flash_attention_packed(q, k, v, H, T),
            lambda: flash._plain_attention_packed(q, k, v, H, T),
            packed_work(B, Tp, Tp, D, H, T, elem_size(key)), peak=tc_peak(key),
            plain32_fn=lambda: flash._plain_attention_packed(
                q.float(), k.float(), v.float(), H, T),
            library_fn=lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), attn_mask=keep, scale=1.0).transpose(1, 2))
        del q, k, v
    return res


def attn_parts_phase(res, dev):
    """K11's three modes against their plain versions at B = 8 (bf16 only,
    as the TPU script), with SDPA beside ``full`` as a near neighbour: it
    computes the same attention but does not round the normalised p before
    PV, so its distance is printed, not held.  ``dots`` and ``softmax``
    have no library call."""
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.diagnostics import attn_parts as ap

    q, k, v = ap.inputs(B_KERNEL, SEED + 11, dev)
    heads = lambda z: z.view(B_KERNEL, ap.T_PAD, ap.N_HEAD, ap.HEAD_WIDTH).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                  scale=1.0).transpose(1, 2)
    rate = ap.card_exp_rate(dev)
    log(f"K11 exponentials: {rate / 1e12:.3f} per ps (16 per SM per clock x the card's SMs "
        f"x clocks.max.sm)")
    for mode in ap.MODES:
        flops, nbytes, peak, exps = ap.work(mode, B_KERNEL, ap.T_PAD, ap.D_MODEL)
        res[f"K11_{mode}"] = {"bf16": compare(
            f"K11 {mode} B={B_KERNEL}", "bf16", lambda: ap.attn_parts(q, k, v, mode),
            lambda: ap.attn_parts_plain(q, k, v, mode), (flops, nbytes),
            plain32_fn=lambda: ap.attn_parts_plain(q.float(), k.float(), v.float(), mode),
            library_fn=sdpa if mode == "full" else None, peak=peak, library_same=False,
            bound_ms_by=ap.bound_ms(flops, nbytes, peak, exps, rate))}
    return res


def attn_parts_run(res, dev):
    """The diagnostic's own run (``diagnostics.attn_parts.measure``) at the
    TPU script's B = 512, counted as a path: every counter set to 0 just
    before it.  SDPA on the same inputs is timed beside ``full``."""
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.diagnostics import attn_parts as ap

    repeats = 3
    want = len(ap.MODES) * (repeats + 1)  # each mode: a warm-up and the repeats
    cs = counters()
    for mod, attr in cs.values():
        setattr(mod, attr, 0)
    times = ap.measure(ap.BATCH, repeats=repeats, seed=SEED + 12, device=dev)
    torch.cuda.synchronize()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in cs.items()}
    log(f"main-path launches (attn_parts B={ap.BATCH}):", json.dumps(launches))
    if launches["parts"] != want or sum(launches.values()) != want:
        raise AssertionError(f"attn_parts run: launches {launches}, expected {want} of K11")
    q, k, v = ap.inputs(ap.BATCH, SEED + 12, dev)
    heads = lambda z: z.view(ap.BATCH, ap.T_PAD, ap.N_HEAD, ap.HEAD_WIDTH).transpose(1, 2)
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), scale=1.0), iters=3, warmup=1)
    del q, k, v
    for mode, r in times.items():
        entry = res[f"K11_{mode}"]["bf16"]
        entry.update({"ms_b512": r["ms"], "bound_ms_b512": r["bound_ms"],
                      "bound_by_b512": r["bound_by"],
                      "library_ms_b512": sdpa_ms if mode == "full" else None})
        log(f"K11 {mode} B={ap.BATCH}: {r['ms']:.3f} ms (median of {r['times_ms']}), bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
            + (f"; SDPA on the same inputs {sdpa_ms:.3f} ms" if mode == "full" else ""))
    return {f"attn_parts B={ap.BATCH}": launches}


def step_formulations_phase(res, dev):
    """K12's four modes against their plain versions at the TPU script's
    shapes (B = 64, Ta 1536, bf16; dma's fp32 output in f32), with SDPA over
    row-major (B, 6, Ta, 64) heads, scale 1, beside the three attention
    modes as a near neighbour (it rounds neither p nor the sum as the modes
    do, so its distance is printed, not held)."""
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.diagnostics import step_formulations as sf

    B, H, dh = sf.BATCH, sf.N_HEAD, sf.HEAD_WIDTH
    for mode in sf.MODES:
        q, k, v = sf.inputs(B, mode, SEED + 20, dev)
        flops, nbytes, peak = sf.work(mode, B, sf.T_AUDIO)
        sdpa = None
        if mode != "dma":
            rowmajor = (lambda z: z.view(B, H, dh, -1).transpose(-1, -2)) if sf.lanes(mode) \
                else (lambda z: z.view(B, -1, H, dh).transpose(1, 2))
            qh, kh, vh = q.view(B, H, 1, dh), rowmajor(k).contiguous(), rowmajor(v).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
        key = "f32" if mode == "dma" else "bf16"
        res[f"K12_{mode}"] = {key: compare(
            f"K12 {mode} B={B}", key, lambda: sf.step_formulations(q, k, v, mode),
            lambda: sf.step_formulations_plain(q, k, v, mode), (flops, nbytes),
            plain32_fn=lambda: sf.step_formulations_plain(q.float(), k.float(), v.float(),
                                                          mode),
            library_fn=sdpa, peak=peak, library_same=False)}
        del q, k, v, sdpa
        if mode != "dma":
            res[f"K12_{mode}"]["bf16"].update(step_formulations_wide(sf, mode, B, dev))
            res[f"K12_{mode}"]["bf16"].update(step_formulations_wide(sf, mode, B, dev,
                                                                     peaked=True))
    return res


def step_formulations_wide(sf, mode, B, dev, peaked=False):
    """K12 ``mode`` on inputs N(0, 0.5^2) (the CPU test's), or with
    ``peaked`` on ``sf.peaked_inputs`` (per row and head one position of
    the kernel's last split planted 6 above the row's other logits),
    checked and not timed.  The script's inputs (x 0.1) give a nearly
    uniform softmax, where a wrong rescale or split merge moves the output
    by little; here the logits spread by about 2 per head, and such a fault
    moves it by tenths (peaked: by the output's own size).  The kernel
    rounds p against its chunk's running max and the plain version against
    the row's max, so each lands a bf16 step either side of the exact
    value: the kernel is held to NOISE_FACTOR times the plain bf16
    version's distance from the plain version in f32, both measured from
    the f32 one; its distance from the plain bf16 version is reported."""
    if peaked:
        q, k, v = sf.peaked_inputs(B, mode, SEED + 25, dev,
                                   n_splits=sf.card_splits(mode, B, sf.T_AUDIO, dev))
    else:
        q, k, v = sf.inputs(B, mode, SEED + 22, dev, scale=0.5)
    label = "peaked" if peaked else "wide"
    out = sf.step_formulations(q, k, v, mode)
    p = sf.step_formulations_plain(q, k, v, mode).float()
    p32 = sf.step_formulations_plain(q.float(), k.float(), v.float(), mode).float()
    torch.cuda.synchronize()
    if out.shape != p.shape or not torch.isfinite(out).all():
        raise AssertionError(f"K12 {mode} B={B} {label}: bad shape or non-finite output")
    err = float((out.float() - p).abs().max())
    err32 = float((out.float() - p32).abs().max())
    noise = float((p - p32).abs().max())
    limit = NOISE_FACTOR * noise
    log(f"K12 {mode} B={B} {label} inputs: from the plain f32 version {err32:.3e} (tol "
        f"{limit:.3e} = {NOISE_FACTOR:g} x plain bf16's {noise:.3e}); from plain bf16 "
        f"{err:.3e}; max |out| {float(p.abs().max()):.3f}")
    if err32 > limit:
        raise AssertionError(f"K12 {mode} B={B} {label}: {err32} from the plain f32 version, "
                             f"outside tolerance {limit}")
    return {f"max_abs_err_{label}": err, f"max_abs_err_{label}_f32": err32,
            f"tol_{label}": limit}


def step_formulations_run(res, dev):
    """The diagnostic's own run (``diagnostics.step_formulations.measure``)
    at the script's B = 64, counted as a path: every counter set to 0 just
    before it; each mode launches K12 once to warm up and 20 times into a
    CUDA graph, replayed 3 times and timed, and nothing else runs."""
    from qasr_ijcnlp_tpu_torch.diagnostics import step_formulations as sf

    runs, iters = 3, 20
    want = len(sf.MODES) * (1 + iters)
    cs = counters()
    for mod, attr in cs.values():
        setattr(mod, attr, 0)
    times = sf.measure(sf.BATCH, runs=runs, iters=iters, seed=SEED + 21, device=dev)
    torch.cuda.synchronize()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in cs.items()}
    log(f"main-path launches (step_formulations B={sf.BATCH}):", json.dumps(launches))
    if launches["formulations"] != want or sum(launches.values()) != want:
        raise AssertionError(f"step_formulations run: launches {launches}, expected "
                             f"{want} of K12")
    ceiling = HBM_BYTES_PER_S / 1e9
    for mode, r in times.items():
        entry = res[f"K12_{mode}"]
        entry = entry.get("f32") or entry["bf16"]
        # the kernel's time is its graph replays'; the eager loop times the host too
        entry.update({"eager_ms": entry["ms"], "ms": r["ms"], "runs_ms": r["runs_ms"],
                      "run_gbps": r["gbps"], "run_spread": r["spread"]})
        log(f"K12 {mode} B={sf.BATCH}: {r['ms'] * 1e3:.1f} us a call (graph replays; fastest of "
            f"{[round(t * 1e3, 1) for t in r['runs_ms']]} us), {r['gbps']:.1f} GB/s effective, "
            f"spread {r['spread'] * 100:.1f}%, bound {r['bound_ms'] * 1e3:.1f} us "
            f"({r['bound_by']})")
        if r["gbps"] > ceiling:
            raise AssertionError(f"K12 {mode}: {r['gbps']:.0f} GB/s is above the card's "
                                 f"{ceiling:.0f} GB/s: the timing is wrong")
    return {f"step_formulations B={sf.BATCH}": launches}


def step_phase(res, kid, block_for, B, dev, seed, ctx=80, idx=66, Ta=1500):
    """K10 against its plain version in f32 and bf16 at one decoder layer's
    last step of a 64-token decode (self positions 0..idx of ``ctx``, Ta
    audio positions): the layer output, then the fresh k/v it wrote at idx.
    K10's device time is taken from CUDA-graph replays (``graph_ms``) cold
    (``ms``), rotating over at least 4 sets of inputs (x, weights, self and
    cross caches) of ``COLD_BYTES`` in all, so that each call reads from
    device memory as the decode loop does, and hot (``hot_ms``), one set;
    beside them ``eager_ms``, eager calls on one set, which include the
    wrapper's host time where it is the longer.  Beside it, the port's
    unfused layer (``models.whisper.decoder_layer``) is timed on the same
    inputs as the path it replaces (K10 has no library yardstick)."""
    from qasr_ijcnlp_tpu_torch.models.whisper import decoder_layer
    from qasr_ijcnlp_tpu_torch.ops import decoder_step

    rng = np.random.default_rng(seed)
    blk32 = block_for(torch.float32)
    D = blk32.attn.query.weight.shape[0]
    H = D // 64
    x32 = randn(rng, (B, D), dev)
    sk32, sv32 = randn(rng, (B, H, ctx, 64), dev), randn(rng, (B, H, ctx, 64), dev)
    ck32, cv32 = randn(rng, (B, H, Ta, 64), dev, 64 ** -0.25), randn(rng, (B, H, Ta, 64), dev)
    mask = torch.zeros(1, ctx, device=dev).masked_fill(
        torch.arange(ctx, device=dev) > idx, float("-inf"))
    for dt, key in dtypes():
        packed, ln = decoder_step.pack_layer(blk32, dt)
        x, sk, sv, ck, cv = (t.to(dt) for t in (x32, sk32, sv32, ck32, cv32))
        # each run writes the fresh k/v into its own copy of the self cache
        inputs = {"kernel": (x, packed, ln, ck, cv), "plain": (x, packed, ln, ck, cv),
                  "plain32": (x.float(), packed.float(), ln, ck.float(), cv.float())}
        caches = {"kernel": (sk.clone(), sv.clone()), "plain": (sk.clone(), sv.clone()),
                  "plain32": (sk.float(), sv.float())}

        def run(fn, name):
            x_, packed_, ln_, ck_, cv_ = inputs[name]
            return fn(x_, packed_, ln_, *caches[name], ck_, cv_, idx, H)

        r = compare(
            f"{kid} fused decoder layer D{D} B={B}", key,
            lambda: run(decoder_step.fused_decoder_layer_step, "kernel"),
            lambda: run(decoder_step.fused_decoder_layer_step_plain, "plain"),
            step_work(B, D, idx + 1, Ta, elem_size(key)),
            plain32_fn=lambda: run(decoder_step.fused_decoder_layer_step_plain, "plain32"))
        fresh = lambda name: torch.cat([c[:, :, idx].float() for c in caches[name]])
        err = float((fresh("kernel") - fresh("plain")).abs().max())
        limit = TOL["f32"] if key == "f32" else NOISE_FACTOR * float(
            (fresh("plain") - fresh("plain32")).abs().max())
        if err > limit:
            raise AssertionError(f"{kid} {key}: the fresh k/v written at idx are {err} "
                                 f"from the plain version's, outside {limit:.3e}")
        set_bytes = sum(t.numel() * t.element_size() for t in (x, packed, sk, sv, ck, cv))
        sets = [(x, packed, ln, sk.clone(), sv.clone(), ck, cv)]
        while len(sets) < max(4, math.ceil(COLD_BYTES / set_bytes)):
            sets.append((x.clone(), packed.clone(), ln, sk.clone(), sv.clone(), ck.clone(),
                         cv.clone()))
        calls = [lambda z=z: decoder_step.fused_decoder_layer_step(*z, idx, H) for z in sets]
        r["eager_ms"] = r["ms"]
        r["ms"] = graph_ms(calls)
        r["hot_ms"] = graph_ms(calls[:1], rounds=6 * len(calls))
        cache = {"self_k": [sk.clone()], "self_v": [sv.clone()], "cross_k": [ck],
                 "cross_v": [cv]}
        blk = block_for(dt)
        r["unfused_layer_ms"] = cuda_ms(
            lambda: decoder_layer(blk, x[:, None], cache, 0, idx, mask, H, Ta))
        log(f"{kid} {key}: fresh k/v max_abs_err {err:.3e} (tol {limit:.3e}); cold "
            f"{r['ms']:.4f} ms over {len(sets)} input sets of {set_bytes / 1e6:.1f} MB, hot "
            f"{r['hot_ms']:.4f} ms (graph replays), eager {r['eager_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.0%} of it cold); the port's "
            f"unfused layer on the same inputs {r['unfused_layer_ms']:.4f} ms")
        del sets, calls
        res.setdefault(kid, {})[key] = r
    return res


# -- end to end --------------------------------------------------------------------

def synthetic_pcm(n, seed, samples=480000):
    """Seeded clips (30 s by default): a few tones under noise, different per
    clip."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples, dtype=np.float32) / 16000
    out = np.empty((n, samples), np.float32)
    for i in range(n):
        f = rng.uniform(100, 3000, size=3)
        tones = sum(np.sin(2 * np.pi * fi * t) for fi in f) * 0.05
        out[i] = tones + rng.standard_normal(samples).astype(np.float32) * 0.02
    return out


def options(port, fp16, kv_int8=False, extra=None):
    """The bench options; ``extra`` adds decode options (beam_size, best_of,
    temperature, patience)."""
    return port.DecodingOptions(fp16=fp16, suppress_tokens=[EOT], kv_int8=kv_int8,
                                **BENCH_OPTIONS, **(extra or {}))


def run_requests(port, model, pcm, fp16, kv_int8=False, extra=None, generator=None):
    mel = port.log_mel_spectrogram(pcm, n_mels=model.dims.n_mels, device=model.device)
    return port.decode(model, mel, options(port, fp16, kv_int8, extra), generator=generator)


def check_results(results, n, dims):
    if len(results) != n:
        raise AssertionError(f"expected {n} results, got {len(results)}")
    for r in results:
        if len(r.tokens) != BENCH_OPTIONS["sample_len"] or not np.isfinite(r.avg_logprob):
            raise AssertionError(f"bad result: {len(r.tokens)} tokens, {r.avg_logprob}")
        if r.audio_features.shape != (dims.n_audio_ctx, dims.n_audio_state) or \
                not torch.isfinite(r.audio_features).all():
            raise AssertionError("bad audio features")


def stage_times(port, model, pcm, fp16, label, kv_int8=False, extra=None):
    """Host-clock ms of each stage of one warm request batch: PCM (host) to
    log-mel, encoder, and decode (cross K/V, prompt, greedy loop, results),
    each ended by a synchronize."""
    from qasr_ijcnlp_tpu_torch.models.whisper import dispatch_encoder_apply

    dt = torch.bfloat16 if fp16 else torch.float32
    marks = [time.perf_counter()]
    mel = port.log_mel_spectrogram(pcm, n_mels=model.dims.n_mels, device=model.device)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    with torch.inference_mode():
        feats = dispatch_encoder_apply(model.module.encoder, mel, model.dims, dt)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    port.decode(model, feats, options(port, fp16, kv_int8, extra))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ms = [(b - a) * 1000 for a, b in zip(marks, marks[1:])]
    log(f"{label} stages B={pcm.shape[0]} {'bf16' if fp16 else 'f32'}: mel "
        f"{ms[0]:.1f} ms, encoder {ms[1]:.1f} ms, decode {ms[2]:.1f} ms")
    return ms


def timed_batches(port, model, pcm, label, smi, repeats=3, kv_int8=False, extra=None):
    """Wall time per batch (host clock around ``repeats`` warm batches ended
    by a synchronize) and the stages of one more, in bf16 and f32."""
    for fp16 in (True, False):
        run_requests(port, model, pcm, fp16, kv_int8, extra)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            run_requests(port, model, pcm, fp16, kv_int8, extra)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / repeats
        log(f"{label} end to end B={pcm.shape[0]} {'bf16' if fp16 else 'f32'}: "
            f"{sec * 1000:.1f} ms/batch, {pcm.shape[0] * 30.0 / sec:.1f} audio-s/s ({smi})")
        stage_times(port, model, pcm, fp16, label, kv_int8, extra)


def counters():
    from qasr_ijcnlp_tpu_torch.diagnostics import attn_parts, step_formulations
    from qasr_ijcnlp_tpu_torch.ops import (
        conv_stem, decode_attn, decoder_step, encoder_block, flash, melfront,
    )

    return {"mel": (melfront, "launches"), "stem": (conv_stem, "launches"),
            "attn": (encoder_block, "attn_launches"),
            "finish": (encoder_block, "finish_launches"), "packed": (flash, "launches"),
            "flash4d": (flash, "launches_4d"), "int8": (decode_attn, "launches"),
            "step": (decoder_step, "launches"), "parts": (attn_parts, "launches"),
            "formulations": (step_formulations, "launches")}


def zero_counters():
    cs = counters()
    for mod, attr in cs.values():
        setattr(mod, attr, 0)
    return cs


def read_counters(cs):
    torch.cuda.synchronize()
    return {k: getattr(mod, attr) for k, (mod, attr) in cs.items()}


def expect_launches(label, launches, expect):
    """``expect`` maps a counter to an exact count, or None for "at least 1";
    counters it leaves out must read 0."""
    log(f"main-path launches ({label}):", json.dumps(launches))
    for k, got in launches.items():
        want = expect.get(k, 0)
        if (want is None and got == 0) or (want is not None and got != want):
            raise AssertionError(f"{label}: {k} launched {got} times, expected "
                                 f"{'at least 1' if want is None else want}")


def encoder_expect(dims, passes):
    """The encoder's launches for ``passes`` encoder calls of ``dims``: the
    stem once a call, then per layer the fused block (K4 + finish) or K8 /
    K7 (``_trunk_uses_fused_blocks``, ``packed_applicable``)."""
    from qasr_ijcnlp_tpu_torch.models.whisper import _trunk_uses_fused_blocks
    from qasr_ijcnlp_tpu_torch.ops.flash import packed_applicable

    n = dims.n_audio_layer * passes
    if _trunk_uses_fused_blocks(dims):
        return {"stem": passes, "attn": n, "finish": n}
    return {"stem": passes, ("packed" if packed_applicable(dims.n_audio_head,
                                                           dims.n_audio_state)
                             else "flash4d"): n}


def add_expect(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


# Launches a batch must show: None is "at least once", a number exact.  The
# fused trunk (tiny to medium, small-h128) never runs K8 or K7; large-v3's
# unfused trunk runs K8 once per layer and never the fused block; small-h96's
# unfused trunk (heads that do not pack) runs K7 once per layer and nothing
# else of the encoder's attention.  The fp decode loop runs neither decode
# kernel; the int8 cache runs K9 once per layer in the prompt pass and in
# each of the sample_len - 1 steps; the fused step runs K10 once per layer in
# each step (the prompt pass stays unfused).  Beam search and best-of run the
# same loop counts over their grouped caches (K9 at G = 5 with int8: no decoder
# step after the last transition) and never K10, whose gate refuses a grouped
# cache.  No request runs K11 or K12.
FUSED_EXPECT = {"mel": None, "stem": None, "attn": None, "finish": None, "packed": 0,
                "flash4d": 0, "int8": 0, "step": 0, "parts": 0, "formulations": 0}


def large_expect(dims):
    return {**FUSED_EXPECT, "attn": 0, "finish": 0, "packed": dims.n_audio_layer}


def fused_expect(dims):
    return {**FUSED_EXPECT, "attn": dims.n_audio_layer, "finish": dims.n_audio_layer}


def k7_expect(dims):
    return {**FUSED_EXPECT, "attn": 0, "finish": 0, "flash4d": dims.n_audio_layer}


def int8_expect(expect, dims):
    return {**expect, "int8": dims.n_text_layer * BENCH_OPTIONS["sample_len"]}


def fused_step_expect(dims):
    return {**FUSED_EXPECT, "step": dims.n_text_layer * (BENCH_OPTIONS["sample_len"] - 1)}


def counted_run(port, model, pcm, expect, label, kv_int8=False, extra=None, generator=None):
    """One f32 batch with every launch counter set to 0 just before it;
    ``expect`` maps a counter to an exact count, or None for "at least 1"."""
    cs = zero_counters()
    res = run_requests(port, model, pcm, fp16=False, kv_int8=kv_int8, extra=extra,
                       generator=generator)
    launches = read_counters(cs)
    expect_launches(f"{label}, f32, {pcm.shape[0]} requests", launches, expect)
    return res, launches


def cpu_features(port, cpu_model, pcm0):
    """Request 0's encoder output on the CPU plain path."""
    from qasr_ijcnlp_tpu_torch.models.whisper import dispatch_encoder_apply

    dims = cpu_model.dims
    with torch.inference_mode():
        mel = port.log_mel_spectrogram(pcm0[None], n_mels=dims.n_mels, device="cpu")
        return dispatch_encoder_apply(cpu_model.module.encoder, mel, dims)


def teacher_forced_check(port, cpu_model, xa, card_result, label, tie=TOKEN_TIE,
                         int8_cache=None, opts=None):
    """One request on the CPU plain path (encoder output ``xa``),
    teacher-forced on the card's tokens: the decoder over the fp cross K/V,
    or over ``int8_cache`` (the CPU's own int8 cross cache) in one
    incremental pass.  ``opts``: the request's DecodingOptions (default the
    bench options in f32), whose initial tokens (prompt, sot sequence) and
    filters (timestamp rules) the check uses."""
    from qasr_ijcnlp_tpu_torch.decode import DecodingTask
    from qasr_ijcnlp_tpu_torch.decode.filters import apply_filters
    from qasr_ijcnlp_tpu_torch.models.whisper import decoder_apply, decoder_step

    dims = cpu_model.dims
    task = DecodingTask(cpu_model, opts or options(port, False))
    feat_err = float((card_result.audio_features.float().cpu() - xa[0]).abs().max())
    toks = torch.tensor([list(task.initial_tokens) + list(card_result.tokens)])
    with torch.inference_mode():
        if int8_cache is None:
            logits = decoder_apply(cpu_model.module.decoder, toks, xa, dims)[0]
        else:
            logits = decoder_step(cpu_model.module.decoder, toks, dict(int8_cache), dims)[0][0]
    sb = task.sample_begin
    last = prev = torch.tensor([-1])
    max_ts = torch.zeros(1, dtype=torch.long)
    min_margin, worst = math.inf, 0.0
    for i, tok in enumerate(card_result.tokens):
        f = apply_filters(task.loop_cfg.filters, logits[sb - 1 + i][None], sb + i, last,
                          prev, max_ts)[0]
        top2 = torch.topk(f, 2).values
        min_margin = min(min_margin, float(top2[0] - top2[1]))
        behind = float(top2[0] - f[tok])
        worst = max(worst, behind)
        if behind > tie:
            raise AssertionError(f"{label}: step {i}, card token {tok} is "
                                 f"{behind:.3e} below the CPU's top logit (tie {tie:g})")
        prev, last = last, torch.tensor([tok])
        if tok >= task.loop_cfg.timestamp_begin:
            max_ts = torch.maximum(max_ts, last)
    log(f"{label}: f32 tokens pass the CPU teacher-forced check ({len(card_result.tokens)} "
        f"steps; card token behind the CPU top logit by at most {worst:.3e}, tie {tie:g}; "
        f"smallest top-2 margin {min_margin:.3e}; encoder output max |card - CPU| "
        f"{feat_err:.3e})")
    return min_margin


def token_agreement(a, b):
    same = sum(x == y for r, s in zip(a, b) for x, y in zip(r.tokens, s.tokens))
    return same, sum(len(r.tokens) for r in a)


def int8_path(port, gpu, cpu, pcm, res_fp, xa, smi, name, expect):
    """``name``'s model with ``kv_int8``: one counted f32 batch (``expect``
    with the int8 launches), request 0 against the CPU plain int8 path (its
    encoder output ``xa`` from the fp check), int8 vs fp agreement, then
    bf16, times and stages."""
    from qasr_ijcnlp_tpu_torch.models.whisper import init_kv_cache, precompute_cross_kv

    dims, B = gpu.dims, pcm.shape[0]
    label = f"{name} int8"
    res8, launches = counted_run(port, gpu, pcm, int8_expect(expect, dims), label,
                                 kv_int8=True)
    check_results(res8, B, dims)
    with torch.inference_mode():
        cpu_cache = precompute_cross_kv(
            cpu.module.decoder, xa, init_kv_cache(dims, 1, device="cpu", cross_int8=True))
        card_cache = precompute_cross_kv(
            gpu.module.decoder, res8[0].audio_features[None].float(),
            init_kv_cache(dims, 1, device=gpu.device, ctx=16, cross_int8=True))
    pairs = [(a.cpu(), b) for key in ("cross_k8", "cross_v8")
             for a, b in zip(card_cache[key], cpu_cache[key])]
    flips = sum(int((a != b).sum()) for a, b in pairs)
    off = max(int((a.int() - b.int()).abs().max()) for a, b in pairs)
    log(f"{label}: request 0's cross K/V codes differ between card and CPU at {flips} of "
        f"{sum(a.numel() for a, _ in pairs)} (at most {off} apart)")
    teacher_forced_check(port, cpu, xa, res8[0], f"{label} request 0", INT8_TOKEN_TIE,
                         int8_cache=cpu_cache)
    same, total = token_agreement(res8, res_fp)
    gap = max(abs(a.avg_logprob - b.avg_logprob) for a, b in zip(res8, res_fp))
    log(f"{label} vs fp (f32): token agreement {same}/{total} = {same / total:.4f}; "
        f"largest avg_logprob gap {gap:.4f} (bound {INT8_LOGPROB_GAP})")
    if gap > INT8_LOGPROB_GAP:
        raise AssertionError(f"{label}: avg_logprob moved by {gap} from the fp path")
    res16 = run_requests(port, gpu, pcm, fp16=True, kv_int8=True)
    check_results(res16, B, dims)
    same, total = token_agreement(res8, res16)
    log(f"{label}: bf16 vs f32 token agreement {same}/{total} = {same / total:.4f}")
    timed_batches(port, gpu, pcm, label, smi, repeats=2, kv_int8=True)
    return launches


BEAM = {"beam_size": 5}


def sequence_logprobs(port, cpu_model, xa, tokens, int8_cache=None):
    """Cumulative filtered logprobs of ``tokens`` (the bench options) on the
    CPU plain path over encoder output ``xa``, teacher-forced in one pass
    (over ``int8_cache``, the CPU's int8 cross cache, where given)."""
    from qasr_ijcnlp_tpu_torch.decode import DecodingTask
    from qasr_ijcnlp_tpu_torch.decode.filters import apply_filters
    from qasr_ijcnlp_tpu_torch.models.whisper import decoder_apply, decoder_step

    dims = cpu_model.dims
    task = DecodingTask(cpu_model, options(port, False))
    toks = torch.tensor([list(task.initial_tokens) + list(tokens)])
    with torch.inference_mode():
        if int8_cache is None:
            logits = decoder_apply(cpu_model.module.decoder, toks, xa, dims)[0]
        else:
            logits = decoder_step(cpu_model.module.decoder, toks, dict(int8_cache), dims)[0][0]
    sb = task.sample_begin
    last = prev = torch.tensor([-1])
    lps = []
    for i, tok in enumerate(tokens):
        f = apply_filters(task.loop_cfg.filters, logits[sb - 1 + i][None], sb + i, last, prev,
                          torch.zeros(1, dtype=torch.long))[0]
        lps.append(float(torch.log_softmax(f.float(), -1)[tok]))
        prev, last = last, torch.tensor([tok])
    return np.cumsum(lps)


def beam_check(port, cpu_model, xa, card, ref, label, tie, int8_cache=None):
    """A card beam result against the CPU plain path's for the same request:
    equal tokens, or, at the first step where they diverge, the CPU's
    scores of the two competing sequences through that step (or of the two
    whole sequences, a near tie in the final ranking) within ``tie``."""
    if card.tokens == ref.tokens:
        log(f"{label}: beam tokens identical to the CPU plain path's "
            f"({len(card.tokens)} tokens)")
        return
    j = next(i for i, (a, b) in enumerate(zip(card.tokens, ref.tokens)) if a != b)
    a = sequence_logprobs(port, cpu_model, xa, card.tokens, int8_cache)
    b = sequence_logprobs(port, cpu_model, xa, ref.tokens, int8_cache)
    d_step, d_end = abs(a[j] - b[j]), abs(a[-1] - b[-1])
    log(f"{label}: beam tokens diverge from the CPU's at step {j}; CPU scores through it "
        f"{a[j]:.6f} (card) vs {b[j]:.6f} (CPU), |diff| {d_step:.3e}; whole sequences "
        f"{a[-1]:.6f} vs {b[-1]:.6f}, |diff| {d_end:.3e} (tie {tie:g})")
    if min(d_step, d_end) > tie:
        raise AssertionError(f"{label}: diverging beam results are no near tie")


def beam_expect(expect, dims, int8):
    """Launches of a beam batch: the encoder's as ``expect``; K9 once per
    layer in the prompt pass and in each of the sample_len - 1 decoder steps
    (none after the last transition); never K10."""
    n = dims.n_text_layer * BENCH_OPTIONS["sample_len"] if int8 else 0
    return {**expect, "int8": n, "step": 0}


def beam_path(port, gpu, cpu, pcm, xa, smi, name, expect):
    """``name``'s model with beam_size 5 (5 hypothesis rows per request over
    a cross cache of one row per request), fp and int8: counted f32 batches,
    request 0 against the CPU plain path's beam for that request alone,
    int8 vs fp avg_logprob, bf16, times and stages."""
    from qasr_ijcnlp_tpu_torch.models.whisper import init_kv_cache, precompute_cross_kv

    dims, B = gpu.dims, pcm.shape[0]
    paths, results = {}, {}
    for int8 in (False, True):
        label = f"{name} beam{' int8' if int8 else ''}"
        res, paths[label] = counted_run(port, gpu, pcm, beam_expect(expect, dims, int8), label,
                                        kv_int8=int8, extra=BEAM)
        check_results(res, B, dims)
        results[int8] = res
        with torch.inference_mode():
            ref = port.decode(cpu, xa, options(port, False, int8, BEAM))[0]
            cache = precompute_cross_kv(
                cpu.module.decoder, xa,
                init_kv_cache(dims, 1, device="cpu", cross_int8=True)) if int8 else None
        beam_check(port, cpu, xa, res[0], ref, f"{label} request 0",
                   INT8_TOKEN_TIE if int8 else TOKEN_TIE, cache)
        res16 = run_requests(port, gpu, pcm, fp16=True, kv_int8=int8, extra=BEAM)
        check_results(res16, B, dims)
        same, total = token_agreement(res, res16)
        log(f"{label}: bf16 vs f32 token agreement {same}/{total} = {same / total:.4f}")
        timed_batches(port, gpu, pcm, label, smi, repeats=1, kv_int8=int8, extra=BEAM)
    same, total = token_agreement(results[True], results[False])
    gap = max(abs(a.avg_logprob - b.avg_logprob) for a, b in zip(results[True], results[False]))
    log(f"{name} beam int8 vs fp (f32): token agreement {same}/{total} = {same / total:.4f}; "
        f"largest avg_logprob gap {gap:.4f} (bound {INT8_LOGPROB_GAP})")
    if gap > INT8_LOGPROB_GAP:
        raise AssertionError(f"{name} beam int8: avg_logprob moved by {gap} from the fp path")
    return paths


def tiny_beam_paths(port, gpu, cpu, pcm, smi):
    """tiny, 16 requests: beam_size 5 (and patience 2.0), tokens equal to
    the CPU plain path's for requests 0 and 1; best-of 5 at T = 0.5 from a
    seeded generator, twice equal, each result ``rank_group``'s choice
    among its group's five.  Both run with the fused step switched on, and
    K10 must not launch."""
    from qasr_ijcnlp_tpu_torch.decode import (
        DecodingTask, _audio_features, _cut_at_eot, rank_group,
    )
    from qasr_ijcnlp_tpu_torch.ops import decoder_step

    dims, B = gpu.dims, pcm.shape[0]
    paths = {}
    best_of = {"best_of": 5, "temperature": 0.5}
    gen = lambda: torch.Generator(device=gpu.device).manual_seed(SEED + 22)
    decoder_step.set_fused_decoder_step(True)
    try:
        for extra, label in ((BEAM, "tiny beam"),
                             ({**BEAM, "patience": 2.0}, "tiny beam patience 2")):
            res, paths[label] = counted_run(port, gpu, pcm, beam_expect(FUSED_EXPECT, dims, False),
                                            label, extra=extra)
            check_results(res, B, dims)
            ref = run_requests(port, cpu, pcm[:2], fp16=False, extra=extra)
            for i in range(2):
                if ref[i].tokens != res[i].tokens:
                    raise AssertionError(f"{label} request {i}: GPU f32 tokens differ from the "
                                         f"CPU plain path:\n{res[i].tokens}\n{ref[i].tokens}")
            log(f"{label}: f32 tokens identical to the CPU plain path for requests 0, 1")
        label = "tiny best_of"
        res, paths[label] = counted_run(port, gpu, pcm, FUSED_EXPECT, label, extra=best_of,
                                        generator=gen())
        check_results(res, B, dims)
        again = run_requests(port, gpu, pcm, fp16=False, extra=best_of, generator=gen())
        if [r.tokens for r in again] != [r.tokens for r in res]:
            raise AssertionError(f"{label}: one seed gave two results")
        task = DecodingTask(gpu, options(port, False, extra=best_of))
        with torch.inference_mode():
            mel = port.log_mel_spectrogram(pcm, n_mels=dims.n_mels, device=gpu.device)
            feats = _audio_features(gpu, mel, False)
            init = torch.tensor([task.initial_tokens] * B, device=gpu.device)
            groups, lps, _ = task._run_greedy(feats, init.repeat_interleave(5, 0), gen())
        for i, (r, group, lp) in enumerate(zip(res, groups, lps)):
            sliced = [_cut_at_eot(np.asarray(g), task.sample_begin, EOT) for g in group]
            best = rank_group(sliced, lp, None)
            if r.tokens != sliced[best]:
                raise AssertionError(f"{label} request {i}: not rank_group's choice")
        distinct = len({tuple(t) for g in groups for t in
                        (_cut_at_eot(np.asarray(x), task.sample_begin, EOT) for x in g)})
        log(f"{label}: one seed, one result; each of {B} results is rank_group's choice of "
            f"its 5 samples ({distinct} distinct samples of {5 * B})")
    finally:
        decoder_step.set_fused_decoder_step(None)
    for extra, label in ((BEAM, "tiny beam"), (best_of, "tiny best_of")):
        timed_batches(port, gpu, pcm, label, smi, repeats=2, extra=extra)
    return paths


def family_path(port, dims_name, dims, dev, smi, expect, kernel_phase, int8=False,
                beam=False, longform=False, services=None):
    """Kernel phases and end to end for one size; with ``int8`` the same
    batch runs again with the int8 cross cache, with ``beam`` with beam
    search (fp and int8), with ``longform`` the sequential long-form path
    (``large_longform``), then ``services`` (a service phase on the same
    models: ``engine_phase``, ``medium_services``)."""
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    t0 = time.perf_counter()
    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    gpu = port.WhisperModel.from_state_dict(sd, dims, dev, name=f"{dims_name} (random)")
    cpu = port.WhisperModel.from_state_dict(sd, dims, "cpu", name=f"{dims_name} (random)")
    log(f"{dims_name}: {sum(v.numel() for v in sd.values()) / 1e9:.3f} B parameters, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        kres = kernel_phase(gpu, dev)

    pcm = synthetic_pcm(B_KERNEL, SEED + 7, dims.n_audio_ctx * 320)
    res32, launches = counted_run(port, gpu, pcm, expect, dims_name)
    check_results(res32, B_KERNEL, dims)
    xa = cpu_features(port, cpu, pcm[0])
    teacher_forced_check(port, cpu, xa, res32[0], f"{dims_name} request 0")
    res16 = run_requests(port, gpu, pcm, fp16=True)
    check_results(res16, B_KERNEL, dims)
    same, total = token_agreement(res32, res16)
    log(f"{dims_name}: bf16 vs f32 token agreement {same}/{total} = {same / total:.4f}")
    log(f"{dims_name}: request 0 text: {res32[0].text[:120]!r}")
    timed_batches(port, gpu, pcm, dims_name, smi, repeats=2)
    paths = {dims_name: launches}
    if int8:
        paths[f"{dims_name} int8"] = int8_path(port, gpu, cpu, pcm, res32, xa, smi,
                                               dims_name, expect)
    if beam:
        paths.update(beam_path(port, gpu, cpu, pcm, xa, smi, dims_name, expect))
    if longform:
        paths.update(large_longform(port, gpu, cpu, smi, dims_name))
    if services is not None:
        paths.update(services(port, gpu, cpu, smi, dims_name))
    del gpu, cpu, sd, res32, res16
    gc.collect()
    torch.cuda.empty_cache()
    return kres, paths


def base_block_for(dev):
    """A decoder block at base's width (D 512, 8 heads), seeded default
    init, in f32 and with its Linear weights cast once to bf16."""
    import copy

    from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock

    torch.manual_seed(SEED + 3)
    blocks = {torch.float32: ResidualAttentionBlock(512, 8, cross_attention=True)
              .to(dev).requires_grad_(False)}
    blocks[torch.bfloat16] = copy.deepcopy(blocks[torch.float32])
    for mod in blocks[torch.bfloat16].modules():
        if isinstance(mod, torch.nn.Linear):
            mod.to(torch.bfloat16)
    return blocks.__getitem__


def tiny_path(port, dims, dev, smi):
    """tiny: kernel phases (K1, K2, K4, K5, K9, K10), then the fp path, the
    int8 path and the fused-step path end to end."""
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params
    from qasr_ijcnlp_tpu_torch.ops import decoder_step

    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    gpu = port.WhisperModel.from_state_dict(sd, dims, dev, name="tiny (random)")
    cpu = port.WhisperModel.from_state_dict(sd, dims, "cpu", name="tiny (random)")
    with torch.inference_mode():
        kres = tiny_kernel_phase(gpu, dev)
        int8_phase(kres, "K9_tiny", 16, dims.n_text_head, dev, SEED + 4)
        block_for = lambda dt: gpu.decoder_for(dt).blocks[0]
        step_phase(kres, "K10", block_for, 16, dev, SEED + 5)
        step_phase(kres, "K10_b64", block_for, 64, dev, SEED + 6)
        step_phase(kres, "K10_d512", base_block_for(dev), 8, dev, SEED + 8)

    pcm16 = synthetic_pcm(16, SEED)
    pcm64 = np.concatenate([pcm16] * 4)
    res32, launches = counted_run(port, gpu, pcm16, FUSED_EXPECT, "tiny")
    check_results(res32, 16, dims)
    cpu_res = run_requests(port, cpu, pcm16[:2], fp16=False)
    for i in range(2):
        if cpu_res[i].tokens != res32[i].tokens:
            raise AssertionError(f"request {i}: GPU f32 tokens differ from the CPU "
                                 f"plain path:\n{res32[i].tokens}\n{cpu_res[i].tokens}")
    log("f32 tokens identical to the CPU plain path for requests 0, 1")
    log("request 0 text:", repr(res32[0].text[:120]))
    res16 = run_requests(port, gpu, pcm16, fp16=True)
    check_results(res16, 16, dims)
    same, total = token_agreement(res32, res16)
    log(f"bf16 vs f32 token agreement: {same}/{total} = {same / total:.4f}")
    for pcm in (pcm16, pcm64):
        timed_batches(port, gpu, pcm, "tiny", smi)
    paths = {"tiny": launches}

    res8, paths["tiny int8"] = counted_run(port, gpu, pcm16, int8_expect(FUSED_EXPECT, dims),
                                           "tiny int8", kv_int8=True)
    check_results(res8, 16, dims)
    same, total = token_agreement(res8, res32)
    log(f"tiny int8 vs fp (f32): token agreement {same}/{total} = {same / total:.4f}")

    decoder_step.set_fused_decoder_step(True)
    try:
        for pcm in (pcm16, pcm64):
            B = pcm.shape[0]
            label = f"tiny fused B={B}"
            resf, paths[label] = counted_run(port, gpu, pcm, fused_step_expect(dims), label)
            check_results(resf, B, dims)
            if B == 16:
                for i in range(2):
                    teacher_forced_check(port, cpu, cpu_features(port, cpu, pcm[i]), resf[i],
                                         f"{label} request {i}", FUSED_TOKEN_TIE)
                same, total = token_agreement(resf, res32)
                log(f"{label} vs unfused (f32): token agreement {same}/{total} = "
                    f"{same / total:.4f}")
            timed_batches(port, gpu, pcm, label, smi)
    finally:
        decoder_step.set_fused_decoder_step(None)
    paths.update(tiny_beam_paths(port, gpu, cpu, pcm16, smi))
    lres, lpaths = tiny_longform(port, gpu, cpu, dev, smi)
    kres.update(lres)
    paths.update(lpaths)
    del gpu, cpu, sd
    gc.collect()
    torch.cuda.empty_cache()
    return kres, paths


# -- long-form transcription ----------------------------------------------------------

# transcribe() options of the long-form phases: greedy at temperature 0 only,
# the quality thresholds off (no window is skipped), word timestamps on.
# sample_len caps each window's decode at 64 tokens (random weights rarely
# emit eot) to keep the phases inside the smoke's time budget.
LONGFORM = dict(language="en", temperature=0.0, compression_ratio_threshold=None,
                logprob_threshold=None, no_speech_threshold=None, sample_len=64,
                word_timestamps=True)
# large-v3's sequential file: 55.3 s (three windows with seed 0's weights,
# the last partial; at 75.3 s its timestamps advanced the seek 196 frames a
# window after the second, twelve windows in all, and the phase took
# ~190 s); tiny's batched file: 299.5 s and 37 samples (ten windows in one
# batch, the last partial; a sample count that is not a multiple of the hop).
LARGE_LONGFORM_SAMPLES = 55 * 16000 + 4837
TINY_LONGFORM_SAMPLES = 4792037
# Stages of every long-form run (``LongformProbe.log_stages``), by path.
LONGFORM_STAGES = {}


def speechlike_pcm(n, seed):
    """Seeded speech-like PCM: voiced syllables (a gliding pitch with
    harmonics under a 4-Hz envelope) in phrases with pauses, over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    pitch = 120 + 40 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(pitch) / 16000
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    syllables = np.clip(np.sin(2 * np.pi * 4.0 * t), 0, None) ** 2
    phrases = (np.sin(2 * np.pi * t / 7.0 + rng.uniform(0, 6.28)) > -0.6).astype(np.float64)
    pcm = 0.15 * voiced * syllables * phrases + rng.standard_normal(n) * 0.01
    return pcm.astype(np.float32)


class LongformProbe:
    """One ``transcribe`` call on ``model`` with its stages on the host
    clock, each ended by a synchronize: the file mel, the window decodes
    (encoder + decoder), the word alignment (with its re-encodes) and the
    rest (host assembly: segmentation, seek, prompts).  Records every
    decode's (mel, options, results) and counts ``embed_audio`` calls (the
    alignment's f32 re-encodes)."""

    def __init__(self, model):
        from qasr_ijcnlp_tpu_torch import transcribe as tmod

        self.tmod, self.model = tmod, model
        self.ms = {"mel": 0.0, "decode": 0.0, "align": 0.0}
        self.decodes, self.reencodes, self.total_ms = [], 0, 0.0

    def _timed(self, key, fn, record=None):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms[key] += (time.perf_counter() - t0) * 1000
            if record is not None:
                record(*a, out=out, **k)
            return out
        return wrapped

    def _record_batch(self, model, mels, opts, out, **_):
        self.decodes.append((mels, opts, list(out)))

    def _record_window(self, mel, opts, out, **_):
        self.decodes.append((mel[None], opts, [out]))

    def _embed(self, mel):
        self.reencodes += 1
        return type(self.model).embed_audio(self.model, mel)

    def run(self, pcm, **kw):
        tmod, m = self.tmod, self.model
        saved = (tmod.log_mel_spectrogram, tmod._decode, tmod.add_word_timestamps)
        tmod.log_mel_spectrogram = self._timed("mel", saved[0])
        tmod._decode = self._timed("decode", saved[1], self._record_batch)
        tmod.add_word_timestamps = self._timed("align", saved[2])
        m.decode = self._timed("decode", m.decode, self._record_window)
        m.embed_audio = self._embed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = m.transcribe(pcm, **kw)
            torch.cuda.synchronize()
            self.total_ms = (time.perf_counter() - t0) * 1000
        finally:
            tmod.log_mel_spectrogram, tmod._decode, tmod.add_word_timestamps = saved
            del m.decode, m.embed_audio
        return out

    def results(self):
        return [r for _, _, rs in self.decodes for r in rs]

    def encoder_passes(self):
        """Encoder passes of the run: one per decode call (its window
        batch), one per alignment re-encode."""
        return len(self.decodes) + self.reencodes

    def log_stages(self, label, n_samples, smi):
        audio_s = n_samples / 16000
        host = self.total_ms - sum(self.ms.values())
        log(f"{label} stages: {audio_s:.2f} s of audio in {self.total_ms:.1f} ms = "
            f"{audio_s / self.total_ms * 1000:.1f} audio-s/s; file mel {self.ms['mel']:.1f} "
            f"ms, window decodes {self.ms['decode']:.1f} ms ({len(self.decodes)} calls, "
            f"{len(self.results())} windows), alignment {self.ms['align']:.1f} ms "
            f"({self.reencodes} f32 re-encodes), host assembly {host:.1f} ms ({smi})")
        return {"audio_s": audio_s, "total_ms": self.total_ms, "audio_s_per_s":
                audio_s / self.total_ms * 1000, **{f"{k}_ms": v for k, v in self.ms.items()},
                "host_ms": host, "decode_calls": len(self.decodes),
                "windows": len(self.results()), "reencodes": self.reencodes}


def longform_expect(dims, passes):
    """Launches of a long-form run: K1 once for the file and the encoder's
    (``encoder_expect``) for each encoder pass (window batch or re-encode);
    no decode-loop kernel (fp cache, unfused step)."""
    return add_expect({"mel": 1}, encoder_expect(dims, passes))


def counted_longform(model, pcm, fp16, label, smi, **kw):
    """One transcribe of ``pcm`` with every launch counter set to 0 just
    before it; the counts must equal ``longform_expect`` of the run's own
    encoder passes.  Keeps the run's stages in LONGFORM_STAGES; returns
    (transcript, probe, launches)."""
    cs = zero_counters()
    probe = LongformProbe(model)
    out = probe.run(pcm, fp16=fp16, **LONGFORM, **kw)
    launches = read_counters(cs)
    expect_launches(f"{label}, {probe.encoder_passes()} encoder passes", launches,
                    longform_expect(model.dims, probe.encoder_passes()))
    check_transcript(out, probe, model.dims, label)
    LONGFORM_STAGES[label] = probe.log_stages(label, pcm.shape[-1], smi)
    return out, probe, launches


def check_transcript(out, probe, dims, label):
    """Finite results of the expected shapes; one window per decoded row;
    some words timed."""
    segs = out["segments"]
    if not segs or out["language"] != "en":
        raise AssertionError(f"{label}: no segments or wrong language")
    for r in probe.results():
        if r.audio_features.shape != (dims.n_audio_ctx, dims.n_audio_state) or \
                not torch.isfinite(r.audio_features).all() or not np.isfinite(r.avg_logprob):
            raise AssertionError(f"{label}: bad window result")
    words = [w for s in segs for w in s.get("words", [])]
    if not words or not all(np.isfinite([w["start"], w["end"], w["probability"]]).all()
                            for w in words):
        raise AssertionError(f"{label}: no word timings, or non-finite ones")
    seeks = sorted({s["seek"] for s in segs})
    log(f"{label}: {len(segs)} segments over windows at {seeks}, {len(words)} words; "
        f"text {out['text'][:100]!r}")


def times_rule(card, cpu, label):
    """tests/test_align.py's rule on word (start, end) pairs: median |diff|
    <= 0.02 s and >= 70% within 0.04 s."""
    diff = np.abs(np.asarray(card, float) - np.asarray(cpu, float))
    med, share = float(np.median(diff)), float(np.mean(diff <= 0.04))
    log(f"{label}: {diff.shape[0]} words; time |card - CPU| median {med:.4f} s, max "
        f"{float(diff.max()):.4f} s, {share:.3f} within 0.04 s")
    if med > 0.02 or share < 0.7:
        raise AssertionError(f"{label}: word times outside the rule (median {med}, "
                             f"within 0.04 s {share})")


def cpu_window_features(port, cpu, cpu_mel, seek, size):
    """A window's encoder output on the CPU plain path, from the CPU file
    mel sliced as the sequential loop slices it."""
    from qasr_ijcnlp_tpu_torch.models.whisper import encoder_apply

    mel = port.pad_or_trim(cpu_mel[:, seek:seek + size], port.N_FRAMES)
    with torch.inference_mode():
        return mel, encoder_apply(cpu.module.encoder, mel[None], cpu.dims)


def alignment_check(gpu, cpu, card_mel, cpu_mel, result, xa, num_frames, label):
    """One window's alignment on the card (its decode's f32 features) and on
    the CPU plain path (``xa``) with the card's text tokens: the matrices'
    max |diff|, the words equal, the times by ``times_rule``."""
    from qasr_ijcnlp_tpu_torch import align
    from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(gpu.is_multilingual, num_languages=gpu.num_languages,
                        language="en", task="transcribe")
    text = [t for t in result.tokens if t < tok.eot]
    if not text:
        raise AssertionError(f"{label}: window 0 decoded no text token to align")
    card_m, card_p = align.alignment_matrix(gpu, tok, text, card_mel, num_frames,
                                            audio_features=result.audio_features)
    cpu_m, cpu_p = align.alignment_matrix(cpu, tok, text, cpu_mel, num_frames,
                                          audio_features=xa[0])
    err = float(np.abs(card_m - cpu_m).max())
    perr = float(np.abs(np.asarray(card_p) - np.asarray(cpu_p)).max())
    card_w = align.timings_from_matrix(tok, text, card_m, card_p)
    cpu_w = align.timings_from_matrix(tok, text, cpu_m, cpu_p)
    log(f"{label}: alignment matrix {card_m.shape} max |card - CPU| {err:.3e}; token "
        f"probabilities max |diff| {perr:.3e}")
    if [w.word for w in card_w] != [w.word for w in cpu_w] or not card_w:
        raise AssertionError(f"{label}: words differ (or none): "
                             f"{[w.word for w in card_w]} vs {[w.word for w in cpu_w]}")
    times_rule([[w.start, w.end] for w in card_w], [[w.start, w.end] for w in cpu_w],
               f"{label} alignment")
    return err


def large_longform(port, gpu, cpu, smi, name):
    """``name`` (large-v3) on the sequential loop with word timestamps over
    a 55-s file, f32 then bf16: exact launch counts (the bf16 run re-encodes
    each aligned window in f32); in f32 every window's tokens pass the CPU
    teacher-forced check under that window's options (prompt, timestamp
    rules) and window 0's alignment is held against the CPU's."""
    t0 = time.perf_counter()
    pcm = speechlike_pcm(LARGE_LONGFORM_SAMPLES, SEED + 11)
    paths = {}
    label = f"{name} longform f32"
    out32, probe, paths[label] = counted_longform(gpu, pcm, False, label, smi)
    t1 = time.perf_counter()
    cpu_mel = port.log_mel_spectrogram(pcm, gpu.dims.n_mels, padding=port.N_SAMPLES,
                                       device="cpu")
    content = cpu_mel.shape[-1] - port.N_FRAMES
    seeks = sorted({s["seek"] for s in out32["segments"]})
    if len(seeks) != len(probe.decodes) or len(seeks) < 3:
        raise AssertionError(f"{label}: {len(probe.decodes)} decodes for windows at {seeks}")
    for i, (seek, (mel, opts, (res,))) in enumerate(zip(seeks, probe.decodes)):
        size = min(port.N_FRAMES, content - seek)
        mel_cpu, xa = cpu_window_features(port, cpu, cpu_mel, seek, size)
        teacher_forced_check(port, cpu, xa, res, f"{label} window {i} (seek {seek}, "
                             f"{size} frames, prompt {len(opts.prompt or [])} tokens)",
                             opts=opts)
        if i == 0:
            alignment_check(gpu, cpu, mel[0], mel_cpu, res, xa, size,
                            f"{label} window 0")
    t2 = time.perf_counter()
    label16 = f"{name} longform bf16"
    out16, probe16, paths[label16] = counted_longform(gpu, pcm, True, label16, smi)
    if probe16.reencodes == 0:
        raise AssertionError(f"{label16}: the alignment reused bf16 features")
    log(f"{name} longform: bf16 vs f32 text equal: {out16['text'] == out32['text']}; "
        f"phase seconds: f32 run {t1 - t0:.1f}, CPU checks {t2 - t1:.1f}, bf16 run "
        f"{time.perf_counter() - t2:.1f}")
    return paths


def mel_file_phase(res, dev, pcm):
    """K1 at a whole file's length (``pcm`` and transcribe's 30 s of zero
    padding) against its plain version."""
    from qasr_ijcnlp_tpu_torch.ops import melfront

    with torch.inference_mode():
        padded = melfront.reflect_pad(torch.from_numpy(pcm[None]).to(dev), 480000)
        frames = (pcm.shape[-1] + 480000) // 160
        res["K1_file"] = {"f32": compare(
            f"K1 mel at the file length ({pcm.shape[-1]} + 480000 samples, {frames} frames)",
            "f32", lambda: melfront.clamp_and_scale(melfront.log10_mel(padded, 80)),
            lambda: melfront.clamp_and_scale(melfront._plain_log10_mel(padded, 80)),
            mel_work(1, padded.shape[1], frames, 80), tol="mel", peak="tf32x3")}
        del padded


def tiny_longform(port, gpu, cpu, dev, smi):
    """tiny with ``batch_windows`` over a 5-min file (ten windows in one
    batch) and word timestamps: K1 at the file length against its plain
    version; one uncounted warm-up transcribe per dtype; then f32 with
    exact launch counts, the transcript equal to the CPU plain path's (a
    window that differs must be a tie under TOKEN_TIE at its first
    differing step, and then passes the teacher-forced check), word times
    by ``times_rule``; then bf16."""
    t0 = time.perf_counter()
    pcm = speechlike_pcm(TINY_LONGFORM_SAMPLES, SEED + 12)
    kres, paths = {}, {}
    mel_file_phase(kres, dev, pcm)
    for fp16 in (False, True):  # warm-up (first-call costs: tables, caches)
        gpu.transcribe(pcm, fp16=fp16, batch_windows=True, **LONGFORM)
    label = "tiny longform f32"
    card, probe, paths[label] = counted_longform(gpu, pcm, False, label, smi,
                                                 batch_windows=True)
    if len(probe.decodes) != 1 or len(probe.results()) != 10:
        raise AssertionError(f"{label}: expected one batch of 10 windows")
    cpu_probe = LongformProbe(cpu)
    ref = cpu_probe.run(pcm, fp16=False, batch_windows=True, **LONGFORM)
    compare_windows(port, cpu, card, ref, probe, cpu_probe, label)
    label16 = "tiny longform bf16"
    _, _, paths[label16] = counted_longform(gpu, pcm, True, label16, smi,
                                            batch_windows=True)
    log(f"tiny longform phase seconds: {time.perf_counter() - t0:.1f}")
    return kres, paths


def compare_windows(port, cpu, card, ref, probe, cpu_probe, label):
    """The card's batched transcript against the CPU plain path's, window by
    window: segments (seek, tokens, text, start, end) equal, or the window's
    first differing token a tie, after which it passes the teacher-forced
    check; the words of equal windows equal, their times by ``times_rule``."""
    by = lambda out: {s: [g for g in out["segments"] if g["seek"] == s]
                      for s in sorted({g["seek"] for g in out["segments"]})}
    card_w, ref_w = by(card), by(ref)
    if list(card_w) != list(ref_w):
        raise AssertionError(f"{label}: windows {list(card_w)} vs CPU {list(ref_w)}")
    key = lambda g: (g["tokens"], g["text"], g["start"], g["end"])
    times_card, times_cpu, ties = [], [], []
    for i, s in enumerate(card_w):
        if [key(g) for g in card_w[s]] == [key(g) for g in ref_w[s]]:
            for a, b in zip(card_w[s], ref_w[s]):
                if [w["word"] for w in a["words"]] != [w["word"] for w in b["words"]]:
                    raise AssertionError(f"{label}: window {i} words differ")
                times_card += [[w["start"], w["end"]] for w in a["words"]]
                times_cpu += [[w["start"], w["end"]] for w in b["words"]]
            continue
        res, cpu_res = probe.results()[i], cpu_probe.results()[i]
        step = next((k for k, (a, b) in enumerate(zip(res.tokens, cpu_res.tokens)) if a != b),
                    min(len(res.tokens), len(cpu_res.tokens)))
        log(f"{label}: window {i} differs from the CPU's from step {step}; "
            f"teacher-forced check of the card's tokens:")
        margin = teacher_forced_check(port, cpu, cpu_res.audio_features[None], res,
                                      f"{label} window {i}", opts=probe.decodes[0][1])
        ties.append((i, step, margin))
    if not ties and card["text"] != ref["text"]:
        raise AssertionError(f"{label}: text differs from the CPU's")
    log(f"{label}: transcript equal to the CPU plain path's in {len(card_w) - len(ties)} of "
        f"{len(card_w)} windows (ties: {ties})")
    times_rule(times_card, times_cpu, f"{label} words")


def longform_run(port, dev, smi):
    """``python3 chip_smoke.py --longform``: the long-form phases alone, at
    full width and depth (tiny batched, large-v3 sequential; K1 at the file
    length), with their launch counts and checks as in the full run."""
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for, tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    out = {}
    for name, dims in (("tiny", tiny_dims()), ("large-v3", dims_for("large-v3"))):
        sd = init_params(torch.Generator().manual_seed(SEED), dims)
        gpu = port.WhisperModel.from_state_dict(sd, dims, dev, name=f"{name} (random)")
        cpu = port.WhisperModel.from_state_dict(sd, dims, "cpu", name=f"{name} (random)")
        if name == "tiny":
            out["kernels"], out["paths"] = tiny_longform(port, gpu, cpu, dev, smi)
        else:
            out["paths"].update(large_longform(port, gpu, cpu, smi, name))
        del gpu, cpu, sd
        gc.collect()
        torch.cuda.empty_cache()
    log(json.dumps({**out, "longform_stages": LONGFORM_STAGES}))
    log(smi)


# -- the decode services: engine, speculative decode, serving ---------------------------

# Stages of every service phase (host clock, per phase), printed as one JSON line.
SERVICE_STAGES = {}
# Engine phases: a pool of 8 slots stepped 4 tokens a call, 12 requests in two
# waves (the second sent once the pool has stepped twice, so it is admitted
# while the first wave is mid-decode).
ENGINE_SLOTS, ENGINE_UNROLL, ENGINE_REQUESTS = 8, 4, 12
SPEC_GAMMA = 4


def wire(pcm):
    """Each clip as the engine and the server carry it: 30 s of int16
    against its own peak, and the float32 audio it stands for."""
    from qasr_ijcnlp_tpu_torch.audio import wire_pcm16

    q, s = zip(*(wire_pcm16(a) for a in pcm))
    q, s = np.stack(q), np.asarray(s, np.float32)
    return q, q.astype(np.float32) * s[:, None]


def submit_waves(engine, items, waves):
    """Each item submitted from its own thread, wave after wave (a later
    wave once the pool has stepped twice more); (results, seconds from
    submit to result per request, wall seconds)."""
    n = len(items)
    out, lat, errors = [None] * n, [0.0] * n, []

    def go(i):
        t0 = time.perf_counter()
        try:
            out[i] = engine.submit(items[i], timeout=600)
        except Exception as e:  # noqa: BLE001 -- any request error fails the phase
            errors.append(f"request {i}: {type(e).__name__}: {e}")
        lat[i] = time.perf_counter() - t0

    threads = []
    t0 = time.perf_counter()
    for w, wave in enumerate(waves):
        if w:
            start = engine.step_calls
            while engine.step_calls < start + 2 and time.perf_counter() - t0 < 600:
                time.sleep(0.002)
        for i in wave:
            threads.append(threading.Thread(target=go, args=(i,)))
            threads[-1].start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(o is None for o in out):
        raise AssertionError(f"engine requests failed: {errors}")
    return out, lat, wall


def check_against(port, label, got, ref, cpu, wire_f32, kv_int8, i_feats):
    """f32 results of a service against the port's own decode of the same
    request on the card: equal tokens, or, where a request differs, its
    tokens pass the CPU teacher-forced check (the CPU's argmax within a tie:
    1e-4 fp, 1e-2 int8) on the same wire audio."""
    from qasr_ijcnlp_tpu_torch.models.whisper import init_kv_cache, precompute_cross_kv

    dims = cpu.dims
    differ = [i for i, (g, r) in enumerate(zip(got, ref)) if list(g) != list(r.tokens)]
    for i in differ:
        xa = cpu_features(port, cpu, wire_f32[i])
        cache = None
        if kv_int8:
            with torch.inference_mode():
                cache = precompute_cross_kv(cpu.module.decoder, xa,
                                            init_kv_cache(dims, 1, device="cpu",
                                                          cross_int8=True))
        teacher_forced_check(port, cpu, xa, SimpleNamespace(tokens=list(got[i]),
                                                            audio_features=i_feats(i)),
                             f"{label} request {i}", INT8_TOKEN_TIE if kv_int8 else TOKEN_TIE,
                             int8_cache=cache)
    log(f"{label}: f32 tokens equal to the port's decode on the card in "
        f"{len(got) - len(differ)} of {len(got)} requests"
        + (f" (requests {differ} pass the CPU teacher-forced check)" if differ else ""))


def latency_line(lat):
    lat = sorted(lat)
    return {"p50_s": lat[len(lat) // 2], "max_s": lat[-1], "mean_s": sum(lat) / len(lat)}


def engine_phase(port, gpu, cpu, smi, name):
    """``name``'s model behind a ``DecodeEngine`` of 8 slots (unroll 4) with
    the audio front end (K1 at admission), 12 requests in two waves, in f32
    fp, f32 ``kv_int8`` (K9 every step) and bf16 fp: exact launch counts from
    the run's own admissions and steps, f32 results against the port's
    decode of the same wire audio on the card (``check_against``), bf16
    agreement, per-request latency, and the engine's stage split
    (admission, steps, retirement: ``DecodeEngine.stage_seconds``, the
    device stream's span of each stage by CUDA events); then the loop's two
    position forms timed (``loop_forms_ab``)."""
    from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine

    dims = gpu.dims
    pcm = synthetic_pcm(ENGINE_REQUESTS, SEED + 31)
    q, wire_f32 = wire(pcm)
    waves = [list(range(6)), list(range(6, ENGINE_REQUESTS))]
    with torch.inference_mode():
        mels = port.log_mel_spectrogram(torch.from_numpy(wire_f32).to(gpu.device),
                                        dims.n_mels, device=None)
    paths, stages = {}, {}
    for fp16, kv_int8 in ((False, False), (False, True), (True, False)):
        label = f"engine {name} {'bf16' if fp16 else 'f32'}{' int8' if kv_int8 else ''}"
        opts = options(port, fp16, kv_int8)
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = port.decode(gpu, mels, opts)
            torch.cuda.synchronize()
            batch_s = time.perf_counter() - t0
        engine = DecodeEngine(gpu, opts, slots=ENGINE_SLOTS, unroll=ENGINE_UNROLL,
                              audio_frontend=True)
        try:
            cs = zero_counters()
            out, lat, wall = submit_waves(engine, list(pcm), waves)
            launches = read_counters(cs)
        finally:
            engine.close()
        A, S = engine.admit_calls, engine.step_calls
        expect = add_expect({"mel": A}, encoder_expect(dims, A))
        if kv_int8:
            expect["int8"] = dims.n_text_layer * (ENGINE_UNROLL * S + A)
        expect_launches(f"{label}, {ENGINE_REQUESTS} requests, {A} admissions, {S} steps",
                        launches, expect)
        for o in out:
            if len(o["tokens"]) != BENCH_OPTIONS["sample_len"] or \
                    not np.isfinite(o["avg_logprob"]):
                raise AssertionError(f"{label}: bad result {o}")
        if fp16:
            same = sum(a == b for o, r in zip(out, ref) for a, b in zip(o["tokens"], r.tokens))
            log(f"{label}: token agreement with the bf16 decode {same}/"
                f"{ENGINE_REQUESTS * BENCH_OPTIONS['sample_len']}")
        else:
            check_against(port, label, [o["tokens"] for o in out], ref, cpu, wire_f32,
                          kv_int8, lambda i: ref[i].audio_features)
            paths[label] = launches
        stages[label] = {"requests": ENGINE_REQUESTS, "admissions": A, "steps": S,
                         "wall_s": wall, "batch_decode_s": batch_s,
                         "latency": latency_line(lat),
                         "stage_s": engine.stage_seconds}
        log(f"{label}: {ENGINE_REQUESTS} requests in {wall:.3f} s ({A} admissions, {S} steps "
            f"of {ENGINE_UNROLL}); latency {json.dumps(stages[label]['latency'])}; stages "
            f"(device spans) {json.dumps(stages[label]['stage_s'])}; the same 12 as one "
            f"decode batch {batch_s:.3f} s ({smi})")
    SERVICE_STAGES.update(stages)
    loop_forms_ab(port, gpu, smi, f"loop forms {name}")
    return paths


def speculative_phase(port, target, cpu, draft, smi, label, kv_int8=False):
    """Speculative greedy decode of 8 requests (f32, gamma 4) with ``draft``
    (a model, or None for prompt lookup): exact launch counts (both
    encoders; K9 once per layer in the prompt pass and each verify round on
    an int8 target), tokens equal to plain greedy's on the card (or, where
    a request differs, the CPU teacher-forced check), the rounds and tokens
    per round (acceptance), the CUDA-event split of the rounds into draft
    and verify, and wall time beside plain greedy's."""
    from qasr_ijcnlp_tpu_torch.decode import DecodingTask, Draft

    dims = target.dims
    pcm = synthetic_pcm(B_KERNEL, SEED + 41)
    # One task, whose last_spec_rounds the run leaves behind (the bench
    # options' list of suppressed tokens keeps decode() from caching it).
    task = DecodingTask(target, options(port, False, kv_int8, {"draft": Draft(draft,
                                                                            SPEC_GAMMA)}))

    def spec_run(events=None):
        return task.run(port.log_mel_spectrogram(pcm, n_mels=dims.n_mels,
                                                 device=target.device), spec_events=events)

    with torch.inference_mode():
        plain = run_requests(port, target, pcm, False, kv_int8)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = run_requests(port, target, pcm, False, kv_int8)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        spec_run()  # warm
        events = []
        cs = zero_counters()
        t0 = time.perf_counter()
        res = spec_run(events)
        launches = read_counters(cs)
        spec_s = time.perf_counter() - t0
    rounds = task.last_spec_rounds
    expect = add_expect({"mel": 1}, encoder_expect(dims, 1),
                        encoder_expect(draft.dims, 1) if draft is not None else {})
    if kv_int8:
        expect["int8"] = dims.n_text_layer * (1 + rounds)
    expect_launches(f"{label}, {B_KERNEL} requests, {rounds} rounds", launches, expect)
    check_results(res, B_KERNEL, dims)
    check_against(port, label, [r.tokens for r in res], plain, cpu, pcm, kv_int8,
                  lambda i: res[i].audio_features)
    per_round = (np.mean([len(r.tokens) for r in res]) - 1) / rounds
    draft_ms = sum(a.elapsed_time(b) for a, b, _ in events)
    verify_ms = sum(b.elapsed_time(c) for _, b, c in events)
    SERVICE_STAGES[label] = {"rounds": rounds, "tokens_per_round": per_round,
                             "gamma": SPEC_GAMMA, "requests": B_KERNEL,
                             "draft_ms": draft_ms, "verify_ms": verify_ms,
                             "spec_s": spec_s, "plain_greedy_s": plain_s}
    log(f"{label}: {rounds} rounds, {per_round:.3f} tokens committed per row per round "
        f"(gamma {SPEC_GAMMA}; the first token comes from the prompt pass); rounds' device "
        f"time: draft {draft_ms:.1f} ms, verify {verify_ms:.1f} ms; wall {spec_s:.3f} s vs "
        f"plain greedy {plain_s:.3f} s ({smi})")
    return {label: launches}


def loop_forms_ab(port, gpu, smi, label):
    """The greedy loop's body (filters, argmax, one decoder step) over the
    bench options' sample_len steps of B_KERNEL rows in f32, with the write
    position and the filters' token count as a host int (the batch loop's
    form: a slice write, one shared causal mask, scalar filter clauses) and
    as a uniform (B,) tensor (the per-row form of the engine and of
    speculative decode: a scatter, a per-row mask, per-row clauses).  Timed
    int, tensor, tensor, int in one run, each after a prompt pass and a
    synchronize; the forms' tokens must agree (uniform offsets are the
    scalar path)."""
    from qasr_ijcnlp_tpu_torch.decode import DecodingTask
    from qasr_ijcnlp_tpu_torch.decode.filters import apply_filters
    from qasr_ijcnlp_tpu_torch.decode.loop import _prompt_pass
    from qasr_ijcnlp_tpu_torch.models.whisper import decoder_step, encoder_apply

    task = DecodingTask(gpu, options(port, False))
    cfg, dims, dev, B = task.loop_cfg, gpu.dims, gpu.device, B_KERNEL
    decoder = gpu.decoder_for(cfg.compute_dtype)
    steps = cfg.sample_len - 1
    with torch.inference_mode():
        mels = port.log_mel_spectrogram(synthetic_pcm(B, SEED + 91), dims.n_mels, device=dev)
        xa = encoder_apply(gpu.module.encoder, mels, dims, cfg.compute_dtype)
        init = torch.tensor(task.initial_tokens, device=dev).repeat(B, 1)

        def run(per_row):
            cache, logits, _ = _prompt_pass(decoder, cfg, xa, init)
            last = prev = torch.full((B,), -1, dtype=torch.long, device=dev)
            max_ts = torch.zeros(B, dtype=torch.long, device=dev)
            toks = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                at = cfg.sample_begin + i
                cur = torch.full((B,), at, device=dev) if per_row else at
                tok = apply_filters(cfg.filters, logits, cur, last, prev, max_ts).argmax(-1)
                toks.append(tok)
                prev, last = last, tok
                max_ts = torch.where(tok >= cfg.timestamp_begin, torch.maximum(max_ts, tok),
                                     max_ts)
                off = torch.full((B,), at, device=dev) if per_row else None
                step_logits, cache = decoder_step(decoder, tok[:, None], cache, dims,
                                                  cfg.compute_dtype, offsets=off)
                logits = step_logits[:, 0]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1000 / steps, torch.stack(toks, 1)

        run(False), run(True)  # warm
        ms = {"int": [], "tensor": []}
        toks = {}
        for per_row in (False, True, True, False):
            t, toks[per_row] = run(per_row)
            ms["tensor" if per_row else "int"].append(t)
    same = int((toks[True] == toks[False]).sum())
    if same != toks[True].numel():
        raise AssertionError(f"{label}: the per-row form's tokens differ from the int form's "
                             f"({same} of {toks[True].numel()} equal)")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    SERVICE_STAGES[label] = {"rows": B, "steps": steps, "ms_per_step": ms,
                             "tensor_over_int": mean["tensor"] / mean["int"]}
    log(f"{label}: ms a step, int {ms['int']} / per-row tensor {ms['tensor']} (order int, "
        f"tensor, tensor, int); tensor / int {mean['tensor'] / mean['int']:.3f}; tokens "
        f"equal ({smi})")


def medium_services(port, gpu, cpu, smi, name):
    """medium as the speculative target of a tiny draft, fp and int8."""
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    tiny = port.WhisperModel.from_state_dict(
        init_params(torch.Generator().manual_seed(SEED + 1), tiny_dims()), tiny_dims(),
        gpu.device, name="tiny draft (random)")
    paths = speculative_phase(port, gpu, cpu, tiny, smi, f"speculative {name} <- tiny")
    paths.update(speculative_phase(port, gpu, cpu, tiny, smi,
                                   f"speculative {name} int8 <- tiny", kv_int8=True))
    return paths


def beam_pool_phase(port, gpu, cpu, smi):
    """tiny behind a beam pool (beam 5, 4 groups, unroll 4, audio front end),
    6 requests in two waves: exact launch counts, each result equal to the
    port's beam decode of the same wire audio on the card (or a near tie of
    the CPU's beam, ``beam_check``), latency and stages."""
    from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine

    dims, label = gpu.dims, "engine tiny beam 5"
    pcm = synthetic_pcm(6, SEED + 51)
    _, wire_f32 = wire(pcm)
    opts = options(port, False, extra=BEAM)
    with torch.inference_mode():
        mels = port.log_mel_spectrogram(torch.from_numpy(wire_f32).to(gpu.device),
                                        dims.n_mels, device=None)
        ref = port.decode(gpu, mels, opts)
    engine = DecodeEngine(gpu, opts, slots=4, unroll=ENGINE_UNROLL, audio_frontend=True)
    try:
        cs = zero_counters()
        out, lat, wall = submit_waves(engine, list(pcm), [[0, 1, 2], [3, 4, 5]])
        launches = read_counters(cs)
    finally:
        engine.close()
    A, S = engine.admit_calls, engine.step_calls
    expect_launches(f"{label}, 6 requests, {A} admissions, {S} steps", launches,
                    add_expect({"mel": A}, encoder_expect(dims, A)))
    differ = 0
    for i, (o, r) in enumerate(zip(out, ref)):
        if o["tokens"] != r.tokens:
            differ += 1
            xa = cpu_features(port, cpu, wire_f32[i])
            with torch.inference_mode():
                cpu_ref = port.decode(cpu, xa, opts)[0]
            beam_check(port, cpu, xa, SimpleNamespace(tokens=o["tokens"]), cpu_ref,
                       f"{label} request {i}", TOKEN_TIE)
    log(f"{label}: tokens equal to the port's beam decode on the card in {6 - differ} of 6")
    SERVICE_STAGES[label] = {"requests": 6, "admissions": A, "steps": S, "wall_s": wall,
                             "latency": latency_line(lat),
                             "stage_s": engine.stage_seconds}
    log(f"{label}: {json.dumps(SERVICE_STAGES[label])} ({smi})")
    return {label: launches}


def http(port_, path, data=b"", ctype="application/json"):
    """POST to the server at ``port_``: (the JSON answer, an error answer
    included, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port_}{path}", data=data,
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            body = r.read()
    except urllib.error.HTTPError as e:  # 400 / 404 carry {"error": ...}
        body = e.read()
    return json.loads(body), time.perf_counter() - t0


def wav_bytes(pcm16):
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


def server_metric(tr, name):
    """A counter of a server's ``/metrics`` registry (0 when absent)."""
    for line in tr.metrics.render().splitlines():
        key, _, value = line.rpartition(" ")
        if key == f"qasr_{name}":
            return float(value)
    return 0.0


def serve_phase(port, gpu, cpu, smi):
    """``serving.serve`` at tiny on 127.0.0.1, ephemeral ports: 4 concurrent
    short requests on the engine route, 2 on the micro-batch route of a
    second server without an engine, one 40-s request on the long-form
    route of the engine server (its long-form pool), one online session fed
    1-s chunks then ended (the session pool), and ``/metrics``.

    The routes run alone between zeroing the counters and reading them,
    and the counts must equal what the routes' own work launches: K1 once
    for each micro-batch, each admission of the two audio-input pools and
    the long-form file; the encoder once for each micro-batch, each
    admission of the three pools and each long-form window decoded outside
    the pool (a prompted window or a sampling rung of the temperature
    ladder).  The package's warnings are errors throughout, so a window
    that leaves its pool for the plain path fails the phase.  Then every
    answer against the direct call: the port's decode of the same wire
    audio (teacher-forced on the CPU where tokens differ), ``transcribe``
    on the server's long-form pool from the same seed, and a
    ``StreamingTranscriber`` on the session pool fed the same chunks."""
    import urllib.request
    import warnings

    from qasr_ijcnlp_tpu_torch import serving
    from qasr_ijcnlp_tpu_torch.streaming import StreamingTranscriber

    label = "serve tiny"
    opts = port.DecodingOptions(language="en", without_timestamps=True, sample_len=32,
                                fp16=False)
    clips = [speechlike_pcm(int(s * 16000), SEED + 60 + i)
             for i, s in enumerate((4.0, 9.5, 2.5, 14.0, 6.0, 11.0))]
    q, wire_f32 = wire(clips)
    # long-form: 40 s as a WAV body, independent windows (each window's
    # t = 0 rung in the pool), the temperature ladder drawing from torch's
    # generator, seeded alike for the route and the direct call
    long_query = {"condition_on_previous_text": ["0"]}
    long_pcm = speechlike_pcm(40 * 16000, SEED + 70)
    pcm16 = np.clip(long_pcm * 32768, -32768, 32767).astype(np.int16)
    sess_pcm = speechlike_pcm(5 * 16000, SEED + 80)
    chunks = [sess_pcm[i:i + 16000] for i in range(0, len(sess_pcm), 16000)]
    plain_decodes = [0]
    model_decode = gpu.decode

    def counting_decode(*a, **k):  # a long-form window decoded outside the pool
        plain_decodes[0] += 1
        return model_decode(*a, **k)

    srv_e, tr_e = serving.serve(gpu, port=0, batch_size=4, block=False, options=opts,
                                engine_slots=4)
    srv_p, tr_p = serving.serve(gpu, port=0, batch_size=2, block=False, options=opts)
    pe, pp = srv_e.server_address[1], srv_p.server_address[1]
    times, answers = {}, [None] * 6

    def ask(i, p):
        answers[i] = http(p, "/v1/transcribe", json.dumps(
            {"audio": clips[i].tolist()}).encode())

    gpu.decode = counting_decode
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", module="qasr_ijcnlp_tpu_torch")
            cs = zero_counters()
            threads = [threading.Thread(target=ask, args=(i, pe if i < 4 else pp))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if any(a is None for a in answers):
                raise AssertionError(f"{label}: a short request got no answer")
            admitted_short = server_metric(tr_e, "engine_admitted_total")
            torch.manual_seed(SEED)
            got, times["long_form_request_s"] = http(
                pe, "/v1/transcribe?condition_on_previous_text=0", wav_bytes(pcm16),
                "audio/wav")
            t0 = time.perf_counter()
            sid = http(pe, "/v1/stream/sessions")[0]["id"]
            feeds = [http(pe, f"/v1/stream/sessions/{sid}/audio",
                          json.dumps({"audio": c.tolist()}).encode())[1] for c in chunks]
            final, times["session_end_s"] = http(pe, f"/v1/stream/sessions/{sid}/end")
            times["session_feed_s"] = feeds
            times["session_total_s"] = time.perf_counter() - t0
            launches = read_counters(cs)
            route_decodes, plain_decodes[0] = plain_decodes[0], 0
            for what, a in [(f"request {i}", a[0]) for i, a in enumerate(answers)] + \
                    [("long-form", got), ("session", final)]:
                if "error" in a:
                    raise AssertionError(f"{label} {what}: {a['error']}")
            # What each pool admitted, and the launches of the routes' work.
            pools = {"engine": srv_e.engine, "session": srv_e.stream_engine,
                     "long-form": srv_e.long_engine}
            A = {k: e.admit_calls for k, e in pools.items()}
            batches = server_metric(tr_p, "batches_total")
            if admitted_short != 4 or server_metric(tr_p, "batched_requests_total") != 2:
                raise AssertionError(f"{label}: the engine pool admitted {admitted_short} "
                                     "of 4 requests, or the micro-batcher did not carry 2")
            if A["long-form"] < 1 or A["session"] < 1 or \
                    server_metric(tr_e, "engine_admitted_total") != 4 + A["long-form"]:
                raise AssertionError(f"{label}: the long-form or session pool admitted "
                                     f"nothing, or windows went past the pool ({A})")
            passes = int(batches) + sum(A.values()) + route_decodes
            expect_launches(
                f"{label}: {int(batches)} micro-batches, pool admissions {json.dumps(A)}, "
                f"{route_decodes} long-form windows outside the pool", launches,
                add_expect({"mel": int(batches) + A["engine"] + A["session"] + 1},
                           encoder_expect(gpu.dims, passes)))
            with urllib.request.urlopen(f"http://127.0.0.1:{pe}/metrics", timeout=60) as r:
                metrics = r.read().decode()
            for needle in ('qasr_requests_total{route="transcribe_engine"} 4',
                           'qasr_requests_total{route="transcribe_long"} 1',
                           'qasr_requests_total{route="stream_session_end"} 1',
                           "qasr_engine_admitted_total", "qasr_engine_retired_total"):
                if needle not in metrics:
                    raise AssertionError(f"{label}: /metrics lacks {needle!r}:\n{metrics}")

            # The direct calls, after the count.
            with torch.inference_mode():
                mels = port.log_mel_spectrogram(torch.from_numpy(wire_f32).to(gpu.device),
                                                gpu.dims.n_mels, device=None)
                direct = port.decode(gpu, mels, opts)
            for name, idx in (("engine", range(4)), ("micro-batch", range(4, 6))):
                check_against(port, f"{label} {name} route",
                              [answers[i][0]["tokens"] for i in idx],
                              [direct[i] for i in idx], cpu, [wire_f32[i] for i in idx], False,
                              lambda j, idx=list(idx): direct[idx[j]].audio_features)
                for i in idx:
                    if answers[i][0]["tokens"] == direct[i].tokens and \
                            answers[i][0]["text"] != direct[i].text:
                        raise AssertionError(f"{label} request {i}: text differs")
                times[f"{name}_request_s"] = [answers[i][1] for i in idx]
            lf_pool = pools["long-form"]
            before = lf_pool.admit_calls
            torch.manual_seed(SEED)
            want = gpu.transcribe(pcm16, engine=lf_pool,
                                  **serving._long_form_kwargs(opts, long_query))
            direct_pool = lf_pool.admit_calls - before
            if got["text"] != want["text"] or \
                    (direct_pool, plain_decodes[0]) != (A["long-form"], route_decodes):
                raise AssertionError(
                    f"{label} long-form: text differs from the direct transcribe's, or the "
                    f"windows split otherwise: pool {A['long-form']} / {direct_pool}, outside "
                    f"{route_decodes} / {plain_decodes[0]}")
            log(f"{label} long-form route: text equal to the direct transcribe on the same "
                f"pool ({len(got['segments'])} segments; {A['long-form']} windows in the "
                f"pool, {route_decodes} decodes outside it)")
            s_pool = pools["session"]
            before = s_pool.admit_calls
            st = StreamingTranscriber(gpu, replace(opts, without_timestamps=False),
                                      decode_fn=s_pool.submit)
            for c in chunks:
                st.feed(c)
            want = st.end()
            if final["text"] != want["text"] or s_pool.admit_calls - before != A["session"]:
                raise AssertionError(f"{label} session: text differs from the direct "
                                     f"StreamingTranscriber's, or it decoded "
                                     f"{s_pool.admit_calls - before} windows, not "
                                     f"{A['session']}")
            log(f"{label} session: committed text equal to the direct StreamingTranscriber's "
                f"on the same pool ({len(chunks)} chunks, {A['session']} window decodes, "
                f"{len(final['text'])} characters)")
    finally:
        del gpu.decode
        for srv in (srv_e, srv_p):
            srv.shutdown()
            srv.close_all()
    SERVICE_STAGES[label] = times
    log(f"{label}: {json.dumps(times)}; /metrics {len(metrics.splitlines())} lines ({smi})")
    return {label: launches}


def tiny_services(port, dev, smi):
    """tiny: speculative decode with a self-draft (the target drafts for
    itself: nearly every proposal is accepted) and with prompt lookup, the
    beam pool, the HTTP server, and the loop's two position forms timed."""
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    dims = tiny_dims()
    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    gpu = port.WhisperModel.from_state_dict(sd, dims, dev, name="tiny (random)")
    cpu = port.WhisperModel.from_state_dict(sd, dims, "cpu", name="tiny (random)")
    paths = speculative_phase(port, gpu, cpu, gpu, smi, "speculative tiny <- self")
    paths.update(speculative_phase(port, gpu, cpu, None, smi, "speculative tiny lookup"))
    paths.update(beam_pool_phase(port, gpu, cpu, smi))
    paths.update(serve_phase(port, gpu, cpu, smi))
    loop_forms_ab(port, gpu, smi, "loop forms tiny")
    del gpu, cpu, sd
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def services_run(port, dev, smi):
    """``python3 chip_smoke.py --services``: the service phases alone, at full
    width and depth (the large-v3 engine pools, medium and tiny speculative
    decode, the tiny beam pool and server), with their launch counts and
    checks as in the full run; the stages as one JSON line."""
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    t0 = time.perf_counter()
    paths = {}
    for name, hook in (("large-v3", engine_phase), ("medium", medium_services)):
        dims = dims_for(name)
        sd = init_params(torch.Generator().manual_seed(SEED), dims)
        gpu = port.WhisperModel.from_state_dict(sd, dims, dev, name=f"{name} (random)")
        cpu = port.WhisperModel.from_state_dict(sd, dims, "cpu", name=f"{name} (random)")
        paths.update(hook(port, gpu, cpu, smi, name))
        del gpu, cpu, sd
        gc.collect()
        torch.cuda.empty_cache()
    paths.update(tiny_services(port, dev, smi))
    log(json.dumps({"service_stages": SERVICE_STAGES, "service_launches": paths}))
    log(f"services seconds: {time.perf_counter() - t0:.1f}")
    log(smi)


# -- the source paper's model: quantum Whisper, char ASR, the evaluation CLIs -------------

# Qubits of the quantum stem (the JAX package's default and the paper's).
N_QUBITS = 4
# Char ASR phases: the synthetic LibriSpeech test split, its batch, the heads'
# width, depth and decode length (the JAX CLI's defaults).
CHAR_ITEMS, CHAR_BATCH, CHAR_HIDDEN, CHAR_LAYERS, CHAR_MAX_LEN = 16, 8, 384, 2, 100
# A card char must be within this of the CPU's top logit at its step (the
# LSTM's and the MLP's fp32 products summed in other orders).
CHAR_TIE = 1e-4
# Stages and launches of every quantum and evaluation phase, by path.
QUANTUM_STAGES = {}


def quantum_encoder_expect(dims, passes, mels):
    """A quantum encoder's launches for ``passes`` encoder calls and ``mels``
    K1 calls: the trunk's kernels as the classical encoder's, the classical
    stem kernel never."""
    return {**{k: 0 for k in FUSED_EXPECT}, **encoder_expect(dims, passes), "stem": 0,
            "mel": mels}


def quantum_model(port, dims, dev, seed=SEED):
    """A quantum model with the JAX package's distributions from ``seed``,
    on ``dev`` and on the CPU (one weight set)."""
    from qasr_ijcnlp_tpu_torch.models.quantum import QuantumWhisperModel, init_quantum_params

    sd = init_quantum_params(torch.Generator().manual_seed(seed), dims, N_QUBITS)
    name = "quantum-tiny (random)"
    return (QuantumWhisperModel.from_state_dict(sd, dims, dev, name=name),
            QuantumWhisperModel.from_state_dict(sd, dims, "cpu", name=name))


def stem_work_quantum(B, C0, Tm, D, nq, s):
    """The quantum stem's (flops, bytes): its products (pre, circuit, post
    of both convolutions) and, as the least traffic, the mel read once and
    the trunk input written once."""
    T = Tm // 2
    flops = 2 * B * Tm * (3 * C0 * nq + nq * D) + 2 * B * T * (3 * D * nq + nq * D)
    flops += 2 * 2 * B * (Tm + T) * (2 * nq * (1 << nq) + (1 << nq) * nq)
    return flops, 4 * B * C0 * Tm + s * B * T * D


def aten_calls(fn):
    """The ATen operator calls one call of ``fn`` makes (each launches at
    most a kernel or two on the card; views launch none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def quantum_stage_split(port, model, pcm, fp16, label, repeats=3):
    """``repeats`` warm batches, each split by CUDA events into mel (PCM
    host to log-mel on the card), the quantum stem, the trunk and decode
    (prompt, greedy loop, results): the median ms of each stage, and every
    batch's."""
    from qasr_ijcnlp_tpu_torch.models.quantum import quantum_stem
    from qasr_ijcnlp_tpu_torch.models.whisper import transformer_trunk

    dt = torch.bfloat16 if fp16 else torch.float32
    runs = []
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        with torch.inference_mode():
            ev[0].record()
            mel = port.log_mel_spectrogram(pcm, n_mels=model.dims.n_mels, device=model.device)
            ev[1].record()
            x = quantum_stem(model.module.encoder, mel, dt)
            ev[2].record()
            feats = transformer_trunk(model.module.encoder, x, model.dims)
            ev[3].record()
            port.decode(model, feats, options(port, fp16))
            ev[4].record()
        ev[4].synchronize()
        runs.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    names = ("mel", "quantum_stem", "trunk", "decode")
    split = {k: float(np.median([r[i] for r in runs])) for i, k in enumerate(names)}
    log(f"{label} stages B={pcm.shape[0]} {'bf16' if fp16 else 'f32'} (CUDA events, median "
        f"of {repeats}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; each: {[[round(v, 3) for v in r] for r in runs]}")
    return {**split, "runs": runs}


def quantum_tiny_path(port, dev, smi):
    """(a) quantum tiny at full width (D 384, 4 + 4 layers, 80 mels, 4
    qubits), B=16: synthetic PCM -> K1 -> quantum stem -> K4/K5 trunk ->
    greedy 64 tokens, eot suppressed, in f32 and bf16 with exact launches
    (K1 once, the stem kernel never, K4 = K5 = 4); f32 requests 0 and 1
    against the CPU plain path; times, the stage split and the stem beside
    its bound and beside K2 on the same mel."""
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.quantum import quantum_stem
    from qasr_ijcnlp_tpu_torch.models.whisper import AudioEncoder
    from qasr_ijcnlp_tpu_torch.ops import conv_stem
    from qasr_ijcnlp_tpu_torch.ops.qsim import circuit_unitary

    dims = tiny_dims()
    gpu, cpu = quantum_model(port, dims, dev)
    pcm16 = synthetic_pcm(16, SEED + 20)
    expect = quantum_encoder_expect(dims, 1, 1)
    res32, launches = counted_run(port, gpu, pcm16, expect, "quantum tiny")
    check_results(res32, 16, dims)
    paths = {"quantum tiny": launches}
    cpu_res = run_requests(port, cpu, pcm16[:2], fp16=False)
    for i in range(2):
        if cpu_res[i].tokens == res32[i].tokens:
            log(f"quantum tiny request {i}: f32 tokens identical to the CPU plain path")
        else:
            teacher_forced_check(port, cpu, cpu_features(port, cpu, pcm16[i]), res32[i],
                                 f"quantum tiny request {i}")
    cs = zero_counters()
    res16 = run_requests(port, gpu, pcm16, fp16=True)
    paths["quantum tiny bf16"] = read_counters(cs)
    expect_launches("quantum tiny, bf16, 16 requests", paths["quantum tiny bf16"], expect)
    check_results(res16, 16, dims)
    same, total = token_agreement(res32, res16)
    log(f"quantum tiny bf16 vs f32 token agreement: {same}/{total} = {same / total:.4f}")
    timed_batches(port, gpu, pcm16, "quantum tiny", smi)
    stages = {key: quantum_stage_split(port, gpu, pcm16, key == "bf16", "quantum tiny")
              for _, key in dtypes()}

    # the stem alone at B=16 beside its bound and beside K2 on the same mel
    enc = gpu.module.encoder
    T, Tp, D, H, C0, Tm = geometry(dims)
    with torch.device(dev):
        classical = AudioEncoder(C0, T, D, H, 0)
    classical = classical.to(dev).requires_grad_(False)
    stem = {}
    with torch.inference_mode():
        mel = port.log_mel_spectrogram(pcm16, n_mels=C0, device=dev)
        for dt, key in dtypes():
            ms = cuda_ms(lambda: quantum_stem(enc, mel, dt))
            k2 = cuda_ms(lambda: conv_stem.fused_conv_stem(classical, mel, Tp, dt))
            bound_ms, bound_by = bound(*stem_work_quantum(16, C0, Tm, D, N_QUBITS,
                                                          elem_size(key)), "f32")
            split = device_split(f"quantum stem tiny B=16 {key}",
                                 lambda: quantum_stem(enc, mel, dt))
            calls = aten_calls(lambda: quantum_stem(enc, mel, dt))
            unitary = aten_calls(lambda: circuit_unitary(enc.qconv1.qweights, N_QUBITS))
            stem[key] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "k2_ms": k2,
                         "device_ms": sum(split.values()), "aten_calls": calls,
                         "unitary_aten_calls": unitary, "split": split}
            log(f"quantum stem tiny B=16 {key}: {ms:.4f} ms (bound {bound_ms:.4f} ms, "
                f"{bound_by}); device time {stem[key]['device_ms']:.4f} ms; {calls} ATen "
                f"calls, {unitary} of them each circuit unitary's; K2 on the same mel "
                f"{k2:.4f} ms; {ms / stages[key]['trunk']:.3f} of the trunk's "
                f"{stages[key]['trunk']:.3f} ms ({smi})")
    QUANTUM_STAGES["quantum tiny"] = {"stages": stages, "stem": stem}
    del gpu, cpu, classical, enc
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def quantum_large_phase(port, dev, smi):
    """(b) a quantum large-v3 encoder pass (128 mels, D 1280, 32 layers,
    B=2) through ``dispatch_encoder_apply``: the card's quantum stem against
    the CPU's on the same mel, then one counted pass from PCM (K1 once, K8
    exactly 32 times, the stem kernel and K4 never); times in f32 and
    bf16."""
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.models.quantum import (
        QuantumAudioEncoder, init_quantum_conv, quantum_stem,
    )
    from qasr_ijcnlp_tpu_torch.models.whisper import dispatch_encoder_apply

    dims = dims_for("large-v3")
    T, Tp, D, H, C0, Tm = geometry(dims)
    torch.manual_seed(SEED + 21)
    with torch.device(dev):
        enc = QuantumAudioEncoder(C0, T, D, H, dims.n_audio_layer, N_QUBITS)
    g = torch.Generator().manual_seed(SEED + 22)
    for name, c_in in (("qconv1", C0), ("qconv2", D)):
        getattr(enc, name).load_state_dict(init_quantum_conv(g, c_in, D, 3, N_QUBITS))
    enc = enc.to(dev).eval().requires_grad_(False)
    pcm = synthetic_pcm(2, SEED + 23)
    res = {}
    with torch.inference_mode():
        mel = port.log_mel_spectrogram(pcm, n_mels=C0, device=dev)
        stem_cpu = SimpleNamespace(qconv1=copy.deepcopy(enc.qconv1).cpu(),
                                   qconv2=copy.deepcopy(enc.qconv2).cpu(),
                                   positional_embedding=enc.positional_embedding.cpu())
        want = quantum_stem(stem_cpu, mel.cpu())
        got = quantum_stem(enc, mel)
        err = float((got.cpu() - want).abs().max())
        if got.shape != (2, T, D) or not torch.isfinite(got).all() or err > TOL["f32"]:
            raise AssertionError(f"quantum stem large-v3: error {err} (tol {TOL['f32']}), "
                                 f"shape {tuple(got.shape)}")
        log(f"quantum stem large-v3 B=2 f32: card vs CPU max_abs_err {err:.3e} "
            f"(tol {TOL['f32']:.0e})")
        res["stem_max_abs_err"] = err
        cs = zero_counters()
        mel = port.log_mel_spectrogram(pcm, n_mels=C0, device=dev)
        feats = dispatch_encoder_apply(enc, mel, dims)
        launches = read_counters(cs)
        expect_launches("quantum large-v3 encoder, f32, B=2", launches,
                        quantum_encoder_expect(dims, 1, 1))
        if feats.shape != (2, T, D) or not torch.isfinite(feats).all():
            raise AssertionError("quantum large-v3: bad encoder output")
        for dt, key in dtypes():
            res[key] = {"stem_ms": cuda_ms(lambda: quantum_stem(enc, mel, dt), iters=5),
                        "encoder_ms": cuda_ms(lambda: dispatch_encoder_apply(enc, mel, dims,
                                                                             dt),
                                              iters=3, warmup=1)}
            log(f"quantum large-v3 B=2 {key}: stem {res[key]['stem_ms']:.4f} ms, encoder "
                f"{res[key]['encoder_ms']:.3f} ms (CUDA events; {smi})")
    QUANTUM_STAGES["quantum large-v3"] = res
    del enc, feats, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"quantum large-v3": launches}


def char_check(label, card_ids, cpu_logits, max_steps=None):
    """Teacher-forced check of a card's char ids (B, T) against the CPU's
    logits (B, T, C) on those ids: every chosen char within CHAR_TIE of the
    CPU's top logit, up to and including each row's first <END>."""
    from qasr_ijcnlp_tpu_torch.data import END

    worst, steps = 0.0, 0
    for b in range(card_ids.shape[0]):
        for t in range(card_ids.shape[1] if max_steps is None else max_steps):
            c = int(card_ids[b, t])
            behind = float(cpu_logits[b, t].max() - cpu_logits[b, t, c])
            worst = max(worst, behind)
            steps += 1
            if behind > CHAR_TIE:
                raise AssertionError(f"{label}: row {b} step {t}: card char {c} is "
                                     f"{behind:.3e} below the CPU's top logit")
            if c == END:
                break
    log(f"{label}: {steps} card chars within {worst:.3e} of the CPU's top logit "
        f"(tie {CHAR_TIE:g})")


def char_asr_phase(port, gpu, cpu, dev, smi):
    """(c) char ASR evaluation at quantum tiny: 16 synthetic LibriSpeech
    test items, B=8, with the LSTM head (384 wide, 2 layers, 100 chars) and
    the MLP head teacher-forced and decoding; each evaluation counted (K1
    once an item, the trunk's kernels once a batch, the stem kernel never)
    and its CER/WER printed; the card's char ids against the CPU's logits on
    the same encoder input."""
    from qasr_ijcnlp_tpu_torch.data import (
        CharASRView, CharVocabulary, END, START, dataset_texts, load_librispeech,
    )
    from qasr_ijcnlp_tpu_torch.data.loader import DataLoader
    from qasr_ijcnlp_tpu_torch.models import asr
    from qasr_ijcnlp_tpu_torch.train.loops import encoder_fn_for, evaluate_char_asr

    dims = gpu.dims
    base = load_librispeech("test", CHAR_ITEMS, verbose=False)
    if not getattr(base, "is_synthetic", False):
        raise AssertionError("expected the synthetic LibriSpeech set")
    vocab = CharVocabulary.build(dataset_texts(base))
    D = dims.n_audio_state
    heads_cpu = {
        "lstm": asr.init_lstm_decoder(torch.Generator().manual_seed(SEED + 30), D,
                                      vocab.num_chars, CHAR_HIDDEN, CHAR_LAYERS),
        # the MLP head's width is the encoder's (audio and char rows share it)
        "mlp": asr.init_mlp_head(torch.Generator().manual_seed(SEED + 31), D,
                                 vocab.num_chars, D, CHAR_LAYERS),
    }
    heads = {k: copy.deepcopy(h).to(dev).requires_grad_(False) for k, h in heads_cpu.items()}
    loader = DataLoader(CharASRView(base, vocab, CHAR_MAX_LEN, device=dev), CHAR_BATCH,
                        shuffle=False)
    n_batches = -(-CHAR_ITEMS // CHAR_BATCH)
    expect = quantum_encoder_expect(dims, n_batches, CHAR_ITEMS)
    encoder_apply = encoder_fn_for(gpu)
    paths, results = {}, {}
    for kind, real in (("lstm", False), ("mlp", False), ("mlp", True)):
        label = f"char asr {kind}" + (" real_decode" if real else "")
        params = {"encoder": gpu.module.encoder, "head": heads[kind]}
        cs = zero_counters()
        t0 = time.perf_counter()
        results[label] = evaluate_char_asr(params, encoder_apply, kind, loader, vocab,
                                           CHAR_MAX_LEN, real)
        torch.cuda.synchronize()
        results[label]["seconds"] = time.perf_counter() - t0
        paths[label] = read_counters(cs)
        expect_launches(f"{label}, f32, {CHAR_ITEMS} items", paths[label], expect)
        log(f"{label}: CER {results[label]['cer']:.4f} WER {results[label]['wer']:.4f} "
            f"loss {results[label]['loss']:.4f} ({results[label]['seconds']:.2f} s; {smi})")

    # the card's ids against the CPU's logits, batch by batch
    with torch.inference_mode():
        for mel, char_ids in loader:
            mel_d = torch.from_numpy(mel).to(dev)
            enc = encoder_apply(gpu.module.encoder, mel_d)
            enc_cpu = encoder_apply(cpu.module.encoder, mel_d.cpu())
            ids = torch.from_numpy(char_ids).long()
            start = torch.full((ids.shape[0], 1), START, dtype=torch.long)
            out, _ = asr.lstm_greedy_decode(heads["lstm"], enc, START, END, CHAR_MAX_LEN)
            out = out.cpu()
            char_check("char asr lstm", out, asr.lstm_teacher_forced(
                heads_cpu["lstm"], enc_cpu, torch.cat([start, out], 1)))
            tf = asr.mlp_head_char_logits(heads["mlp"], enc, ids.to(dev)).argmax(-1).cpu()
            char_check("char asr mlp", tf, asr.mlp_head_char_logits(
                heads_cpu["mlp"], enc_cpu, ids), max_steps=tf.shape[1])
            out, _ = asr.mlp_greedy_decode(heads["mlp"], enc, START, END, CHAR_MAX_LEN)
            out = out.cpu()
            char_check("char asr mlp real_decode", out, asr.mlp_head_char_logits(
                heads_cpu["mlp"], enc_cpu, torch.cat([start, out], 1)))
    QUANTUM_STAGES["char asr"] = results
    return paths, heads["lstm"], vocab, results["char asr lstm"]


def cli_phase(port, gpu, lstm, vocab, lstm_result, smi):
    """(d) both evaluation CLIs in this process with ``--device cuda`` from a
    temporary directory: the quantum ASR CLI on a numpy-pickle
    checkpoint written here in the JAX package's layout (the quantum
    encoder and the LSTM head of phase (c)), its CER equal to phase (c)'s
    on the same items; the classification CLI on classical tiny (the stem
    kernel launched) and on quantum tiny (never)."""
    import os
    import pickle
    import shutil
    import tempfile

    from qasr_ijcnlp_tpu_torch.cli import evaluate_quantum_whisper_asr as qcli
    from qasr_ijcnlp_tpu_torch.cli import evaluate_whisper_pretrained_modified_gspeech as gcli
    from qasr_ijcnlp_tpu_torch.models.convert import to_jax_encoder, to_jax_head

    dims = gpu.dims
    work = tempfile.mkdtemp(prefix="qasr_quantum_cli_")
    ckpt = os.path.join(work, "best_cer")
    with open(ckpt + ".pkl", "wb") as f:
        pickle.dump({"encoder": to_jax_encoder(gpu.module.encoder, dims),
                     "head": to_jax_head(lstm)}, f)
    with open(ckpt + ".meta.json", "w") as f:
        json.dump({"char_vocab": vocab.to_json()}, f)
    here = os.getcwd()
    os.chdir(work)
    paths, out = {}, {}
    try:
        runs = (
            ("cli quantum asr", qcli.main, ["--model_path", ckpt, "--batch_size",
                                            str(CHAR_BATCH), "--max_samples", str(CHAR_ITEMS),
                                            "--max_text_len", str(CHAR_MAX_LEN)],
             quantum_encoder_expect(dims, 2, CHAR_ITEMS)),
            ("cli gspeech classical", gcli.main, ["--batch_size", "16", "--max_samples", "16",
                                                  "--n_repeats", "2"],
             {**FUSED_EXPECT, "mel": 16, "stem": 1, "attn": 4, "finish": 4}),
            ("cli gspeech quantum", gcli.main, ["--model_size", "quantum-tiny",
                                                "--batch_size", "16", "--max_samples", "16"],
             quantum_encoder_expect(dims, 1, 16)),
        )
        for label, main_fn, argv, expect in runs:
            cs = zero_counters()
            t0 = time.perf_counter()
            out[label] = main_fn(argv + ["--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            paths[label] = read_counters(cs)
            expect_launches(label, paths[label], expect)
            log(f"{label}: " + json.dumps({k: v for k, v in out[label].items()
                                           if k in ("cer", "wer", "accuracy")})
                + f" ({seconds:.2f} s; {smi})")
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    if (out["cli quantum asr"]["cer"], out["cli quantum asr"]["wer"]) != \
            (lstm_result["cer"], lstm_result["wer"]):
        raise AssertionError(f"quantum ASR CLI: CER/WER {out['cli quantum asr']['cer']}, "
                             f"{out['cli quantum asr']['wer']} differ from the in-process "
                             f"evaluation's {lstm_result['cer']}, {lstm_result['wer']}")
    log("quantum ASR CLI: CER and WER equal to the in-process evaluation of the same "
        "checkpoint")
    for label in ("cli gspeech classical", "cli gspeech quantum"):
        if not 0.0 <= out[label]["accuracy"] <= 1.0:
            raise AssertionError(f"{label}: accuracy {out[label]['accuracy']}")
    QUANTUM_STAGES["cli"] = {k: {m: v for m, v in o.items() if m in ("cer", "wer", "accuracy")}
                             for k, o in out.items()}
    return paths


def quantum_phases(port, dev, smi):
    """Phases (a)-(d): the source paper's model on the card."""
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims

    t0 = time.perf_counter()
    paths = quantum_tiny_path(port, dev, smi)
    paths.update(quantum_large_phase(port, dev, smi))
    gpu, cpu = quantum_model(port, tiny_dims(), dev)
    cpaths, lstm, vocab, lstm_result = char_asr_phase(port, gpu, cpu, dev, smi)
    paths.update(cpaths)
    paths.update(cli_phase(port, gpu, lstm, vocab, lstm_result, smi))
    del gpu, cpu, lstm
    gc.collect()
    torch.cuda.empty_cache()
    QUANTUM_STAGES["seconds"] = time.perf_counter() - t0
    log(f"quantum phases seconds: {QUANTUM_STAGES['seconds']:.1f}")
    return paths


def quantum_run(port, dev, smi):
    """``python3 chip_smoke.py --quantum``: phases (a)-(d) alone, with
    their launch counts and checks as in the full run; the stages and
    launches as one JSON line."""
    paths = quantum_phases(port, dev, smi)
    log(json.dumps({"quantum_stages": QUANTUM_STAGES, "quantum_launches": paths}))
    log(smi)


# -- training: gradients through the card's kernels, the trainers, large-v3 --------------

# Items and batch of the training phases (synthetic LibriSpeech / Speech
# Commands), and the learning rate of the one-step checks.
TRAIN_ITEMS, TRAIN_BATCH, STEP_LR = 16, 8, 1e-3
# One step on the card against the CPU plain path from equal weights and
# batch (f32): the loss within 1e-4 relative; each trainable leaf's
# gradient within GRAD_TOL of its largest magnitude (the card's forward
# runs the 3xTF32 kernels, each within 1e-5 of fp32, through the trunk and
# the head, and its backward the plain versions in another summation
# order); each trainable leaf's update within UPDATE_TOL of the CPU's in
# L2 norm (Adam moves an element by g / (|g| + eps) lr: where |g| is near
# eps = 1e-6, as in the embedding rows of tokens the batch lacks, that is
# as sensitive as 1 / eps to the gradient's last bits, so single elements
# may differ by a good part of lr); the frozen trunk bit for bit.
GRAD_TOL, UPDATE_TOL = 1e-3, 1e-2
# Stages, times and launches of the training phases.
TRAIN_STAGES = {}


def grad_step_check(label, card, cpu, loss_fn, mask, batch, expect, smi):
    """One optimizer step of ``card`` and of ``cpu`` (modules with equal
    weights) on ``batch`` (numpy): loss, every trainable gradient (none
    missing, finite) and the parameters after the step against the CPU's;
    frozen parameters bit-identical; the card's forward and backward
    counted (``expect``: every kernel's Function launches in the forward
    only)."""
    from qasr_ijcnlp_tpu_torch.train import loops, step as tstep

    out = {}
    for side, module in (("card", card), ("cpu", cpu)):
        dev = next(module.parameters()).device
        mel, ids = (torch.from_numpy(np.ascontiguousarray(b)).to(dev) for b in batch)
        ids = ids.long()
        tx = tstep.make_optimizer(STEP_LR, trainable_mask=mask)
        with loops._trainable(module, tx.trainable_mask):
            named = tx.trainable(module)
            before = {n: p.detach().clone() for n, p in module.named_parameters()}
            cs = zero_counters()
            t0 = time.perf_counter()
            loss = loss_fn(module, mel, ids)
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
            if side == "card":
                launches = read_counters(cs)
                seconds = time.perf_counter() - t0
            missing = [n for (n, _), g in zip(named, grads) if g is None]
            if missing:
                raise AssertionError(f"{label} ({side}): no gradient for {missing[:5]}")
            bad = [n for (n, _), g in zip(named, grads) if not torch.isfinite(g).all()]
            if bad:
                raise AssertionError(f"{label} ({side}): non-finite gradient of {bad[:5]}")
            state, met = tstep.make_train_step(loss_fn, tx)(tstep.init_state(module, tx),
                                                            mel, ids)
            if int(met["skipped"]):
                raise AssertionError(f"{label} ({side}): the step was skipped")
            after = {n: p.detach().clone() for n, p in module.named_parameters()}
        frozen = [n for n in after if n not in tx.trainable_mask] if mask is not None else []
        moved = [n for n in frozen if not torch.equal(after[n], before[n])]
        if moved:
            raise AssertionError(f"{label} ({side}): frozen parameters moved: {moved[:5]}")
        out[side] = dict(loss=loss.item(), grads={n: g.detach().cpu() for (n, _), g in
                                                   zip(named, grads)},
                         update={n: (after[n] - before[n]).cpu() for n, _ in named},
                         frozen=len(frozen))
    expect_launches(f"{label}, forward + backward", launches, expect)
    c, p = out["card"], out["cpu"]
    if abs(c["loss"] - p["loss"]) > 1e-4 * abs(p["loss"]):
        raise AssertionError(f"{label}: loss {c['loss']} vs the CPU's {p['loss']}")
    worst_g = worst_p = 0.0
    for n, g in p["grads"].items():
        err = float((c["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        worst_g = max(worst_g, err)
        if err > GRAD_TOL:
            raise AssertionError(f"{label}: gradient of {n} off by {err:.2e} of its max")
        du, dp = c["update"][n], p["update"][n]
        err = float((du - dp).norm()) / max(float(dp.norm()), 1e-30)
        worst_p = max(worst_p, err)
        if err > UPDATE_TOL:
            raise AssertionError(f"{label}: the update of {n} off by {err:.2e} (L2, relative)")
    TRAIN_STAGES[label] = {"loss": c["loss"], "cpu_loss": p["loss"],
                           "trainable_leaves": len(p["grads"]), "frozen_leaves": c["frozen"],
                           "worst_grad_rel_err": worst_g, "worst_update_rel_err": worst_p,
                           "forward_backward_s": seconds}
    log(f"{label}: loss {c['loss']:.6f} (CPU {p['loss']:.6f}), {len(p['grads'])} trainable "
        f"leaves with finite gradients within {worst_g:.2e} of the CPU's, updates within "
        f"{worst_p:.2e} (L2), {c['frozen']} frozen leaves bit-identical ({smi})")
    return launches


def train_grad_phase(port, dev, smi):
    """(a) one step of the quantum tiny char-ASR model (LSTM head, B=8, f32;
    trainable: the quantum layers and the head) and of the classical tiny
    token model (every leaf trains) on the card and on the CPU plain path."""
    from torch import nn

    from qasr_ijcnlp_tpu_torch.data import (
        CharASRView, CharVocabulary, TokenASRView, dataset_texts, load_librispeech,
    )
    from qasr_ijcnlp_tpu_torch.models import asr
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.quantum import trainable_mask
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params
    from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer
    from qasr_ijcnlp_tpu_torch.train import loops, step as tstep

    dims = tiny_dims()
    base = load_librispeech("train.100", TRAIN_BATCH, verbose=False)
    vocab = CharVocabulary.build(dataset_texts(base))
    view = CharASRView(base, vocab, CHAR_MAX_LEN, device=dev)
    batch = [np.stack(f) for f in zip(*(view[i] for i in range(TRAIN_BATCH)))]
    gpu, cpu = quantum_model(port, dims, dev, seed=SEED + 50)
    head = asr.init_lstm_decoder(torch.Generator().manual_seed(SEED + 51), dims.n_audio_state,
                                 vocab.num_chars, CHAR_HIDDEN, CHAR_LAYERS)
    card = nn.ModuleDict({"encoder": gpu.module.encoder, "head": copy.deepcopy(head).to(dev)})
    # a copy: a module on the CPU may share its tensors with the state dict
    host = nn.ModuleDict({"encoder": copy.deepcopy(cpu.module.encoder), "head": head})
    mask = trainable_mask(card, extra_names=("head",))
    paths = {"train char step": grad_step_check(
        "train char step (quantum tiny, LSTM head, B=8, f32)", card, host,
        loops.char_asr_loss_fn(loops.encoder_fn_for(gpu), "lstm"), mask, batch,
        quantum_encoder_expect(dims, 1, 0), smi)}
    del gpu, cpu, card, host

    tok = get_tokenizer(True, num_languages=99, language="en", task="transcribe")
    view = TokenASRView(base, tok, 64, dims.n_mels, device=dev)
    batch = [np.stack(f) for f in zip(*(view[i] for i in range(TRAIN_BATCH)))]
    sd = init_params(torch.Generator().manual_seed(SEED + 52), dims)
    card = port.WhisperModel.from_state_dict(sd, dims, dev).module
    host = port.WhisperModel.from_state_dict({k: v.clone() for k, v in sd.items()}, dims,
                                             "cpu").module
    paths["train token step"] = grad_step_check(
        "train token step (classical tiny, B=8, f32)", card, host, tstep.whisper_loss_fn(dims),
        None, batch, {**{k: 0 for k in FUSED_EXPECT}, **encoder_expect(dims, 1)}, smi)
    return paths


def _history_ok(path, label, epochs):
    with open(path) as f:
        hist = json.load(f)["epochs"]
    if [e["epoch"] for e in hist] != list(epochs):
        raise AssertionError(f"{label}: history epochs {[e['epoch'] for e in hist]}")
    for e in hist:
        if not math.isfinite(e["train_loss"]) or e["skipped"] != 0:
            raise AssertionError(f"{label}: epoch {e}")
    return hist


def train_cli_phase(port, dev, smi):
    """(b) the three trainer CLIs in this process with ``--device cuda`` from
    a temporary directory (removed after): 2 epochs over 16 synthetic
    items, checkpoints, histories and exact launches; then the token
    trainer resumed from its epoch-1 state for a third epoch."""
    import os
    import shutil
    import tempfile

    from qasr_ijcnlp_tpu_torch.cli import train_classical_whisper_asr as tcli
    from qasr_ijcnlp_tpu_torch.cli import train_quantum_whisper as qcli
    from qasr_ijcnlp_tpu_torch.cli import train_quantum_whisper_asr as acli
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims

    L = tiny_dims().n_audio_layer
    n_val = TRAIN_ITEMS // 4
    steps = -(-TRAIN_ITEMS // TRAIN_BATCH)  # optimizer steps an epoch
    zero = {k: 0 for k in FUSED_EXPECT}
    # the quantum trainers: the stem kernel never; K4/K5 once a layer per
    # training forward and per validation batch; K1 once an item a pass
    asr_expect = {**zero, "mel": 2 * (TRAIN_ITEMS + n_val), "attn": 2 * L * (steps + 1),
                  "finish": 2 * L * (steps + 1)}
    clf_expect = {**zero, "mel": 2 * (TRAIN_ITEMS + n_val) + n_val, "attn": L * 5,
                  "finish": L * 5}  # one batch of 16 an epoch, 2 epochs of train + val, test
    # the token trainer, --grad_accum 2 --remat: two micro-batches a step, each
    # a stem pass and every block twice (forward, then its recompute in the
    # backward); one validation batch an epoch
    epoch_tok = {"mel": TRAIN_ITEMS + n_val, "stem": 2 * steps + 1,
                 "attn": (2 * steps) * 2 * L + L, "finish": (2 * steps) * 2 * L + L}
    tok_expect = {**zero, **{k: 2 * v for k, v in epoch_tok.items()}}
    work = tempfile.mkdtemp(prefix="qasr_train_cli_")
    here = os.getcwd()
    os.chdir(work)
    paths, out = {}, {}
    common = ["--epochs", "2", "--max_samples", str(TRAIN_ITEMS), "--device", "cuda"]
    runs = (
        ("cli train_quantum_whisper_asr", acli.main,
         common + ["--batch_size", str(TRAIN_BATCH), "--checkpoint_dir", "ck_asr"], asr_expect,
         "quantum_whisper_asr_training_history.json", ("best_cer", "best_wer"), "ck_asr"),
        ("cli train_quantum_whisper", qcli.main,
         common + ["--batch_size", "16", "--checkpoint_dir", "ck_clf"], clf_expect,
         "quantum_whisper_training_history.json", ("best_accuracy", "best_loss", "best_wer"),
         "ck_clf"),
        ("cli train_classical_whisper_asr", tcli.main,
         common + ["--model_size", "tiny", "--batch_size", str(TRAIN_BATCH), "--grad_accum",
                   "2", "--remat", "--save_every", "1", "--warmup_epochs", "1",
                   "--checkpoint_dir", "ck_tok"], tok_expect,
         "classical_whisper_asr_training_history.json",
         ("best_wer", "best_wer_state", "state_epoch_0", "state_epoch_1"), "ck_tok"),
    )
    try:
        for label, main_fn, argv, expect, hist, ckpts, ck_dir in runs:
            cs = zero_counters()
            t0 = time.perf_counter()
            out[label] = main_fn(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            paths[label] = read_counters(cs)
            expect_launches(label, paths[label], expect)
            epochs = _history_ok(hist, label, range(2))
            missing = [c for c in ckpts if not os.path.exists(os.path.join(ck_dir, c + ".pkl"))]
            if missing:
                raise AssertionError(f"{label}: no checkpoint {missing}")
            TRAIN_STAGES[label] = {"seconds": seconds, "epochs": epochs,
                                   "best": out[label]["tracker"].best}
            log(f"{label}: {seconds:.1f} s, train_loss "
                f"{[round(e['train_loss'], 4) for e in epochs]}, best "
                f"{out[label]['tracker'].best} ({smi})")
        label = "cli train_classical_whisper_asr resumed"
        cs = zero_counters()
        resumed = tcli.main(runs[2][2][:1] + ["3"] + runs[2][2][2:]
                            + ["--resume_state", "ck_tok/state_epoch_1"])
        paths[label] = read_counters(cs)
        expect_launches(label, paths[label], {**zero, **epoch_tok})
        _history_ok(runs[2][4], label, [2])
        if int(resumed["state"].step) != 3 * steps:
            raise AssertionError(f"{label}: step {int(resumed['state'].step)}, expected "
                                 f"{3 * steps}")
        log(f"{label}: epoch 2 only, step count {int(resumed['state'].step)} = 3 x {steps} "
            f"({smi})")
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    TRAIN_STAGES["resume_step"] = int(resumed["state"].step)
    return paths


def train_large_phase(port, dev, smi, steps=3):
    """(c) token-ASR train steps at large-v3's full width and depth (B=2,
    f32, remat; weights from a seeded torch.Generator): the stem (K3's
    kernel at D 1280) once a step, K8 32 times in the forward and 32 in the
    blocks' recompute; step times (CUDA events) and peak memory; the loss
    against the plain versions' (``set_flash_attention(False)``)."""
    from qasr_ijcnlp_tpu_torch.data import TokenASRView, load_librispeech
    from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.tokenizer import get_tokenizer
    from qasr_ijcnlp_tpu_torch.train import loops, schedule, step as tstep

    dims = dims_for("large-v3")
    tok = get_tokenizer(True, num_languages=tmodel.num_languages(dims), language="en",
                        task="transcribe")
    view = TokenASRView(load_librispeech("train.100", 2, verbose=False), tok, 64, dims.n_mels,
                        device=dev)
    mel, ids = (torch.from_numpy(np.stack(f)).to(dev) for f in zip(view[0], view[1]))
    ids = ids.long()
    module = port.WhisperModel.from_state_dict(
        tmodel.init_params(torch.Generator().manual_seed(SEED + 60), dims), dims, dev).module
    loss_fn = tstep.whisper_loss_fn(dims)
    tx = tstep.make_optimizer(schedule.warmup_cosine(1e-4, 0, 10))
    expect = {**{k: 0 for k in FUSED_EXPECT}, "stem": 1, "packed": 2 * dims.n_audio_layer}
    times, losses = [], []
    tmodel.set_remat(True)
    try:
        with loops._trainable(module, None):
            state = tstep.init_state(module, tx)
            fn = tstep.make_train_step(loss_fn, tx)
            for i in range(steps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cs = zero_counters()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                state, met = fn(state, mel, ids)
                ev[1].record()
                ev[1].synchronize()
                times.append(ev[0].elapsed_time(ev[1]))
                launches = read_counters(cs)
                expect_launches(f"large-v3 train step {i}", launches, expect)
                if int(met["skipped"]) or not math.isfinite(float(met["loss"])):
                    raise AssertionError(f"large-v3 train step {i}: {met}")
                losses.append(float(met["loss"]))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with torch.no_grad():
            on = float(loss_fn(module, mel, ids))
            tmodel.set_flash_attention(False)
            off = float(loss_fn(module, mel, ids))
    finally:
        tmodel.set_remat(False)
        tmodel.set_flash_attention(None)
    if abs(on - off) > 1e-3 * abs(off):
        raise AssertionError(f"large-v3: loss {on} with the kernels, {off} without")
    TRAIN_STAGES["large-v3 train step"] = {"ms": times, "median_ms": float(np.median(times)),
                                           "peak_gib": peak, "losses": losses,
                                           "loss_kernels_on_off": [on, off]}
    log(f"large-v3 train step (B=2, f32, remat): {[round(t, 1) for t in times]} ms, median "
        f"{np.median(times):.1f} ms, peak {peak:.2f} GiB allocated, losses "
        f"{[round(x, 4) for x in losses]}, loss with the kernels {on:.6f} vs without "
        f"{off:.6f} ({smi})")
    del module, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"large-v3 train step": launches}


def train_ab_phase(port, dev, smi, repeats=3):
    """(d) the tiny token train step from PCM (mel, forward, backward, AdamW)
    at B=8 in f32 and bf16, kernels on against ``set_flash_attention(False)``
    + ``set_fused_mel(False)`` (every kernel's plain version), in turns;
    median of ``repeats`` by CUDA events."""
    from qasr_ijcnlp_tpu_torch import audio
    from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.train import loops, step as tstep

    dims = tiny_dims()
    pcm = torch.from_numpy(synthetic_pcm(TRAIN_BATCH, SEED + 70)).to(dev)
    ids = torch.full((TRAIN_BATCH, 64), -100, dtype=torch.long)
    ids[:, :40] = torch.randint(220, 5000, (TRAIN_BATCH, 40),
                                generator=torch.Generator().manual_seed(SEED + 71))
    ids = ids.to(dev)
    on_expect = {**{k: 0 for k in FUSED_EXPECT}, "mel": 1, **encoder_expect(dims, 1)}
    res, paths = {}, {}
    for dt in ("float32", "bfloat16"):
        module = port.WhisperModel.from_state_dict(
            tmodel.init_params(torch.Generator().manual_seed(SEED + 72), dims), dims, dev).module
        tx = tstep.make_optimizer(STEP_LR)
        fn = tstep.make_train_step(tstep.whisper_loss_fn(dims, dt), tx)
        with loops._trainable(module, None):
            state = [tstep.init_state(module, tx)]

            def step():
                mel = port.log_mel_spectrogram(pcm, dims.n_mels, device=None)
                state[0], m = fn(state[0], mel, ids)
                return m

            ms = {"on": [], "off": []}
            for rep in range(repeats + 1):
                for mode in ("on", "off") if rep % 2 else ("off", "on"):
                    kernels = None if mode == "on" else False
                    tmodel.set_flash_attention(kernels)
                    audio.set_fused_mel(kernels)
                    try:
                        cs = zero_counters()
                        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                        ev[0].record()
                        m = step()
                        ev[1].record()
                        ev[1].synchronize()
                    finally:
                        tmodel.set_flash_attention(None)
                        audio.set_fused_mel(None)
                    launches = read_counters(cs)
                    expect_launches(f"tiny train step {dt} kernels {mode}", launches,
                                    on_expect if mode == "on" else {})
                    paths[f"tiny train step {dt} kernels {mode}"] = launches
                    if int(m["skipped"]):
                        raise AssertionError(f"tiny train step {dt} {mode}: skipped")
                    if rep:  # the first round warms up
                        ms[mode].append(ev[0].elapsed_time(ev[1]))
        res[dt] = {mode: {"ms": v, "median_ms": float(np.median(v))} for mode, v in ms.items()}
        log(f"tiny train step B={TRAIN_BATCH} {dt} from PCM: kernels on "
            f"{res[dt]['on']['median_ms']:.2f} ms, off {res[dt]['off']['median_ms']:.2f} ms "
            f"(median of {repeats}; off/on "
            f"{res[dt]['off']['median_ms'] / res[dt]['on']['median_ms']:.2f}) ({smi})")
        del module, state
    TRAIN_STAGES["kernels on vs off"] = res
    return {k: v for k, v in paths.items() if k.endswith("float32 kernels on")}


def eval_cli_phase(port, dev, smi):
    """(e) the two classical evaluation CLIs at tiny with ``--device cuda``:
    the batched one over 16 synthetic items at B=16 (K1, the stem, K4 and
    the finish once a batch), the transcribe one over 4 (K1 once an item;
    the encoder once a decode, whatever the temperature ladder asks), no
    failure sentinel."""
    import os
    import shutil
    import tempfile

    from qasr_ijcnlp_tpu_torch.cli import evaluate_pretrained_whisper as bcli
    from qasr_ijcnlp_tpu_torch.cli import evaluate_pretrained_whisper_asr as tcli

    zero = {k: 0 for k in FUSED_EXPECT}
    work = tempfile.mkdtemp(prefix="qasr_eval_cli_")
    paths = {}
    try:
        cs = zero_counters()
        t0 = time.perf_counter()
        b = bcli.main(["--model_size", "tiny", "--batch_size", "16", "--max_samples", "16",
                       "--device", "cuda", "--output", os.path.join(work, "b.json")])
        torch.cuda.synchronize()
        bs = time.perf_counter() - t0
        paths["cli evaluate_pretrained_whisper"] = read_counters(cs)
        expect_launches("cli evaluate_pretrained_whisper", paths["cli evaluate_pretrained_whisper"],
                        {**zero, "mel": 1, "stem": 1, "attn": 4, "finish": 4})
        if len(b["hypotheses"]) != 16 or any(h is None for h in b["hypotheses"]):
            raise AssertionError("evaluate_pretrained_whisper: missing hypotheses")
        cs = zero_counters()
        t0 = time.perf_counter()
        t = tcli.main(["--model_size", "tiny", "--max_samples", "4", "--device", "cuda",
                       "--output", os.path.join(work, "t.json")])
        torch.cuda.synchronize()
        ts = time.perf_counter() - t0
        got = paths["cli evaluate_pretrained_whisper_asr"] = read_counters(cs)
        passes = got["stem"]
        expect_launches("cli evaluate_pretrained_whisper_asr", got,
                        {**zero, "mel": 4, "stem": max(passes, 4), "attn": 4 * passes,
                         "finish": 4 * passes})
        if tcli.SENTINEL in t["predictions"] or len(t["predictions"]) != 4:
            raise AssertionError(f"evaluate_pretrained_whisper_asr: {t['predictions']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    TRAIN_STAGES["eval clis"] = {
        "batched": {"wer": b["wer"], "cer": b["cer"], "rtf": b["rtf"], "seconds": bs},
        "transcribe": {"wer": t["wer"], "cer": t["cer"], "seconds": ts,
                       "encoder_passes": passes}}
    log(f"cli evaluate_pretrained_whisper (tiny, 16 items, B=16): WER {b['wer']:.4f} CER "
        f"{b['cer']:.4f} RTF {b['rtf']:.1f} audio-s/s, {bs:.2f} s; "
        f"cli evaluate_pretrained_whisper_asr (4 items): WER {t['wer']:.4f} CER {t['cer']:.4f}, "
        f"{passes} encoder passes, {ts:.2f} s ({smi})")
    return paths


def train_phases(port, dev, smi):
    """Phases (a)-(e): training and the classical evaluation CLIs on the
    card."""
    t0 = time.perf_counter()
    paths = train_grad_phase(port, dev, smi)
    gc.collect()
    paths.update(train_cli_phase(port, dev, smi))
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(train_large_phase(port, dev, smi))
    paths.update(train_ab_phase(port, dev, smi))
    paths.update(eval_cli_phase(port, dev, smi))
    gc.collect()
    torch.cuda.empty_cache()
    TRAIN_STAGES["seconds"] = time.perf_counter() - t0
    log(f"training phases seconds: {TRAIN_STAGES['seconds']:.1f}")
    return paths


def train_run(port, dev, smi):
    """``python3 chip_smoke.py --train``: phases (a)-(e) alone, with their
    launch counts and checks as in the full run; the stages and launches as
    one JSON line."""
    paths = train_phases(port, dev, smi)
    log(json.dumps({"train_stages": TRAIN_STAGES, "train_launches": paths}, default=str))
    log(smi)


# -- deployment artifacts, distillation, the from-scratch model --------------------------

# Artifacts: B, and the requests of the three tiny artifacts (kernel-free
# fp, kernels fp, kernels int8) and of large-v3's (kernels, not saved), all
# from 30-s PCM in f32.
EXPORT_B = 8
# Stages, sizes and times of the export and distillation phases.
EXPORT_STAGES = {}
# Distillation: a medium teacher and a tiny draft at full width and depth,
# B=8, labels of 48 tokens, DISTILL_STEPS steps over two batches (a third
# held out), lr 1e-3.  The card's run against the same steps on the
# kernels-off plain path on the card from equal weights and labels: the
# first step's loss within 1e-4 relative (the training phases' one-step rule), later
# steps within DISTILL_DRIFT (their weights differ by the earlier updates'
# rounding, up to UPDATE_TOL of an update each step).
DISTILL_STEPS, DISTILL_LEN, DISTILL_DRIFT = 6, 48, 1e-3


def launch_profile(fn):
    """(device ms, CUDA kernel launches) of one warm call of ``fn``, from
    ``torch.profiler``'s CUDA events; (None, None) where the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t:
            us += t
            n += e.count
    return (us / 1000, n) if n else (None, None)


def event_ms(fn, repeats=3):
    """CUDA-event ms of one warm call of ``fn`` (mean of ``repeats``) and
    its last result."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats, out


def artifact_tokens(export, out, meta):
    return [list(t) for t in export.decode_artifact_tokens(out[0], out[1], meta)]


def check_artifact(export, call, meta, x, label, st, want, smi, repeats=3, profile=False):
    """Call an artifact on ``x`` with every counter set to 0 just before,
    hold its tokens to ``want`` (the live decode's) and time it (CUDA
    events; with ``profile``, its device time and kernel launches too).
    Returns the launches; fills ``st``."""
    cs = zero_counters()
    out = call(x)
    launches = read_counters(cs)
    got = artifact_tokens(export, out, meta)
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"{label}: request {bad}'s tokens differ from the live "
                             f"decode's:\n{got[bad]}\n{want[bad]}")
    st["call_ms"], _ = event_ms(lambda: call(x), repeats)
    if profile:
        st["device_ms"], st["kernel_launches"] = launch_profile(lambda: call(x))
    log(f"{label}: exported in {st['export_s']:.1f} s"
        + (f", {st['file_mb']:.1f} MB file (save {st['save_s']:.1f} s, load "
           f"{st['load_s']:.1f} s)" if "file_mb" in st else " (not saved)")
        + f", {x.shape[0]} requests token-exact against the live decode, call "
        f"{st['call_ms']:.1f} ms"
        + (f" (device {st['device_ms']} ms in {st['kernel_launches']} kernel launches)"
           if profile else "") + f" ({smi})")
    return launches


# The tiny artifacts: kind -> (with_kernels, quantize).
TINY_EXPORTS = {"kernel-free": (False, None), "kernels": (True, None), "int8": (True, "int8")}
# The exporting processes (``--export-child``, ``--export-large``, the
# export CLI): name -> (Popen, its log), and their directory.  The traces
# are host work of a minute (tiny) to three (large-v3), so the full run
# starts every exporting process at once, just after the build, and they
# trace while this process runs the earlier paths; each leaves its device
# work (large-v3's live decode and calls) until this process reaches the
# export phase and hands it the card (``go``).
BACKGROUND = {}


def start_background(names):
    """Start the exporting processes in ``names`` that are not running yet
    (each with one torch thread)."""
    import os
    import tempfile

    if "dir" not in BACKGROUND:
        BACKGROUND["dir"] = tempfile.mkdtemp(prefix="qasr_export_")
    work = BACKGROUND["dir"]
    root = os.path.dirname(os.path.abspath(__file__))
    me = [sys.executable, os.path.abspath(__file__)]
    argv = {kind: me + ["--export-child", kind, work] for kind in TINY_EXPORTS}
    argv["large"] = me + ["--export-large", work]
    argv["cli"] = [sys.executable, "-m", "qasr_ijcnlp_tpu_torch.cli.export_decode", "--model",
                   "tiny", "--batch", str(TRAIN_BATCH), "--sample_len", "16", "--quantize",
                   "int8", "--with_kernels", "--device", "cuda",
                   "--out", os.path.join(work, "cli.qasrt")]
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    for name in names:
        if name not in BACKGROUND:
            log_path = os.path.join(work, name + ".log")
            BACKGROUND[name] = (subprocess.Popen(argv[name], cwd=work, env=env,
                                                 stdout=open(log_path, "w"),
                                                 stderr=subprocess.STDOUT), log_path)


def wait_background(name, label):
    """Wait for exporting process ``name``; raise with its log's tail if it
    failed."""
    proc, log_path = BACKGROUND[name]
    if proc.wait() != 0:
        with open(log_path) as f:
            log(f.read()[-4000:])
        raise AssertionError(f"{label}: the background process failed")


def stop_background():
    """Stop every exporting process still running and remove their
    directory."""
    import shutil

    for name, value in list(BACKGROUND.items()):
        if name not in ("dir", "par_dir") and value[0].poll() is None:
            value[0].kill()
            value[0].wait()
    for name in ("dir", "par_dir"):
        if name in BACKGROUND:
            shutil.rmtree(BACKGROUND[name], ignore_errors=True)
    BACKGROUND.clear()


def tiny_export_model(port, dev):
    """Tiny at full width and depth, random weights from SEED + 60."""
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    dims = tiny_dims()
    return port.WhisperModel.from_state_dict(
        init_params(torch.Generator().manual_seed(SEED + 60), dims), dims, dev,
        name="tiny (random)")


def export_child(kind, out_dir):
    """``python3 chip_smoke.py --export-child KIND DIR``: export tiny's
    artifact KIND (f32, from audio, B=EXPORT_B) into DIR/KIND.qasrt and its
    export and save seconds into DIR/KIND.json."""
    import os

    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch import export

    torch.set_num_threads(1)
    with_kernels, quantize = TINY_EXPORTS[kind]
    model = tiny_export_model(port, torch.device("cuda", 0))
    t0 = time.perf_counter()
    ep, meta = export.export_greedy_decode(model, options(port, fp16=False), batch=EXPORT_B,
                                           from_audio=True, device="cuda", quantize=quantize,
                                           with_kernels=with_kernels)
    t1 = time.perf_counter()
    path = os.path.join(out_dir, kind + ".qasrt")
    export.save_artifact(path, ep, meta)
    st = {"export_s": t1 - t0, "save_s": time.perf_counter() - t1,
          "file_mb": os.path.getsize(path) / 1e6, "with_kernels": with_kernels,
          "quantize": quantize}
    with open(path + ".json", "w") as f:
        json.dump(st, f)


def export_large_child(out_dir):
    """``python3 chip_smoke.py --export-large DIR``: large-v3 at full width
    and depth (random weights from SEED + 62), B=EXPORT_B, f32, from 30-s
    PCM, exported with its kernels; then, once DIR/go exists (the card is
    this process's), the live decode and the program's call (not saved)
    with every counter set to 0 just before each, the tokens held equal,
    the launches to each other and to large-v3's expectation, the results
    into DIR/large.json."""
    import os

    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch import export
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    large = dims_for("large-v3")
    gpu = port.WhisperModel.from_state_dict(
        init_params(torch.Generator().manual_seed(SEED + 62), large), large, dev,
        name="large-v3 (random)")
    t0 = time.perf_counter()
    ep, meta = export.export_greedy_decode(gpu, options(port, fp16=False), batch=EXPORT_B,
                                           device="cuda", with_kernels=True)
    st = {"export_s": time.perf_counter() - t0, "with_kernels": True, "quantize": None}
    program = ep.module()
    del ep
    while not os.path.exists(os.path.join(out_dir, "go")):
        time.sleep(0.5)
    pcm = synthetic_pcm(EXPORT_B, SEED + 63)
    cs = zero_counters()
    want, live_ms = live_tokens(port, gpu, pcm, repeats=1)
    live = {k: v // 2 for k, v in read_counters(cs).items()}  # a warm-up, a timed call

    def call(x):
        with torch.no_grad():
            return program(x)

    label = "large-v3 export kernels"
    launches = check_artifact(export, call, meta, torch.from_numpy(pcm).to(dev), label, st,
                              want, "", repeats=1)
    if launches != live:
        raise AssertionError(f"{label}: launches {launches} differ from the live decode's "
                             f"{live}")
    expect_launches(label, launches, {**large_expect(large), "mel": 1, "stem": 1})
    with open(os.path.join(out_dir, "large.json"), "w") as f:
        json.dump({"stages": st, "live_ms": live_ms, "live": live, "launches": launches}, f)


def live_tokens(port, model, pcm, kernels=True, repeats=3):
    """The live f32 decode's tokens (and its CUDA-event ms, PCM to results,
    mean of ``repeats`` after a warm-up) with the kernels on, or with
    ``set_flash_attention(False)`` + ``set_fused_mel(False)``."""
    from qasr_ijcnlp_tpu_torch import audio
    from qasr_ijcnlp_tpu_torch.models import whisper

    if not kernels:
        whisper.set_flash_attention(False)
        audio.set_fused_mel(False)
    try:
        ms, res = event_ms(lambda: run_requests(port, model, pcm, fp16=False), repeats)
    finally:
        whisper.set_flash_attention(None)
        audio.set_fused_mel(None)
    return [list(r.tokens) for r in res], ms


def export_phases(port, dev, smi):
    """(a) large-v3 at B=8 with kernels (K1 at 128 bins, the stem, K8 inside
    the program), exported, then called without saving, by a process of
    its own (``--export-large``); (b) tiny at full width and depth, B=8, 64
    tokens, from 30-s PCM: a kernel-free fp artifact (against the live
    decode with the kernels off), a kernels fp artifact (against the live
    decode; its launches equal the live path's encoder launches) and a
    kernels int8 artifact (against the live decode of the dequantized
    weights), each exported and saved by a process of its own and loaded
    and called here; (c) prompt encoding with the native BPE core and in
    pure Python.  The exporting processes are started here unless the full
    run started them already."""
    import os

    from qasr_ijcnlp_tpu_torch import export
    from qasr_ijcnlp_tpu_torch.models.quantize import dequantize_params, quantize_params

    t_phase = time.perf_counter()
    start_background(["large", *TINY_EXPORTS])
    work = BACKGROUND["dir"]
    paths = {}
    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(work, "go"), "w"):
        pass
    label = "large-v3 export kernels"
    wait_background("large", label)
    with open(os.path.join(work, "large.json")) as f:
        large = json.load(f)
    st = EXPORT_STAGES[label] = large["stages"]
    EXPORT_STAGES["large-v3 live decode"] = {"ms": large["live_ms"]}
    paths["large-v3 live decode"], paths[label] = large["live"], large["launches"]
    log(f"{label}: exported in {st['export_s']:.1f} s (its own process, not saved), "
        f"{EXPORT_B} requests token-exact against the live decode, launches equal the live "
        f"path's {large['launches']}; live decode {large['live_ms']:.1f} ms, the artifact's "
        f"call {st['call_ms']:.1f} ms ({smi})")

    gpu = tiny_export_model(port, dev)
    dims = gpu.dims
    pcm = synthetic_pcm(EXPORT_B, SEED + 61)
    x = torch.from_numpy(pcm).to(dev)
    want_plain, plain_ms = live_tokens(port, gpu, pcm, kernels=False)
    cs = zero_counters()
    want, live_ms = live_tokens(port, gpu, pcm)
    live = {k: v // 4 for k, v in read_counters(cs).items()}  # a warm-up, 3 timed calls
    paths["tiny live decode"] = live
    dev_ms, n_launch = launch_profile(lambda: run_requests(port, gpu, pcm, fp16=False))
    EXPORT_STAGES["tiny live decode"] = {"ms": live_ms, "plain_ms": plain_ms,
                                         "device_ms": dev_ms, "kernel_launches": n_launch}
    log(f"tiny live decode B={EXPORT_B} f32: {live_ms:.1f} ms with the kernels (device "
        f"{dev_ms} ms in {n_launch} kernel launches), {plain_ms:.1f} ms without ({smi})")
    deq = port.WhisperModel.from_state_dict(
        dequantize_params(quantize_params(gpu.module, dims)), dims, dev)
    want_q, _ = live_tokens(port, deq, pcm)
    del deq
    wants = {"kernel-free": want_plain, "kernels": want, "int8": want_q}
    for kind in TINY_EXPORTS:
        label = f"tiny export {kind}"
        wait_background(kind, label)
        path = os.path.join(work, kind + ".qasrt")
        with open(path + ".json") as f:
            st = EXPORT_STAGES[label] = json.load(f)
        t0 = time.perf_counter()
        call, meta = export.load_artifact(path)
        st["load_s"] = time.perf_counter() - t0
        launches = check_artifact(export, call, meta, x, label, st, wants[kind], smi,
                                  profile=kind == "kernels")
        del call
        if kind == "kernel-free":
            expect_launches(label, launches, {})
            continue
        paths[label] = launches
        if launches != live:
            raise AssertionError(f"{label}: launches {launches} differ from the live "
                                 f"decode's {live}")
        expect_launches(label, launches, {**FUSED_EXPECT, **encoder_expect(dims, 1),
                                          "mel": 1})
    del gpu
    fp_mb = EXPORT_STAGES["tiny export kernels"]["file_mb"]
    q_mb = EXPORT_STAGES["tiny export int8"]["file_mb"]
    if not q_mb < 0.5 * fp_mb:
        raise AssertionError(f"int8 artifact {q_mb:.1f} MB is not under half the fp "
                             f"artifact's {fp_mb:.1f} MB")
    gc.collect()
    torch.cuda.empty_cache()
    EXPORT_STAGES["bpe"] = bpe_timing()
    EXPORT_STAGES["export seconds"] = time.perf_counter() - t_phase
    log(f"export phases seconds: {EXPORT_STAGES['export seconds']:.1f}")
    return paths


def bpe_timing(repeats=5):
    """Prompt encoding on the host: the native BPE core against the
    pure-Python merge, ids equal, the piece cache cleared before each pass
    (best of ``repeats``): 200 prompts of 60 seeded random words each (most
    pieces new: the merge's cost), and the 200 synthetic LibriSpeech
    transcripts (few distinct words)."""
    from qasr_ijcnlp_tpu_torch.data import load_librispeech
    from qasr_ijcnlp_tpu_torch.tokenizer import bpe

    rng = np.random.default_rng(SEED + 64)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = [" ".join("".join(rng.choice(letters, rng.integers(3, 11))) for _ in range(60))
             for _ in range(200)]
    base = load_librispeech("train.100", 200, verbose=False)
    corpora = {"random words": words,
               "transcripts": [base[i][1] for i in range(len(base))]}
    enc = bpe.get_encoding("multilingual")
    py = bpe.Encoding(enc.name, enc.pat_str, enc.ranks, enc.special_tokens)
    py._native = None
    out = {}
    for corpus, texts in corpora.items():
        row, ids = {}, {}
        for name, e in (("native", enc), ("python", py)):
            best = math.inf
            for _ in range(repeats):
                e._cache = {}
                t0 = time.perf_counter()
                ids[name] = [e.encode(" " + t) for t in texts]
                best = min(best, time.perf_counter() - t0)
            row[name + "_ms"] = best * 1e3
        if ids["native"] != ids["python"]:
            raise AssertionError(f"native BPE ids differ from the pure-Python merge's ({corpus})")
        row["ids"] = sum(map(len, ids["native"]))
        out[corpus] = row
        log(f"prompt encoding, {len(texts)} {corpus} ({row['ids']} ids, cold piece cache, best "
            f"of {repeats}): native {row['native_ms']:.1f} ms, pure Python "
            f"{row['python_ms']:.1f} ms (host)")
    return out


def distill_phase(port, dev, smi):
    """(a) ``distill_draft`` with a medium teacher and a tiny draft (B=8, 48
    tokens, DISTILL_STEPS steps, counted), the same steps on the kernels-off
    plain path from equal weights and labels, the agreement before and
    after, and the distilled draft under medium's speculative decode,
    token-exact against medium's greedy decode."""
    from qasr_ijcnlp_tpu_torch import audio
    from qasr_ijcnlp_tpu_torch.decode import DecodingTask
    from qasr_ijcnlp_tpu_torch.models import whisper
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for, tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params
    from qasr_ijcnlp_tpu_torch.train import distill, step as tstep

    t_dims, s_dims = dims_for("medium"), tiny_dims()
    teacher = port.WhisperModel.from_state_dict(
        init_params(torch.Generator().manual_seed(SEED + 70), t_dims), t_dims, dev,
        name="medium (random)")
    s_sd = init_params(torch.Generator().manual_seed(SEED + 71), s_dims)
    student = port.WhisperModel.from_state_dict(s_sd, s_dims, dev, name="tiny draft")
    plain = port.WhisperModel.from_state_dict({k: v.clone() for k, v in s_sd.items()},
                                              s_dims, dev, name="tiny draft (plain)")
    mels = port.log_mel_spectrogram(synthetic_pcm(3 * EXPORT_B, SEED + 72), device=dev)
    batches = [mels[i * EXPORT_B:(i + 1) * EXPORT_B] for i in range(3)]
    held = batches.pop()
    label = distill.make_teacher_labeler(teacher, DISTILL_LEN)
    held_tokens = label(held)
    before = distill.agreement_rate(teacher, student, held, held_tokens)
    marks = []

    def on_log(step, loss):
        marks.append((time.perf_counter(), loss))

    cs = zero_counters()
    t0 = time.perf_counter()
    _, history = distill.distill_draft(teacher, student, batches, steps=DISTILL_STEPS,
                                       sample_len=DISTILL_LEN, log_every=1, on_log=on_log)
    seconds = time.perf_counter() - t0
    launches = read_counters(cs)
    # two label decodes (teacher encoder once each), then per step the
    # teacher's and the student's encoder forward
    L_t, L_s = t_dims.n_audio_layer, s_dims.n_audio_layer
    n = DISTILL_STEPS
    expect_launches("distill_draft (medium teacher, tiny draft, B=8, f32)", launches,
                    {**FUSED_EXPECT, "mel": 0, "stem": 2 + 2 * n, "attn": 2 * L_t + n * (L_t + L_s),
                     "finish": 2 * L_t + n * (L_t + L_s)})
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks[1:], marks[2:])]  # labels made
    after = distill.agreement_rate(teacher, student, held, held_tokens)

    # the same steps with the kernels off, from equal weights and labels
    labels = [torch.from_numpy(label(b)).to(dev) for b in batches]
    loss_fn = distill.distill_loss_fn(t_dims, s_dims)
    tx = tstep.make_optimizer(1e-3, weight_decay=1e-4, clip_norm=None)
    plain.module.requires_grad_(True)
    whisper.set_flash_attention(False)
    audio.set_fused_mel(False)
    try:
        state = tstep.init_state(plain.module, tx)
        step_fn = tstep.make_train_step(loss_fn, tx)
        plain_losses = []
        for i in range(n):
            state, met = step_fn(state, teacher.module, batches[i % 2], labels[i % 2])
            plain_losses.append(float(met["loss"]))
    finally:
        whisper.set_flash_attention(None)
        audio.set_fused_mel(None)
        plain.module.requires_grad_(False)
    for i, ((_, card), ref) in enumerate(zip(history, plain_losses)):
        tol = 1e-4 if i == 0 else DISTILL_DRIFT
        if abs(card - ref) > tol * abs(ref):
            raise AssertionError(f"distill step {i + 1}: loss {card} vs the kernels-off "
                                 f"path's {ref} (rel tol {tol:g})")
    base = port.decode(teacher, held, options(port, False))
    task = DecodingTask(teacher, options(port, False, extra={"draft": port.Draft(student, 4)}))
    with torch.inference_mode():
        spec = task.run(held)
    for i, (b, s) in enumerate(zip(base, spec)):
        if list(b.tokens) != list(s.tokens):
            raise AssertionError(f"speculative decode with the distilled draft: request {i} "
                                 f"differs from medium's greedy decode")
    EXPORT_STAGES["distill"] = {
        "seconds": seconds, "history": history, "plain_losses": plain_losses,
        "step_ms": step_ms, "agreement_before": before, "agreement_after": after,
        "spec_rounds": task.last_spec_rounds}
    log(f"distill_draft (medium -> tiny, B={EXPORT_B}, {DISTILL_LEN} tokens, {n} steps): "
        f"{seconds:.1f} s, {np.median(step_ms):.1f} ms a step (median of {len(step_ms)}), KL "
        f"{[round(l, 5) for _, l in history]} (kernels off: "
        f"{[round(l, 5) for l in plain_losses]}), held-out agreement {before:.3f} -> "
        f"{after:.3f}; medium's speculative decode with the draft token-exact "
        f"({task.last_spec_rounds} verify rounds for {EXPORT_B} x "
        f"{BENCH_OPTIONS['sample_len']} tokens) ({smi})")
    del teacher, student, plain
    gc.collect()
    torch.cuda.empty_cache()
    return {"distill_draft": launches}


def from_scratch_step_phase(port, dev, smi):
    """(b) one step of the from-scratch model (8-qubit quantum stem, tiny
    trunk, LSTM head, nothing frozen) on the card and on the CPU plain path
    from equal weights and batch (``grad_step_check``)."""
    from torch import nn

    from qasr_ijcnlp_tpu_torch.data import CharASRView, CharVocabulary, dataset_texts
    from qasr_ijcnlp_tpu_torch.data import load_librispeech
    from qasr_ijcnlp_tpu_torch.models import asr
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.quantum import QuantumWhisperModel, init_quantum_params
    from qasr_ijcnlp_tpu_torch.train import loops

    dims = tiny_dims()
    base = load_librispeech("train.100", TRAIN_BATCH, verbose=False)
    vocab = CharVocabulary.build(dataset_texts(base))
    view = CharASRView(base, vocab, CHAR_MAX_LEN, device=dev)
    batch = [np.stack(f) for f in zip(*(view[i] for i in range(TRAIN_BATCH)))]
    gen = torch.Generator().manual_seed(SEED + 80)
    sd = init_quantum_params(gen, dims, 8)
    gpu = QuantumWhisperModel.from_state_dict(sd, dims, dev)
    cpu = QuantumWhisperModel.from_state_dict({k: v.clone() for k, v in sd.items()}, dims,
                                              "cpu")
    head = asr.init_lstm_decoder(gen, dims.n_audio_state, vocab.num_chars, CHAR_HIDDEN,
                                 CHAR_LAYERS)
    card = nn.ModuleDict({"encoder": gpu.module.encoder, "head": copy.deepcopy(head).to(dev)})
    host = nn.ModuleDict({"encoder": cpu.module.encoder, "head": head})
    launches = grad_step_check(
        "from-scratch step (8 qubits, tiny trunk, LSTM head, nothing frozen, B=8, f32)",
        card, host, loops.char_asr_loss_fn(loops.encoder_fn_for(gpu), "lstm"), None, batch,
        quantum_encoder_expect(dims, 1, 0), smi)
    return {"from-scratch step": launches}


def new_cli_phase(port, dev, smi):
    """(c) the three new CLIs with ``--device cuda`` from a temporary
    directory (removed after), over 16 synthetic items: the distillation
    CLI (tiny teacher and draft, 2 steps) and the from-scratch trainer (one
    epoch at B=8) in this process, and the export CLI (tiny, kernels, int8,
    B=8) in a process of its own (started with the other exporting
    processes, or by ``distill_phases``), whose artifact is called here over
    two batches of 8."""
    import os
    import shutil
    import tempfile

    from qasr_ijcnlp_tpu_torch import export
    from qasr_ijcnlp_tpu_torch.cli import distill_draft as dcli
    from qasr_ijcnlp_tpu_torch.cli import train_whisper_from_scratch as fcli
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims

    L = tiny_dims().n_audio_layer
    n_val = TRAIN_ITEMS // 4
    steps = TRAIN_ITEMS // TRAIN_BATCH
    zero = {k: 0 for k in FUSED_EXPECT}
    start_background(["cli"])
    artifact = os.path.join(BACKGROUND["dir"], "cli.qasrt")
    work = tempfile.mkdtemp(prefix="qasr_new_cli_")
    here = os.getcwd()
    os.chdir(work)
    paths = {}
    try:
        label = "cli distill_draft"
        t0 = time.perf_counter()
        cs = zero_counters()
        res = dcli.main(["--model", "tiny", "--draft", "tiny", "--steps", "2", "--batch_size",
                         str(TRAIN_BATCH), "--max_samples", str(TRAIN_ITEMS), "--sample_len",
                         "16", "--device", "cuda", "--out", "draft.pt"])
        paths[label] = read_counters(cs)
        # K1 once for the 16 clips; the held batch's labels, the agreement
        # twice (teacher + draft), one training batch's labels and 2 steps
        n_enc = 1 + 2 * 2 + 1 + 2 * 2
        expect_launches(label, paths[label], {**zero, "mel": 1, "stem": n_enc,
                                              "attn": n_enc * L, "finish": n_enc * L})
        if not os.path.exists("draft.pt") or not all(math.isfinite(v) for _, v in
                                                      res["history"]):
            raise AssertionError(f"{label}: {res}")
        EXPORT_STAGES[label] = {"seconds": time.perf_counter() - t0, **res}
        log(f"{label}: {EXPORT_STAGES[label]['seconds']:.1f} s, agreement "
            f"{res['before']:.3f} -> {res['after']:.3f} ({smi})")

        label = "cli train_whisper_from_scratch"
        t0 = time.perf_counter()
        cs = zero_counters()
        out = fcli.main(["--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--max_samples",
                         str(TRAIN_ITEMS), "--device", "cuda", "--checkpoint_dir", "ck"])
        paths[label] = read_counters(cs)
        expect_launches(label, paths[label], {**zero, "mel": TRAIN_ITEMS + n_val,
                                              "attn": L * (steps + 1),
                                              "finish": L * (steps + 1)})
        epochs = _history_ok("whisper_from_scratch_training_history.json", label, range(1))
        missing = [c for c in ("best_cer", "best_wer") if not os.path.exists(f"ck/{c}.pkl")]
        if missing:
            raise AssertionError(f"{label}: no checkpoint {missing}")
        EXPORT_STAGES[label] = {"seconds": time.perf_counter() - t0, "epochs": epochs}
        log(f"{label}: {EXPORT_STAGES[label]['seconds']:.1f} s, train_loss "
            f"{epochs[0]['train_loss']:.4f}, best {out['tracker'].best} ({smi})")

        label = "cli export_decode"
        wait_background("cli", label)
        call, meta = export.load_artifact(artifact)
        pcm = synthetic_pcm(TRAIN_ITEMS, SEED + 90)
        cs = zero_counters()
        for i in range(0, TRAIN_ITEMS, TRAIN_BATCH):
            out = call(pcm[i:i + TRAIN_BATCH])
            if len(artifact_tokens(export, out, meta)) != TRAIN_BATCH:
                raise AssertionError(f"{label}: bad artifact output")
        paths[label] = read_counters(cs)
        expect_launches(label, paths[label],
                        {**zero, "mel": 2, "stem": 2, "attn": 2 * L, "finish": 2 * L})
        EXPORT_STAGES[label] = {"file_mb": os.path.getsize(artifact) / 1e6}
        log(f"{label} (a process of its own): {EXPORT_STAGES[label]['file_mb']:.1f} MB, the "
            f"artifact called over {TRAIN_ITEMS} requests ({smi})")
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    return paths


def distill_phases(port, dev, smi):
    """Phases (a)-(c) of ``--distill``; the export CLI's process starts
    first (unless the full run started it)."""
    t0 = time.perf_counter()
    start_background(["cli"])
    paths = distill_phase(port, dev, smi)
    paths.update(from_scratch_step_phase(port, dev, smi))
    gc.collect()
    paths.update(new_cli_phase(port, dev, smi))
    gc.collect()
    torch.cuda.empty_cache()
    EXPORT_STAGES["distill seconds"] = time.perf_counter() - t0
    log(f"distillation phases seconds: {EXPORT_STAGES['distill seconds']:.1f}")
    return paths


def export_run(port, dev, smi):
    """``python3 chip_smoke.py --export``: the artifact phases alone."""
    paths = export_phases(port, dev, smi)
    log(json.dumps({"export_stages": EXPORT_STAGES, "export_launches": paths}, default=str))
    log(smi)


def distill_run(port, dev, smi):
    """``python3 chip_smoke.py --distill``: the distillation, from-scratch
    and new-CLI phases alone."""
    paths = distill_phases(port, dev, smi)
    log(json.dumps({"distill_stages": EXPORT_STAGES, "distill_launches": paths},
                   default=str))
    log(smi)


# -- parallelism: K4 head-sharded, the sharded trunks, data-parallel decode -------------
#
# The card host has one H100, so the ranks share it: PARALLEL_WORLD
# processes on cuda:0 joined by gloo (NCCL refuses two ranks on one device;
# gloo takes all_reduce of CUDA tensors, which is every collective the port
# uses).  They measure that the sharded paths compute what one rank computes,
# with the head-sharded kernel inside them; their times are of ranks
# time-sharing one card, not of scaling.  The rank processes start just
# after the build (``--parallel-rank R DIR``: imports, the process group)
# and wait for DIR/go before any device work, which this process writes
# once the earlier paths are done, so no earlier timing shares the card.

PARALLEL_WORLD = 4
PARALLEL_STAGES = {}
# (label, dims name, heads override, tp): the TP encoders the ranks drive
# (the first tp ranks), full width and depth, B_KERNEL rows; and the K4
# head-sharded rows timed alone in this process at each one's Dl.
TP_CASES = (("medium tp2", "medium", None, 2), ("large-v3 tp2", "large-v3", None, 2),
            ("small-h128 tp2", "small", 6, 2), ("medium tp4", "medium", None, 4))
MOE_EXPERTS = 4


def tp_dims(name, heads):
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for

    dims = dims_for(name)
    return dims if heads is None else replace(dims, n_audio_head=heads, n_text_head=heads)


def head_shard(attn, tp, m):
    """Rank m of tp's Q/K/V columns of ``attn`` (``parallel.shard_params``'
    cut), as the module the kernel's wrapper reads."""
    n = attn.query.weight.shape[0] // tp
    cut = lambda lin: SimpleNamespace(
        weight=lin.weight[m * n:(m + 1) * n].contiguous(),
        bias=None if lin.bias is None else lin.bias[m * n:(m + 1) * n].clone())
    return SimpleNamespace(query=cut(attn.query), key=cut(attn.key), value=cut(attn.value))


def sharded_attn_work(B, Tp, D, Dl, H, t_real, s):
    """K4 on a head shard: the (D, 3 Dl) projection of every row and the
    attention of its H heads among the t_real real rows; x (B, Tp, D) read,
    (B, Tp, Dl) written, the (3 Dl, D) weights and biases read."""
    flops = 2 * B * Tp * D * 3 * Dl + 4 * B * H * t_real * t_real * (Dl // H)
    return flops, s * (B * Tp * D + B * Tp * Dl + 3 * D * Dl + 3 * Dl) + 8 * D


def k4_sharded_phase(dev):
    """K4 head-sharded alone at each TP case's Dl (rank 0's columns of a
    default-init block), f32 and bf16, against its plain version, and the
    tp shards side by side against the full-width launch bit for bit."""
    from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock
    from qasr_ijcnlp_tpu_torch.ops import encoder_block

    res = {}
    with torch.inference_mode():
        for label, name, heads, tp in TP_CASES:
            dims = tp_dims(name, heads)
            T, Tp, D, H, _, _ = geometry(dims)
            nh, Dl = H // tp, D // tp
            kid = f"K4_dl{Dl}"
            torch.manual_seed(SEED + 80 + Dl)
            blk = ResidualAttentionBlock(D, H).to(dev).requires_grad_(False)
            x32 = rows(np.random.default_rng(SEED + 81), B_KERNEL, Tp, D, T, dev)
            shards = [head_shard(blk.attn, tp, m) for m in range(tp)]
            for dt, key in dtypes():
                x = x32.to(dt)
                a = shards[0]
                res.setdefault(kid, {})[key] = compare(
                    f"{kid} attention head-sharded ({label}: {nh} of {H} heads)", key,
                    lambda: encoder_block.fused_attention_ln(x, blk.attn_ln, a, nh, T),
                    lambda: encoder_block._plain_attn_ln(x, blk.attn_ln, a, nh, T),
                    sharded_attn_work(B_KERNEL, Tp, D, Dl, nh, T, elem_size(key)),
                    peak=tc_peak(key),
                    plain32_fn=lambda: encoder_block._plain_attn_ln(x.float(), blk.attn_ln,
                                                                    a, nh, T))
                full = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, T)
                cat = torch.cat([encoder_block.fused_attention_ln(x, blk.attn_ln, s, nh, T)
                                 for s in shards], -1)
                if not torch.equal(cat, full):
                    raise AssertionError(f"{kid} {key}: the {tp} head shards side by side "
                                         "differ from the full-width launch")
                log(f"{kid} {key}: {tp} shards side by side == the full-width launch, "
                    "bit for bit")
            del blk, x32, shards
            torch.cuda.empty_cache()
    return res


def start_parallel():
    """Start the rank processes (they wait for DIR/go before device work)."""
    import os
    import tempfile

    if "par_dir" in BACKGROUND:
        return
    work = BACKGROUND["par_dir"] = tempfile.mkdtemp(prefix="qasr_parallel_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    for r in range(PARALLEL_WORLD):
        log_path = os.path.join(work, f"rank{r}.log")
        BACKGROUND[f"rank{r}"] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r), work],
            cwd=root, env=env, stdout=open(log_path, "w"), stderr=subprocess.STDOUT),
            log_path)


def parallel_phases(port, dev, smi):
    """K4 head-sharded alone, then the ranks' phases (hands them the card and
    waits); checks their results and returns (kernel rows, launches by
    path: each TP case's per-rank counts)."""
    import os

    t0 = time.perf_counter()
    kres = k4_sharded_phase(dev)
    start_parallel()
    work = BACKGROUND["par_dir"]
    train_references(dev, work, smi)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    open(os.path.join(work, "go"), "w").close()
    outs = []
    for r in range(PARALLEL_WORLD):
        wait_background(f"rank{r}", f"parallel rank {r}")
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
        with open(BACKGROUND[f"rank{r}"][1]) as f:
            for line in f.read().splitlines()[-60:]:
                log(f"  rank {r}: {line}")
    by_path = {}
    for label, _, _, tp in TP_CASES:
        runs = [o["tp"][label] for o in outs[:tp]]
        if len({o["digest"] for o in runs}) != 1:
            raise AssertionError(f"{label}: the model ranks' outputs differ")
        by_path[f"{label} per rank"] = runs[0]["launches"]
    if outs[0]["dp"]["tokens_digest"] != outs[1]["dp"]["tokens_digest"]:
        raise AssertionError("data-parallel decode: the ranks returned different lists")
    for label in ("tp (2,2)", "fsdp (4,1)"):
        by_path[f"train cli {label} per rank, a step"] = outs[0]["train"]["cli"][label][
            "launches_per_step"]
    for label in ("tp (1,2)", "fsdp (4,1)"):
        by_path[f"train medium {label} per rank, a step"] = outs[0]["train"][
            f"medium {label}"]["launches_per_step"]
    PARALLEL_STAGES.update({"ranks": outs, "seconds": time.perf_counter() - t0})
    log(json.dumps({"parallel": {k: v for k, v in outs[0].items()}}, default=str))
    log(f"parallel phases: {time.perf_counter() - t0:.1f} s ({smi})")
    return kres, by_path


def parallel_rank(rank, work):
    """``python3 chip_smoke.py --parallel-rank R DIR``: one rank of the
    parallel phases.  Waits for DIR/go, joins the gloo group through a file
    store in DIR, runs every case in order and writes DIR/rankR.json."""
    import os

    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import qasr_ijcnlp_tpu_torch as port

    go = os.path.join(work, "go")
    t0 = time.perf_counter()
    while not os.path.exists(go):
        if time.perf_counter() - t0 > 1100:
            raise SystemExit("parallel rank: no go")
        time.sleep(0.2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "store"),
                            rank=rank, world_size=PARALLEL_WORLD)
    log(f"rank {rank}: gloo group of {PARALLEL_WORLD} on {torch.cuda.get_device_name(0)}, "
        "every rank on cuda:0")
    out = {"rank": rank, "tp": {}}
    try:
        with torch.inference_mode():
            for label, name, heads, tp in TP_CASES:
                out["tp"][label] = tp_rank_case(label, tp_dims(name, heads), tp, rank, dev)
            out["trunks"] = trunk_rank_cases(rank, dev)
        out["dp"] = dp_rank_case(port, rank, dev)
        out["engine"] = engine_rank_case(port, rank, dev)
        out["train"] = train_rank_cases(rank, dev, work)
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def rank_mesh(n, model_parallel):
    """A mesh over ranks [0, n) (every rank builds it; ranks >= n stay out)."""
    from qasr_ijcnlp_tpu_torch import parallel

    return parallel.make_mesh(model_parallel=model_parallel, group=list(range(n)))


def default_encoder(dims, dev, seed, moe=None):
    """A full-depth encoder with PyTorch's default init from ``seed``, built
    on the card: the same weights on every rank."""
    from qasr_ijcnlp_tpu_torch.models.moe import MoEAudioEncoder
    from qasr_ijcnlp_tpu_torch.models.whisper import AudioEncoder

    torch.manual_seed(seed)
    with torch.device(dev):
        enc = (AudioEncoder(dims.n_mels, dims.n_audio_ctx, dims.n_audio_state,
                            dims.n_audio_head, dims.n_audio_layer) if moe is None
               else MoEAudioEncoder(dims, moe))
    return enc.to(dev).requires_grad_(False)  # the position table is made on the host


def tp_rank_case(label, dims, tp, rank, dev):
    """The encoder (stem K2/K3 whole, the trunk head-sharded) over a (1, tp)
    mesh of ranks [0, tp), B_KERNEL rows, f32 (counted: the stem once, K4
    once a layer, K5/K6 and K8 never) and bf16, against the single-rank
    kernel encoder on rank 0; each rank's time."""
    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.models.whisper import encoder_apply

    mesh = rank_mesh(tp, tp)
    if not mesh.member:
        return None
    T, Tp, D, H, C0, Tm = geometry(dims)
    L = dims.n_audio_layer
    enc = default_encoder(dims, dev, SEED + 90)
    mel = randn(np.random.default_rng(SEED + 91), (B_KERNEL, C0, Tm), dev)
    ref, ref_ms = {}, {}
    if rank == 0:
        for dt, key in dtypes():
            ref[key] = encoder_apply(enc, mel, dims, dt).float()
            ref_ms[key] = cuda_ms(lambda: encoder_apply(enc, mel, dims, dt), iters=1, warmup=1)
    parallel.shard_params(enc, mesh)
    torch.cuda.empty_cache()
    cs = zero_counters()
    got = {"f32": encoder_apply(enc, mel, dims, torch.float32, mesh=mesh)}
    launches = read_counters(cs)
    expect_launches(f"{label} rank {rank}", launches, {"stem": 1, "attn": L})
    got["bf16"] = encoder_apply(enc, mel, dims, torch.bfloat16, mesh=mesh)
    res = {"launches": launches, "digest": digest_of(got["f32"]), "ms": {}, "single_ms": ref_ms,
           "heads_per_rank": H // tp, "dl": D // tp}
    for dt, key in dtypes():  # one timed call: each dtype ran once above
        res["ms"][key] = cuda_ms(lambda: encoder_apply(enc, mel, dims, dt, mesh=mesh),
                                 iters=1, warmup=0)
    if rank == 0:
        err32 = float((got["f32"].float() - ref["f32"]).abs().max())
        noise = float((ref["bf16"] - ref["f32"]).abs().max())
        err16 = float((got["bf16"].float() - ref["f32"]).abs().max())
        if not (err32 <= TOL["trunk_f32"] and err16 <= NOISE_FACTOR * noise):
            raise AssertionError(f"{label}: TP vs single rank f32 {err32:.3e} (tol "
                                 f"{TOL['trunk_f32']}), bf16 {err16:.3e} (tol {NOISE_FACTOR:g} "
                                 f"x {noise:.3e})")
        res.update(max_abs_err=err32, bf16_err_vs_f32=err16, bf16_single_vs_f32=noise)
    log(f"{label} rank {rank}: launches {json.dumps(launches)}; per-rank ms "
        f"{json.dumps(res['ms'])}, single rank {json.dumps(ref_ms)}"
        + (f"; max_abs_err vs single rank f32 {res['max_abs_err']:.3e}" if rank == 0 else ""))
    del enc, got, ref
    torch.cuda.empty_cache()
    return res


def trunk_rank_cases(rank, dev):
    """tiny's trunk: sequence-parallel over (1, 4), pipelined over (1, 2);
    a tiny MoE trunk (4 experts, capacity ample so no token drops on either
    side) expert-parallel over (1, 2): each output against its single-rank
    form on the card (f32)."""
    from qasr_ijcnlp_tpu_torch.models import moe as moe_mod
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import transformer_trunk
    from qasr_ijcnlp_tpu_torch.parallel import sharded

    dims = tiny_dims()
    T, Tp, D, _, _, _ = geometry(dims)
    enc = default_encoder(dims, dev, SEED + 92)
    x = rows(np.random.default_rng(SEED + 93), 4, Tp, D, T, dev)
    single = transformer_trunk(enc, x, dims, t_real=T)
    res = {}
    for label, n, fn in (("sp (1,4)", 4, lambda m: sharded.sp_trunk(enc, x, dims, T, m)),
                         ("pp (1,2)", 2, lambda m: sharded.pp_trunk(enc, x, dims, T, m))):
        mesh = rank_mesh(n, n)
        if mesh.member:
            got = fn(mesh)
            err = float((got.float() - single.float()).abs().max())
            if not err <= TOL["trunk_f32"]:
                raise AssertionError(f"{label}: {err:.3e} from the single-rank trunk")
            res[label] = {"max_abs_err": err, "ms": cuda_ms(lambda: fn(mesh), iters=1,
                                                            warmup=0)}
    cfg = moe_mod.MoEConfig(MOE_EXPERTS, capacity_factor=float(MOE_EXPERTS))
    menc = default_encoder(dims, dev, SEED + 94, moe=cfg)
    xm = x[:2, :T].contiguous()
    mesh = rank_mesh(2, 2)
    if mesh.member:
        want, waux = moe_mod.moe_trunk(menc, xm, dims, cfg)
        got, aux = sharded.ep_trunk(menc, xm, dims, cfg, T, mesh)
        err = float((got - want).abs().max())
        # aux is the mean of each rank's load-balance loss on its own tokens
        # (the JAX trunk's), not the dense trunk's: only finite is checked
        if not (err <= TOL["trunk_f32"] and math.isfinite(float(aux))):
            raise AssertionError(f"ep (1,2): {err:.3e} from the single-rank MoE trunk, aux "
                                 f"{float(aux)}")
        res["ep (1,2)"] = {"max_abs_err": err, "aux": float(aux), "single_aux": float(waux)}
    log(f"trunks rank {rank}: {json.dumps(res)}")
    return res


def dp_rank_case(port, rank, dev, n=16):
    """tiny greedy decode of ``n`` requests over a (2, 1) mesh of ranks 0 and
    1 with the fused step switched on: per rank one stem call and K4/K5 once
    a layer on its n / 2 rows, K10 never; every rank's list equal to the
    single-rank card decode's (f32), in order."""
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params
    from qasr_ijcnlp_tpu_torch.ops import decoder_step

    mesh = rank_mesh(2, 1)
    if not mesh.member:
        return None
    dims = tiny_dims()
    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    pcm = synthetic_pcm(n, SEED + 7)
    mel = port.log_mel_spectrogram(pcm, n_mels=dims.n_mels, device=dev)
    want = None
    if rank == 0:
        single = port.WhisperModel.from_state_dict(sd, dims, dev)
        want = [r.tokens for r in port.decode(single, mel, options(port, False))]
        del single
    model = port.WhisperModel.from_state_dict(sd, dims, dev).shard(mesh)
    decoder_step.set_fused_decoder_step(True)
    try:
        cs = zero_counters()
        t0 = time.perf_counter()
        got = port.decode(model, mel, options(port, False))
        launches = read_counters(cs)
        ms = (time.perf_counter() - t0) * 1000
    finally:
        decoder_step.set_fused_decoder_step(None)
    L = dims.n_audio_layer
    expect_launches(f"dp decode rank {rank}", launches, {"stem": 1, "attn": L, "finish": L})
    tokens = [r.tokens for r in got]
    if want is not None and tokens != want:
        bad = [i for i, (a, b) in enumerate(zip(tokens, want)) if a != b]
        raise AssertionError(f"dp decode: requests {bad} differ from the single-rank decode")
    log(f"dp decode rank {rank}: {n} requests over 2 ranks, {ms:.1f} ms, launches "
        f"{json.dumps(launches)}, tokens equal to the single-rank decode")
    return {"launches": launches, "ms": ms, "tokens_digest": [hash(tuple(t)) for t in tokens]}


def engine_rank_case(port, rank, dev, n=12):
    """The data-parallel engine pool: 8 slots over ranks 0 and 1, ``n``
    requests submitted on rank 0, each result's tokens equal to the
    single-rank engine's (f32)."""
    from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    mesh = rank_mesh(2, 1)
    if not mesh.member:
        mesh.fork()  # the engine's groups: every rank builds them
        return None
    dims = tiny_dims()
    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    model = port.WhisperModel.from_state_dict(sd, dims, dev)
    opts = options(port, False)
    mels = None
    want = None
    if rank == 0:
        mels = port.log_mel_spectrogram(synthetic_pcm(n, SEED + 8), n_mels=dims.n_mels,
                                        device=dev).cpu()
        single = DecodeEngine(model, opts, slots=8)
        try:
            want = [single.submit(m)["tokens"] for m in mels]
        finally:
            single.close()
    engine = DecodeEngine(model, opts, slots=8, mesh=mesh)
    if rank != 0:
        engine.join(timeout=600)
        return {"admit_calls": engine.admit_calls, "step_calls": engine.step_calls}
    results = [None] * n
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, engine.submit(mels[i])["tokens"])) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    ms = (time.perf_counter() - t0) * 1000
    engine.close()
    if results != want:
        raise AssertionError("engine over 2 ranks: requests "
                             f"{[i for i in range(n) if results[i] != want[i]]} differ from "
                             "the single-rank engine")
    log(f"engine over 2 ranks: {n} requests in {ms:.1f} ms, tokens equal to the single-rank "
        f"engine's; rank 0 admit_calls {engine.admit_calls} step_calls {engine.step_calls}")
    return {"ms": ms, "admit_calls": engine.admit_calls, "step_calls": engine.step_calls}


# == sharded training (--parallel): the trainer CLI and medium steps ==============
# (a) the tiny token trainer CLI at full width and depth on the four ranks,
# --model_parallel 2 ((2, 2)) and --fsdp ((4, 1)), 2 epochs over TRAIN_ITEMS
# synthetic items at TRAIN_BATCH, then resumed from its epoch-1 state for a
# third; (b) medium at full width and depth, MEDIUM_TRAIN_B rows in f32 with
# remat, MEDIUM_TRAIN_STEPS steps of make_sharded_train_step under TP over
# ranks 0 and 1 ((1, 2)) and FSDP over the four ((4, 1)).  Both against the
# single-rank trainer in this process, which runs first and frees the card.
MEDIUM_TRAIN_B, MEDIUM_TRAIN_STEPS, MEDIUM_TRAIN_TOKENS = 2, 2, 24
# Against the single-rank step: the loss within 2e-4 relative, every
# parameter within 5e-4 (JAX's test_sharded_training_at_real_widths).
SHARDED_LOSS_RTOL, SHARDED_PARAM_ATOL = 2e-4, 5e-4


def recording_steps(record):
    """``train.loops.make_train_step`` (the token trainer's step) made to
    append each step's loss, skip flag and launches to ``record``; returns
    the function that undoes it."""
    from qasr_ijcnlp_tpu_torch.train import loops

    real = loops.make_train_step

    def make(loss_fn, tx, **kw):
        inner = real(loss_fn, tx, **kw)

        def step(state, *batch):
            cs = zero_counters()
            state, m = inner(state, *batch)
            launches = read_counters(cs)
            del launches["mel"]  # the loader's thread makes the next items' mel meanwhile
            record.append({"loss": float(m["loss"]), "skipped": int(m["skipped"]),
                           "launches": launches})
            return state, m
        return step

    loops.make_train_step = make
    return lambda: setattr(loops, "make_train_step", real)


def trainer_cli_runs(run_dir, flags):
    """The token trainer CLI (tiny, --device cuda) in ``run_dir``: 2 epochs,
    then resumed from the epoch-1 state for a third; each run's per-step
    records and the resumed run's step count."""
    import os

    from qasr_ijcnlp_tpu_torch.cli import train_classical_whisper_asr as tcli

    argv = ["--model_size", "tiny", "--epochs", "2", "--batch_size", str(TRAIN_BATCH),
            "--max_samples", str(TRAIN_ITEMS), "--save_every", "1", "--warmup_epochs", "1",
            "--lr", str(STEP_LR), "--device", "cuda", "--checkpoint_dir", "ck", *flags]
    here = os.getcwd()
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    out = {}
    try:
        for label, extra in (("2 epochs", []), ("resumed", ["--epochs", "3", "--resume_state",
                                                           "ck/state_epoch_1"])):
            record = []
            undo = recording_steps(record)
            try:
                res = tcli.main(argv + extra)
            finally:
                undo()
            if torch.distributed.is_initialized():
                torch.distributed.barrier()  # the leader has written the history
            out[label] = {"steps": record, "step": int(res["state"].step)}
        out["epochs"] = _history_ok("classical_whisper_asr_training_history.json",
                                    f"cli {flags}", [2])
    finally:
        os.chdir(here)
    return out


def medium_train_batch(dev, rows):
    """The medium steps' batch: MEDIUM_TRAIN_B rows of mel and tokens (-100
    padded, counts differing per row), padded with rows whose tokens are all
    -100 (no target: the loss and gradient of the real rows alone) up to
    ``rows``."""
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for

    dims = dims_for("medium")
    rng = np.random.default_rng(SEED + 96)
    B = MEDIUM_TRAIN_B
    mel = np.zeros((rows, dims.n_mels, 2 * dims.n_audio_ctx), np.float32)
    mel[:B] = rng.standard_normal((B, dims.n_mels, 2 * dims.n_audio_ctx)) * 0.5
    mel[B:] = mel[B - 1]
    tokens = np.full((rows, MEDIUM_TRAIN_TOKENS), -100, np.int64)
    tokens[:B] = rng.integers(0, 50257, (B, MEDIUM_TRAIN_TOKENS))
    tokens[1, MEDIUM_TRAIN_TOKENS // 2:] = -100
    return torch.from_numpy(mel).to(dev), torch.from_numpy(tokens).to(dev)


def state_bytes(state):
    """Bytes of this rank's parameters and both Adam moments."""
    from qasr_ijcnlp_tpu_torch.train.step import as_module

    ps = list(as_module(state.params).parameters())
    return sum(t.numel() * t.element_size()
               for t in ps + state.opt_state["mu"] + state.opt_state["nu"])


def medium_module(dev, work):
    """The medium model on the card from the initial weights this process
    wrote (memory-mapped, the same on every rank)."""
    import os

    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.models.whisper import Whisper

    with torch.device("meta"):
        module = Whisper(dims_for("medium"))
    sd = torch.load(os.path.join(work, "medium_init.pt"), mmap=True)
    module.load_state_dict(sd, assign=True)
    return module.to(dev).requires_grad_(True)


def medium_steps(module, state, step, mel, tokens):
    """MEDIUM_TRAIN_STEPS steps: per step the loss, its launches and ms."""
    record = []
    for _ in range(MEDIUM_TRAIN_STEPS):
        cs = zero_counters()
        t0 = time.perf_counter()
        state, m = step(state, mel, tokens)
        launches = read_counters(cs)  # synchronizes
        record.append({"loss": float(m["loss"]), "skipped": int(m["skipped"]),
                       "ms": (time.perf_counter() - t0) * 1000, "launches": launches})
    return state, record


def train_references(dev, work, smi):
    """The single-rank references of the ranks' training, in this process
    before the ranks have the card: the tiny trainer CLI's runs, then
    medium's steps (its initial and final weights written to ``work`` for
    the ranks, the card freed after)."""
    import os

    from qasr_ijcnlp_tpu_torch.models import whisper as cmodel
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.train import step as st

    t0 = time.perf_counter()
    ref = {"cli": trainer_cli_runs(os.path.join(work, "cli_single"), [])}
    L = dims_for("tiny").n_audio_layer
    for part in ("2 epochs", "resumed"):
        for i, s in enumerate(ref["cli"][part]["steps"]):
            expect_launches(f"cli single rank {part} step {i}", s["launches"],
                            {"stem": 1, "attn": L, "finish": L})
    dims = dims_for("medium")
    torch.save(cmodel.init_params(torch.Generator().manual_seed(SEED + 95), dims),
               os.path.join(work, "medium_init.pt"))
    cmodel.set_remat(True)
    try:
        module = medium_module(dev, work)
        tx = st.make_optimizer(STEP_LR)
        state = st.init_state(module, tx)
        mel, tokens = medium_train_batch(dev, MEDIUM_TRAIN_B)
        torch.cuda.reset_peak_memory_stats()
        state, record = medium_steps(module, state,
                                     st.make_train_step(st.whisper_loss_fn(dims), tx),
                                     mel, tokens)
    finally:
        cmodel.set_remat(False)
    L = dims.n_audio_layer
    for i, s in enumerate(record):
        expect_launches(f"medium single rank step {i}", s["launches"],
                        {"stem": 1, "attn": 2 * L, "finish": 2 * L})
    ref["medium"] = {"steps": record, "state_bytes": state_bytes(state),
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    torch.save({k: v.cpu() for k, v in module.state_dict().items()},
               os.path.join(work, "medium_final.pt"))
    del module, state, mel, tokens
    torch.cuda.empty_cache()
    with open(os.path.join(work, "train_ref.json"), "w") as f:
        json.dump(ref, f)
    log(f"single-rank training references: tiny CLI losses "
        f"{[round(s['loss'], 5) for s in ref['cli']['2 epochs']['steps']]}; medium losses "
        f"{[s['loss'] for s in ref['medium']['steps']]}, ms "
        f"{[round(s['ms'], 1) for s in ref['medium']['steps']]}, state "
        f"{ref['medium']['state_bytes'] / 1e9:.2f} GB, peak "
        f"{ref['medium']['peak_bytes'] / 1e9:.2f} GB; {time.perf_counter() - t0:.1f} s "
        f"({smi})")


def _same_losses(label, got, want):
    g, w = [s["loss"] for s in got], [s["loss"] for s in want]
    if len(g) != len(w) or not np.allclose(g, w, rtol=SHARDED_LOSS_RTOL, atol=0):
        raise AssertionError(f"{label}: per-step losses {g} against the single rank's {w}")
    if any(s["skipped"] for s in got):
        raise AssertionError(f"{label}: a step was skipped")


def cli_rank_case(rank, dev, work, ref):
    """(a) on this rank: the trainer CLI under --model_parallel 2 and --fsdp,
    each step's loss against the single-rank trainer's, its exact launches
    (the stem once; K4 once a layer where the trunk runs it: every block
    under FSDP, the TP trunk's head shards where ``tp_uses_kernel``; the
    finish K5 once a layer under FSDP, never under TP), and the resume."""
    import os

    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.parallel import sharded

    dims = tiny_dims()
    L = dims.n_audio_layer
    res = {}
    for label, flags in (("tp (2,2)", ["--model_parallel", "2"]), ("fsdp (4,1)", ["--fsdp"])):
        t0 = time.perf_counter()
        runs = trainer_cli_runs(os.path.join(work, "cli_" + label.split()[0]), flags)
        if label.startswith("tp"):
            shape = SimpleNamespace(shape={"data": 2, "model": 2})
            k4 = L if sharded.tp_uses_kernel(dims, shape, dims.n_audio_ctx) else 0
            expect = {"stem": 1, "attn": k4}
        else:
            expect = {"stem": 1, "attn": L, "finish": L}
        for part in ("2 epochs", "resumed"):
            _same_losses(f"cli {label} rank {rank} {part}", runs[part]["steps"],
                         ref[part]["steps"])
            for i, s in enumerate(runs[part]["steps"]):
                expect_launches(f"cli {label} rank {rank} {part} step {i}", s["launches"],
                                expect)
        if runs["resumed"]["step"] != ref["resumed"]["step"]:
            raise AssertionError(f"cli {label}: resumed at step {runs['resumed']['step']}")
        res[label] = {"losses": [s["loss"] for s in runs["2 epochs"]["steps"]],
                      "resumed_losses": [s["loss"] for s in runs["resumed"]["steps"]],
                      "launches_per_step": runs["2 epochs"]["steps"][0]["launches"],
                      "seconds": time.perf_counter() - t0}
        log(f"cli {label} rank {rank}: per-step losses {res[label]['losses']} (single rank "
            f"{[s['loss'] for s in ref['2 epochs']['steps']]}), resumed "
            f"{res[label]['resumed_losses']}, launches a step "
            f"{json.dumps(res[label]['launches_per_step'])}, {res[label]['seconds']:.1f} s")
    return res


def medium_rank_case(label, rank, dev, work, ref):
    """(b) on this rank: medium's steps under TP (1, 2) on ranks 0 and 1 or
    FSDP (4, 1): losses and this rank's slice of every updated parameter
    against the single-rank steps, launches a step (the stem once; K4
    twice a layer under remat; the finish K6 twice a layer under FSDP),
    ms a step, peak memory and this rank's parameter-plus-moment bytes."""
    import os

    from qasr_ijcnlp_tpu_torch import parallel
    from qasr_ijcnlp_tpu_torch.models import whisper as cmodel
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.train import step as st

    fsdp = label.startswith("fsdp")
    mesh = rank_mesh(4, 1) if fsdp else rank_mesh(2, 2)
    if not mesh.member:
        return None
    dims = dims_for("medium")
    L = dims.n_audio_layer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    module = medium_module(dev, work)
    tx = st.make_optimizer(STEP_LR)
    state = st.shard_state(st.init_state(module, tx), mesh, fsdp=fsdp)
    nbytes = state_bytes(state)
    mel, tokens = medium_train_batch(dev, parallel.round_up_to_mesh(MEDIUM_TRAIN_B, mesh))
    cmodel.set_remat(True)
    try:
        state, record = medium_steps(module, state, st.make_sharded_train_step(
            st.whisper_loss_fn(dims), tx, mesh), mel, tokens)
    finally:
        cmodel.set_remat(False)
    peak = torch.cuda.max_memory_allocated()
    _same_losses(f"medium {label} rank {rank}", record, ref["steps"])
    expect = {"stem": 1, "attn": 2 * L, **({"finish": 2 * L} if fsdp else {})}
    for i, s in enumerate(record):
        expect_launches(f"medium {label} rank {rank} step {i}", s["launches"], expect)
    final = torch.load(os.path.join(work, "medium_final.pt"), mmap=True)
    layout = parallel.param_layout(module)
    err = 0.0
    with torch.no_grad():
        for name, p in module.named_parameters():
            want = final[name]
            if name in layout:
                want = parallel.local_slice(want, layout[name], mesh)
            err = max(err, float((p - want.to(dev)).abs().max()))
    if not err <= SHARDED_PARAM_ATOL:
        raise AssertionError(f"medium {label} rank {rank}: parameters {err:.3e} from the "
                             f"single rank's (tol {SHARDED_PARAM_ATOL})")
    share = nbytes / ref["state_bytes"]
    if fsdp and not 0.24 <= share <= 0.27:
        raise AssertionError(f"medium {label} rank {rank}: parameters and moments "
                             f"{nbytes} B, {share:.3f} of the single rank's")
    res = {"losses": [s["loss"] for s in record], "ms": [s["ms"] for s in record],
           "launches_per_step": record[0]["launches"], "max_abs_err": err,
           "state_bytes": nbytes, "state_share": share, "peak_bytes": peak}
    log(f"medium {label} rank {rank}: losses {res['losses']} (single rank "
        f"{[s['loss'] for s in ref['steps']]}), params max_abs_err {err:.3e}, ms a step "
        f"{[round(m, 1) for m in res['ms']]}, launches a step "
        f"{json.dumps(res['launches_per_step'])}, state {nbytes / 1e9:.2f} GB "
        f"({share:.3f} of one rank's), peak {peak / 1e9:.2f} GB")
    del module, state, mel, tokens
    torch.cuda.empty_cache()
    return res


def train_rank_cases(rank, dev, work):
    """The sharded-training cases of this rank ((a) then (b))."""
    import os

    with open(os.path.join(work, "train_ref.json")) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    res = {"cli": cli_rank_case(rank, dev, work, ref["cli"])}
    for label in ("tp (1,2)", "fsdp (4,1)"):
        res[f"medium {label}"] = medium_rank_case(label, rank, dev, work, ref["medium"])
    res["seconds"] = time.perf_counter() - t0
    return res


def parallel_run(port, dev, smi):
    """``python3 chip_smoke.py --parallel``: K4 head-sharded alone and the
    ranks' phases; the kernel rows of K4's head-sharded widths as one JSON
    line."""
    kres, by_path = parallel_phases(port, dev, smi)
    log(json.dumps({"k4_head_sharded": kres, "launches": by_path}))
    log(smi)


def kernel_table(kres, by_path):
    """The per-kernel JSON entries: each row's f32 (and bf16) measurements
    and its launches on its path's counted batch and on every path."""
    src = "qasr_ijcnlp_tpu_torch/csrc/"
    tpu = "qasr_ijcnlp_tpu/ops/"
    # (entry, TPU kernel, source, replaces, counter, path, shape)
    table = [
        ("mel", "K1", src + "melfront.cu", tpu + "melfront.py:48", "mel", "tiny",
         "(8, 480000) -> (8, 80, 3000)"),
        ("conv_stem", "K2", src + "conv_stem.cu", tpu + "conv_stem.py:82", "stem", "tiny",
         "(8, 80, 3000) -> (8, 1536, 384)"),
        ("conv_stem_d1024", "K3", src + "conv_stem.cu", tpu + "conv_stem.py:119", "stem",
         "medium", "(8, 80, 3000) -> (8, 1536, 1024)"),
        ("mel_128", "K1_128", src + "melfront.cu", tpu + "melfront.py:48", "mel", "large-v3",
         "(8, 480000) -> (8, 128, 3000)"),
        ("mel_file", "K1_file", src + "melfront.cu", tpu + "melfront.py:48", "mel",
         "tiny longform f32", f"(1, {TINY_LONGFORM_SAMPLES} + 480000 padding) -> (1, 80, "
         f"{(TINY_LONGFORM_SAMPLES + 480000) // 160}): a 5-min file, one launch"),
        ("conv_stem_d1280", "stem_1280", src + "conv_stem.cu", tpu + "conv_stem.py:119",
         "stem", "large-v3", "(8, 128, 3000) -> (8, 1536, 1280): K3's kernel at large-v3, "
         "whose stem the JAX package leaves to XLA"),
        ("encoder_attention", "K4", src + "encoder_block.cu", tpu + "encoder_block.py:148",
         "attn", "tiny", "(8, 1536, 384), 6 heads, t_real 1500"),
        ("encoder_finish", "K5", src + "encoder_block.cu", tpu + "encoder_block.py:238",
         "finish", "tiny", "(8, 1536, 384)"),
        ("encoder_attention_d1024", "K4_16h", src + "encoder_block.cu",
         tpu + "encoder_block.py:148", "attn", "medium", "(8, 1536, 1024), 16 heads, t_real 1500"),
        ("encoder_finish_d1024", "K6", src + "encoder_block.cu",
         tpu + "encoder_block.py:259", "finish", "medium", "(8, 1536, 1024)"),
        ("packed_attention", "K8", src + "flash.cu", tpu + "flash.py:119", "packed",
         "large-v3", "(8, 1536, 1280), 20 heads, t_real 1500"),
        ("int8_cross_attention", "K9", src + "decode_attn.cu", tpu + "decode_attn.py:64",
         "int8", "large-v3 int8", "q (8, 1, 1280), codes (8, 20, 1536, 64), t_real 1500"),
        ("int8_cross_attention_prompt", "K9_prompt", src + "decode_attn.cu",
         tpu + "decode_attn.py:64", "int8", "large-v3 int8",
         "q (8, 4, 1280), codes (8, 20, 1536, 64), t_real 1500"),
        ("int8_cross_attention_tiny", "K9_tiny", src + "decode_attn.cu",
         tpu + "decode_attn.py:64", "int8", "tiny int8",
         "q (16, 1, 384), codes (16, 6, 1536, 64), t_real 1500"),
        ("fused_decoder_layer", "K10", src + "decoder_step.cu", tpu + "decoder_step.py:137",
         "step", "tiny fused B=16", "x (16, 384), self 67 of 80, cross 1500"),
        ("fused_decoder_layer_b64", "K10_b64", src + "decoder_step.cu",
         tpu + "decoder_step.py:137", "step", "tiny fused B=64",
         "x (64, 384), self 67 of 80, cross 1500"),
        ("fused_decoder_layer_d512", "K10_d512", src + "decoder_step.cu",
         tpu + "decoder_step.py:137", "step", "tiny fused B=16",
         "base width: x (8, 512), one layer, self 67 of 80, cross 1500"),
    ]
    table += [
        ("flash_attention_4d", "K7", src + "flash.cu", tpu + "flash.py:30", "flash4d",
         "small-h96", "(8, 8, 1536, 96) head views of (8, 1536, 768), t_real 1500"),
        ("flash_attention_4d_h5", "K7_h5", src + "flash.cu", tpu + "flash.py:30", "flash4d",
         "small-h96", "(8, 5, 1536, 64) head views, t_real 1500 (not on a driven path)"),
        ("encoder_attention_d128", "K4_d128", src + "encoder_block.cu",
         tpu + "encoder_block.py:148", "attn", "small-h128",
         "(8, 1536, 768), 6 heads of 128, t_real 1500"),
        ("packed_attention_d128", "K8_d128", src + "flash.cu", tpu + "flash.py:119", "packed",
         "large-v3", "(8, 1536, 1280), 10 heads of 128 (not on a driven path)"),
        ("packed_attention_d32", "K8_d32", src + "flash.cu", tpu + "flash.py:119", "packed",
         "large-v3", "(8, 1536, 384), 12 heads of 32 (not on a driven path)"),
        ("int8_cross_attention_d128", "K9_d128", src + "decode_attn.cu",
         tpu + "decode_attn.py:64", "int8", "small-h128 int8",
         "q (8, 1, 768), codes (8, 6, 1536, 128), t_real 1500"),
        ("int8_cross_attention_g5", "K9_g5", src + "decode_attn.cu",
         tpu + "decode_attn.py:64", "int8", "large-v3 beam int8",
         "q (40, 1, 1280): 5 beam rows per request, codes (8, 20, 1536, 64), t_real 1500"),
    ]
    for label, name, heads, tp in TP_CASES:
        dims = tp_dims(name, heads)
        D, H = dims.n_audio_state, dims.n_audio_head
        table.append((f"encoder_attention_head_sharded_dl{D // tp}", f"K4_dl{D // tp}",
                      src + "encoder_block.cu", tpu + "encoder_block.py:148", "attn",
                      f"{label} per rank",
                      f"(8, 1536, {D}) -> (8, 1536, {D // tp}): {H // tp} of {H} heads, "
                      f"t_real 1500 ({label}, launches per rank)"))
    for mode in ("dots", "softmax", "full"):
        table.append((f"attn_parts_{mode}", f"K11_{mode}", src + "attn_parts.cu",
                      "scripts/bench_attn_parts.py:37", "parts", "attn_parts B=512",
                      f"{mode}: bf16 (8, 1536, 384), 6 heads of 64; also timed at B=512"))
    for i, mode in enumerate(("dma", "vpu", "mxu_t", "mxu_r")):
        layout = "(64, 384, 1536)" if mode in ("vpu", "mxu_t") else "(64, 1536, 384)"
        table.append((f"step_formulations_{mode}", f"K12_{mode}", src + "step_formulations.cu",
                      f"scripts/bench_step_formulations.py:{(38, 61, 95, 138)[i]}",
                      "formulations", "step_formulations B=64",
                      f"{mode}: bf16 q (64, 384), k, v {layout}"))
    kernels = []
    for name, kid, source, replaces, counter, path, shape in table:
        entry = {"name": name, "tpu_kernel": kid, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": by_path[path][counter], "path": path,
                 "shape": shape,
                 # (a trainer's step leaves K1 out: its loader makes mel in a thread)
                 "launches_by_path": {p: c[counter] for p, c in by_path.items()
                                      if counter in c}}
        first = "f32" if "f32" in kres[kid] else "bf16"  # K11 is bf16 only
        entry.update(kres[kid][first])
        if first == "f32" and "bf16" in kres[kid]:
            entry.update({f"bf16_{key}": v for key, v in kres[kid]["bf16"].items()})
        kernels.append(entry)
    return kernels


def k9_run(port, dev, smi, stages, repeats=2):
    """``python3 chip_smoke.py --k9 [--stages]``: K9 alone, for a quick loop
    on the card and for comparing two trees in one call.  K9 against its
    plain version, hot and cold, at its five paths (large-v3 step and
    prompt, G = 5, tiny B=16, small-h128); with ``stages``, then the decode
    stage of each int8 path (tiny B=16, small-h128, large-v3 and its beam 5
    at B=8; full width and depth, random weights) from ``repeats`` warm
    batches per dtype (``stage_times``, host clock).  Prints the K9 rows
    (and stages) as one JSON line; no launch counts, no token checks (the
    full run has them)."""
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for, tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    kres = {}
    with torch.inference_mode():
        int8_phase(kres, "K9", B_KERNEL, 20, dev, SEED + 9, row_counts=(1, 4))
        int8_phase(kres, "K9_g5", B_KERNEL, 20, dev, SEED + 23, groups=5)
        int8_phase(kres, "K9_tiny", 16, 6, dev, SEED + 4)
        int8_phase(kres, "K9_d128", B_KERNEL, 6, dev, SEED + 18, dh=128)
    h128 = replace(dims_for("small"), n_audio_head=6, n_text_head=6)
    decode_ms = {}
    paths = (("tiny", tiny_dims(), 16, (None,)), ("small-h128", h128, B_KERNEL, (None,)),
             ("large-v3", dims_for("large-v3"), B_KERNEL, (None, BEAM)))
    for name, dims, B, beams in paths if stages else ():
        sd = init_params(torch.Generator().manual_seed(SEED), dims)
        gpu = port.WhisperModel.from_state_dict(sd, dims, dev, name=f"{name} (random)")
        pcm = synthetic_pcm(B, SEED + 7, dims.n_audio_ctx * 320)
        for extra in beams:
            label = f"{name}{' beam' if extra else ''} int8"
            for fp16 in (False, True):
                run_requests(port, gpu, pcm, fp16, True, extra)  # warm-up
                key = f"{label} {'bf16' if fp16 else 'f32'}"
                decode_ms[key] = [stage_times(port, gpu, pcm, fp16, label, True, extra)[2]
                                  for _ in range(repeats)]
        del gpu, sd
        gc.collect()
        torch.cuda.empty_cache()
    log(json.dumps({"k9": {k: v["f32"] for k, v in kres.items()}, "decode_ms": decode_ms}))
    log(smi)


def k10_run(port, dev, smi, stages, repeats=2):
    """``python3 chip_smoke.py --k10 [--stages]``: K10 alone, for a quick
    loop on the card and for comparing two trees in one call.  K10 against
    its plain version, cold and hot, at its three shapes (tiny B=16 and
    B=64, base width B=8); with ``stages``, then the decode stage of the
    tiny fused path at B=16 and B=64 (full width and depth, random weights)
    from ``repeats`` warm batches per dtype (``stage_times``, host clock).
    Prints the K10 rows (and stages) as one JSON line; no launch counts, no
    token checks (the full run has them)."""
    from qasr_ijcnlp_tpu_torch.models.dims import tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params
    from qasr_ijcnlp_tpu_torch.ops import decoder_step

    dims = tiny_dims()
    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    gpu = port.WhisperModel.from_state_dict(sd, dims, dev, name="tiny (random)")
    kres = {}
    with torch.inference_mode():
        block_for = lambda dt: gpu.decoder_for(dt).blocks[0]
        step_phase(kres, "K10", block_for, 16, dev, SEED + 5)
        step_phase(kres, "K10_b64", block_for, 64, dev, SEED + 6)
        step_phase(kres, "K10_d512", base_block_for(dev), 8, dev, SEED + 8)
    decode_ms = {}
    decoder_step.set_fused_decoder_step(True)
    try:
        for B in (16, 64) if stages else ():
            pcm = synthetic_pcm(B, SEED + 7)
            label = f"tiny fused B={B}"
            for fp16 in (False, True):
                run_requests(port, gpu, pcm, fp16)  # warm-up
                key = f"{label} {'bf16' if fp16 else 'f32'}"
                decode_ms[key] = [stage_times(port, gpu, pcm, fp16, label)[2]
                                  for _ in range(repeats)]
    finally:
        decoder_step.set_fused_decoder_step(None)
    log(json.dumps({"k10": kres, "decode_ms": decode_ms}))
    log(smi)


def attn_run(port, dev, smi):
    """``python3 chip_smoke.py --attn``: the attention core's three callers
    alone, for comparing two trees in one call: K4 at medium (16 heads, a
    default-init block seeded by SEED), K7 at small-h96 (8 heads of 96) and
    K8 at large-v3 (20 heads), f32 and bf16, each against its plain version
    with its time and a digest of its output (equal digests: the same bits),
    and the K4 and K8 rounding probes.  Prints the rows as one JSON line; no
    launch counts (the full run has them)."""
    global DIGESTS
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock
    from qasr_ijcnlp_tpu_torch.ops import encoder_block, flash

    DIGESTS = True
    kres = {}
    with torch.inference_mode():
        T, Tp, D, H, _, _ = geometry(dims_for("medium"))
        torch.manual_seed(SEED)
        blk = ResidualAttentionBlock(D, H).to(dev).requires_grad_(False)
        x32 = rows(np.random.default_rng(SEED + 1), B_KERNEL, Tp, D, T, dev)
        for dt, key in dtypes():
            x = x32.to(dt)
            kres.setdefault("K4_16h", {})[key] = compare(
                f"K4_16h attention {H} heads", key,
                lambda: encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, T),
                lambda: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T),
                attn_work(B_KERNEL, Tp, D, H, T, elem_size(key)), peak=tc_peak(key),
                plain32_fn=lambda: encoder_block._plain_attn_ln(
                    x.float(), blk.attn_ln, blk.attn, H, T))
        x, ln, attn, want = k4_probe(dev, D, H, Tp, T)
        check_probe("K4", encoder_block.fused_attention_ln(x, ln, attn, H, T), want, T)
        del blk, x32, x
        k7_phase(kres, "K7", B_KERNEL, 8, 96, dev, SEED + 13)
        T, Tp, D, H, _, _ = geometry(dims_for("large-v3"))
        packed_phase(kres, "K8", B_KERNEL, D, H, dev, SEED + 19, T, Tp)
        q, k, v, want = k8_probe(dev, H, 128, Tp, T)
        check_probe("K8", flash.flash_attention_packed(q, k, v, H, T), want, T)
    log(json.dumps({"attn": kres}))
    log(smi)


def diag_phases(dev):
    """K11 and K12: each mode against its plain version, then each
    diagnostic's own counted run; (rows, launches by path)."""
    with torch.inference_mode():
        res = attn_parts_phase({}, dev)
        paths = attn_parts_run(res, dev)
        step_formulations_phase(res, dev)
        paths.update(step_formulations_run(res, dev))
    return res, paths


def diag_run(port, dev, smi):
    """``python3 chip_smoke.py --diag``: K11 and K12 alone, as the full run
    drives them.  Prints the rows as one JSON line."""
    res, paths = diag_phases(dev)
    log(json.dumps({"diag": res, "launches": paths}))
    log(smi)


def device_split(label, fn, calls=5):
    """Device ms per call of each kernel that ``fn`` launches, from
    ``torch.profiler``'s CUDA (CUPTI) events over ``calls`` warm calls;
    "not measured" where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us:
            split[e.key[:90]] = us / calls / 1000
    log(f"{label} device split (torch.profiler, mean of {calls} calls): "
        + ("; ".join(f"{k} {v:.4f} ms" for k, v in split.items()) or "not measured"))
    return split


def stem_run(port, dev, smi, repeats=3):
    """``python3 chip_smoke.py --stem``: K1 and the stem alone, for a quick
    loop on the card and for comparing two trees in one call.  K1 at 80 and
    128 bins (B=8, 30 s); the stem at tiny, medium and large-v3's shapes
    (B=8) with its two F.conv1d calls beside it; K4 and the finish at tiny
    and medium and the GEMM alone at medium's four products, which share
    the stem's GEMM; then the encoder stage (``encoder_apply``, host clock
    ending in a synchronize, ``repeats`` warm calls per dtype) of each
    size's encoder at full depth with PyTorch's default init.  Prints the
    rows and stages as one JSON line; no launch counts, no token checks
    (the full run has them)."""
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for
    from qasr_ijcnlp_tpu_torch.models.whisper import AudioEncoder, encoder_apply
    from qasr_ijcnlp_tpu_torch.ops import conv_stem, melfront

    rng = np.random.default_rng(SEED)
    kres, encoder_ms = {}, {}
    with torch.inference_mode():
        padded = melfront.reflect_pad(randn(rng, (B_KERNEL, 480000), dev, 0.1))
        for C0, kid in ((80, "K1"), (128, "K1_128")):
            kres[kid] = {"f32": compare(
                f"{kid} mel {C0} bins", "f32",
                lambda: melfront.clamp_and_scale(melfront.log10_mel(padded, C0)),
                lambda: melfront.clamp_and_scale(melfront._plain_log10_mel(padded, C0)),
                mel_work(B_KERNEL, padded.shape[1], 3000, C0), tol="mel", peak="tf32x3")}
            kres[kid]["f32"]["split"] = device_split(
                f"{kid} f32", lambda: melfront.log10_mel(padded, C0))
        del padded
        for name, ids in (("tiny", ("K2", "K4", "K5")), ("medium", ("K3", "K4_16h", "K6")),
                          ("large-v3", ("stem_1280",))):
            dims = dims_for(name)
            T, Tp, D, H, C0, Tm = geometry(dims)
            with torch.device(dev):
                enc = AudioEncoder(C0, T, D, H, dims.n_audio_layer)
            enc = enc.to(dev).requires_grad_(False)
            mel = randn(rng, (B_KERNEL, C0, Tm), dev)
            if len(ids) == 3:
                block_phase(kres, ids, enc, mel, rows(rng, B_KERNEL, Tp, D, T, dev), dims, dev)
            else:
                stem_rows(kres, ids[0], enc, mel, Tp)
            for dt, key in dtypes():
                kres[ids[0]][key]["split"] = device_split(
                    f"{ids[0]} {key}", lambda: conv_stem.fused_conv_stem(enc, mel, Tp, dt))
            if name == "medium":
                gemm_phase(dev, B_KERNEL * Tp, D)
            for dt, key in dtypes():
                encoder_apply(enc, mel, dims, dt)  # warm-up
                ms = []
                for _ in range(repeats):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    encoder_apply(enc, mel, dims, dt)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1000)
                encoder_ms[f"{name} {key}"] = ms
                log(f"{name} encoder stage B={B_KERNEL} {key}: "
                    + ", ".join(f"{m:.2f}" for m in ms) + " ms")
            del enc, mel
            gc.collect()
            torch.cuda.empty_cache()
    log(json.dumps({"stem": kres, "encoder_ms": encoder_ms}))
    log(smi)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this "
                         "check runs only on an NVIDIA GPU")
    if sys.argv[1:2] == ["--export-child"] and len(sys.argv) == 4:
        export_child(*sys.argv[2:])  # an exporting process, see BACKGROUND
        return
    if sys.argv[1:2] == ["--export-large"] and len(sys.argv) == 3:
        export_large_child(sys.argv[2])
        return
    if sys.argv[1:2] == ["--parallel-rank"] and len(sys.argv) == 4:
        parallel_rank(int(sys.argv[2]), sys.argv[3])  # a rank, see PARALLEL_WORLD
        return
    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for, tiny_dims

    # TF32 off for every plain fp32 product and convolution on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = device_lines()
    build_kernels()
    if sys.argv[1:] in ([], ["--parallel"]):
        start_parallel()  # the ranks import and join meanwhile; device work after "go"
    if sys.argv[1:2] in (["--k9"], ["--k10"]) and sys.argv[2:] in ([], ["--stages"]):
        run = k9_run if sys.argv[1] == "--k9" else k10_run
        run(port, dev, smi, stages=sys.argv[2:] == ["--stages"])
        return
    modes = {"--stem": stem_run, "--attn": attn_run, "--diag": diag_run,
             "--longform": longform_run, "--services": services_run,
             "--quantum": quantum_run, "--train": train_run, "--export": export_run,
             "--distill": distill_run, "--parallel": parallel_run}
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        modes[sys.argv[1]](port, dev, smi)
        log(f"total seconds: {time.perf_counter() - t_start:.1f}")
        ok_line()
        return
    if sys.argv[1:]:
        print(f"usage: python3 chip_smoke.py [--stem | --attn | --diag | --longform | "
              f"--services | --quantum | --train | --export | --distill | --parallel | --k9 "
              f"| --k10 [--stages]]; got "
              f"{sys.argv[1:]}",
              file=sys.stderr)
        raise SystemExit(2)

    start_background(["large", *TINY_EXPORTS, "cli"])  # they trace meanwhile
    kres, by_path = tiny_path(port, tiny_dims(), dev, smi)
    by_path.update(tiny_services(port, dev, smi))
    by_path.update(quantum_phases(port, dev, smi))
    by_path.update(train_phases(port, dev, smi))
    by_path.update(export_phases(port, dev, smi))
    by_path.update(distill_phases(port, dev, smi))
    # == medium and large-v3, full width and depth ==================================
    medium = dims_for("medium")
    large = replace(dims_for("large-v3"), n_audio_layer=LARGE_PATH_LAYERS,
                    n_text_layer=LARGE_PATH_LAYERS)
    mres, mpaths = family_path(port, "medium", medium, dev, smi, FUSED_EXPECT,
                               medium_kernel_phase, services=medium_services)
    lres, lpaths = family_path(port, "large-v3", large, dev, smi, large_expect(large),
                               large_kernel_phase, int8=True, beam=True, longform=True,
                               services=engine_phase)
    # == small's width and depth with head geometries off the family ===============
    # 8 heads of 96 (the trunk runs K7) and 6 of 128 in encoder and decoder
    # (K4 and K9 at head width 128).
    h96 = replace(dims_for("small"), n_audio_head=8)
    h128 = replace(dims_for("small"), n_audio_head=6, n_text_head=6)
    sres, spaths = family_path(port, "small-h96", h96, dev, smi, k7_expect(h96),
                               small_h96_kernel_phase)
    wres, wpaths = family_path(port, "small-h128", h128, dev, smi, fused_expect(h128),
                               small_h128_kernel_phase, int8=True)
    pres, ppaths = diag_phases(dev)
    # == parallelism: K4 head-sharded, the ranks on cuda:0 =========================
    tres, tpaths = parallel_phases(port, dev, smi)
    for res, paths in ((mres, mpaths), (lres, lpaths), (sres, spaths), (wres, wpaths),
                       (pres, ppaths), (tres, tpaths)):
        kres.update(res)
        by_path.update(paths)

    kernels = kernel_table(kres, by_path)
    log(json.dumps({"longform_stages": LONGFORM_STAGES}))
    log(json.dumps({"service_stages": SERVICE_STAGES}))
    log(json.dumps({"quantum_stages": QUANTUM_STAGES}))
    log(json.dumps({"train_stages": TRAIN_STAGES}, default=str))
    log(json.dumps({"export_distill_stages": EXPORT_STAGES}, default=str))
    log(json.dumps({"parallel_stages": PARALLEL_STAGES}, default=str))
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    ok_line()


def ok_line():
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_background()
