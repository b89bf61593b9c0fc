#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's request path (qasr_ijcnlp_tpu_torch) at the full width of
three Whisper sizes, with random weights from a seed and seeded synthetic
30-s PCM:

1. device lines: the card's name and power limit, torch/CUDA versions,
   whether ``regex`` imports;
2. builds the hand-written kernels from ``qasr_ijcnlp_tpu_torch/csrc`` (one
   nvcc per source, all at once) and prints the commands, the time and the
   ptxas register/smem lines;
3. **tiny** (4 + 4 layers, D 384): per kernel (K1 mel, K2 stem, K4
   attention, K5 finish) at B=8 (mel (8, 80, 3000), trunk (8, 1536, 384),
   t_real 1500), kernel vs its plain PyTorch version on the card in f32 and
   bf16 (K1 is f32 only, as in the reference); then 16 requests end to end in
   f32 (every kernel must launch, K8 never; two requests must give exactly
   the CPU plain path's tokens), bf16 token agreement, and wall time at B=16
   and B=64, with one more batch split into its stages (log-mel, encoder,
   decode);
4. **medium** (24 + 24 layers, D 1024, full depth): the stem at D 1024 (K3),
   K4 with 16 heads, the finish at D 1024 (K6) and the whole 24-layer trunk
   (8, 1536, 1024) against their plain versions; then a batch of 8 end to
   end in f32 and bf16 (wall time and stages), where the stem, K4 and the
   finish must launch and K8 never;
5. **large-v3** (32 + 32 layers, D 1280, 128 mels, vocab 51866, full depth):
   K1 at 128 mels, the stem at D 1280, and K8 on (8, 1536, 1280) with 20
   heads and t_real 1500 (timed beside ``scaled_dot_product_attention`` as
   its library yardstick); then a batch of 8 end to end, where K1 and the
   stem must launch, K8 exactly 32 times, K4 and the finish never.
   In every kernel phase the padding rows of the trunk inputs are one
   repeated row, as the trunk leaves them, and bf16 is held to twice the
   plain bf16 version's own distance from f32 (``compare``).  Two rounding
   probes (medium: K4, large-v3: K8) check in bf16, bit for bit, the one
   rounding point where K4 and K8 differ;
6. for medium and large-v3, request 0's f32 tokens are checked against the
   CPU plain path (log-mel, encoder and decoder on the CPU), teacher-forced
   on the card's tokens: at every step the card's token must be the CPU's
   argmax or within 1e-4 of its top logit; the smallest top-2 margin is
   printed;
7. prints the per-kernel JSON line (every ported kernel with its launches,
   times, error and bound), the card line, then ``{"ok": true, "device":
   ...}`` as the last line.

Launch counts are read from each path's own f32 batch, with every counter
set to 0 just before it.  Any failure raises (non-zero exit) and nothing is
printed as a result.  There is no CPU fallback: without a CUDA device the
script exits non-zero at once.
"""

import gc
import json
import math
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
# H100 SXM datasheet peaks: fp32 on the CUDA cores, bf16
# dense on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
B_KERNEL = 8


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


def bound(flops, nbytes, key):
    """Least time (ms) the card could take: the larger of the operations at
    the peak rate of their type and the bytes at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[key] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name, key, kernel_fn, plain_fn, work, tol="f32", plain32_fn=None,
            library_fn=None, iters=10, warmup=2):
    """Kernel vs its plain version on the same inputs; ``work`` is (flops,
    bytes) of the function at these shapes.  f32 is held to ``TOL[tol]``,
    bf16 to NOISE_FACTOR times the distance of the plain bf16 version from
    ``plain32_fn`` (the plain version in f32 on the same bf16-valued
    inputs).  A library yardstick must agree with the plain version within
    the same limit, or its time is not this function's."""
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
    del k, p
    if err > limit:
        raise AssertionError(f"{name} {key}: error {err} outside tolerance {tol_txt}")
    if lib_err is not None and lib_err > limit:
        raise AssertionError(f"{name} {key}: the library call is {lib_err} from the "
                             f"plain version, outside {tol_txt}: not the same function")
    ms = cuda_ms(kernel_fn, iters, warmup)
    plain_ms = cuda_ms(plain_fn, iters, warmup)
    lib_ms = cuda_ms(library_fn, iters, warmup) if library_fn is not None else None
    bound_ms, bound_by = bound(*work, key)
    log(f"{name} {key}: max_abs_err {err:.3e} (tol {tol_txt}) kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms"
        + (f" library {lib_ms:.4f} ms (its max_abs_err {lib_err:.3e})"
           if lib_ms is not None else "")
        + f" bound {bound_ms:.4f} ms ({bound_by}: {work[0] / 1e9:.2f} GFLOP, "
          f"{work[1] / 1e6:.1f} MB)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


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

def block_phase(res, ids, enc, mel, x32, dims, dev):
    """The stem, K4 and the finish against their plain versions in f32 and
    bf16, recorded under ``ids`` (stem, attention, finish)."""
    from qasr_ijcnlp_tpu_torch.ops import conv_stem, encoder_block

    T, Tp, D, H, C0, Tm = geometry(dims)
    B, blk = x32.shape[0], enc.blocks[0]
    for dt, key in dtypes():
        s = elem_size(key)
        x = x32.to(dt)
        attn = encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T)
        res.setdefault(ids[0], {})[key] = compare(
            f"{ids[0]} stem D{D}", key, lambda: conv_stem.fused_conv_stem(enc, mel, Tp, dt),
            lambda: conv_stem._plain_stem(enc, mel, Tp, dt),
            stem_work(B, C0, Tm, D, T, Tp, s),
            plain32_fn=lambda: conv_stem._plain_stem(enc, mel, Tp, torch.float32))
        res.setdefault(ids[1], {})[key] = compare(
            f"{ids[1]} attention {H} heads", key,
            lambda: encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, T),
            lambda: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, T),
            attn_work(B, Tp, D, H, T, s),
            plain32_fn=lambda: encoder_block._plain_attn_ln(
                x.float(), blk.attn_ln, blk.attn, H, T))
        res.setdefault(ids[2], {})[key] = compare(
            f"{ids[2]} finish D{D}", key,
            lambda: encoder_block.fused_block_finish(x, attn, blk),
            lambda: encoder_block._plain_finish(x, attn, blk), finish_work(B, Tp, D, s),
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
        mel_work(B_KERNEL, padded.shape[1], Tm, C0), tol="mel")}}
    return block_phase(res, ("K2", "K4", "K5"), model.module.encoder, mel, x32, dims, dev)


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
            tol="trunk_f32", plain32_fn=lambda: plain_trunk(enc, x.float(), dims, T),
            iters=2, warmup=1)
    return res


def large_kernel_phase(model, dev):
    import torch.nn.functional as F

    from qasr_ijcnlp_tpu_torch.ops import conv_stem, flash, head_scale, melfront

    rng = np.random.default_rng(SEED + 2)
    B, dims = B_KERNEL, model.dims
    T, Tp, D, H, C0, Tm = geometry(dims)
    enc = model.module.encoder
    pcm = randn(rng, (B, Tm * 160), dev, 0.1)
    mel = randn(rng, (B, C0, Tm), dev)
    q32, k32, v32 = (rows(rng, B, Tp, D, T, dev) for _ in range(3))
    res = {}

    padded = melfront.reflect_pad(pcm)
    res["K1_128"] = {"f32": compare(
        f"K1 mel {C0} bins", "f32",
        lambda: melfront.clamp_and_scale(melfront.log10_mel(padded, C0)),
        lambda: melfront.clamp_and_scale(melfront._plain_log10_mel(padded, C0)),
        mel_work(B, padded.shape[1], Tm, C0), tol="mel")}
    keep = (torch.arange(Tp, device=dev) < T)[None]  # (1, Tk), True = attend
    for dt, key in dtypes():
        s = elem_size(key)
        res.setdefault("stem_1280", {})[key] = compare(
            f"stem D{D} {C0} mels", key,
            lambda: conv_stem.fused_conv_stem(enc, mel, Tp, dt),
            lambda: conv_stem._plain_stem(enc, mel, Tp, dt),
            stem_work(B, C0, Tm, D, T, Tp, s),
            plain32_fn=lambda: conv_stem._plain_stem(enc, mel, Tp, torch.float32))
        sc = head_scale(D // H, dt)
        q, k, v = q32.to(dt) * sc, k32.to(dt) * sc, v32.to(dt)
        heads = lambda z: z.view(B, Tp, H, D // H).transpose(1, 2)
        res.setdefault("K8", {})[key] = compare(
            "K8 packed attention", key,
            lambda: flash.flash_attention_packed(q, k, v, H, T),
            lambda: flash._plain_attention_packed(q, k, v, H, T),
            packed_work(B, Tp, Tp, D, H, T, s),
            plain32_fn=lambda: flash._plain_attention_packed(
                q.float(), k.float(), v.float(), H, T),
            library_fn=lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), attn_mask=keep, scale=1.0).transpose(1, 2))
        del q, k, v
    q, k, v, want = k8_probe(dev, H, 128, Tp, T)
    check_probe("K8", flash.flash_attention_packed(q, k, v, H, T), want, T)
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


def options(port, fp16):
    return port.DecodingOptions(fp16=fp16, suppress_tokens=[EOT], **BENCH_OPTIONS)


def run_requests(port, model, pcm, fp16):
    mel = port.log_mel_spectrogram(pcm, n_mels=model.dims.n_mels, device=model.device)
    return port.decode(model, mel, options(port, fp16))


def check_results(results, n, dims):
    if len(results) != n:
        raise AssertionError(f"expected {n} results, got {len(results)}")
    for r in results:
        if len(r.tokens) != BENCH_OPTIONS["sample_len"] or not np.isfinite(r.avg_logprob):
            raise AssertionError(f"bad result: {len(r.tokens)} tokens, {r.avg_logprob}")
        if r.audio_features.shape != (dims.n_audio_ctx, dims.n_audio_state) or \
                not torch.isfinite(r.audio_features).all():
            raise AssertionError("bad audio features")


def stage_times(port, model, pcm, fp16):
    """Host-clock ms of each stage of one warm request batch: PCM (host) to
    log-mel, encoder, and decode (cross K/V, prompt, greedy loop, results),
    each ended by a synchronize."""
    from qasr_ijcnlp_tpu_torch.models.whisper import encoder_apply

    dt = torch.bfloat16 if fp16 else torch.float32
    marks = [time.perf_counter()]
    mel = port.log_mel_spectrogram(pcm, n_mels=model.dims.n_mels, device=model.device)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    with torch.inference_mode():
        feats = encoder_apply(model.module.encoder, mel, model.dims, dt)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    port.decode(model, feats, options(port, fp16))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ms = [(b - a) * 1000 for a, b in zip(marks, marks[1:])]
    log(f"{model.name} stages B={pcm.shape[0]} {'bf16' if fp16 else 'f32'}: mel "
        f"{ms[0]:.1f} ms, encoder {ms[1]:.1f} ms, decode {ms[2]:.1f} ms")
    return ms


def time_batch(port, model, pcm, fp16, repeats=3):
    run_requests(port, model, pcm, fp16)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        run_requests(port, model, pcm, fp16)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / repeats
    return dt, pcm.shape[0] * 30.0 / dt


def counters():
    from qasr_ijcnlp_tpu_torch.ops import conv_stem, encoder_block, flash, melfront

    return {"mel": (melfront, "launches"), "stem": (conv_stem, "launches"),
            "attn": (encoder_block, "attn_launches"),
            "finish": (encoder_block, "finish_launches"), "packed": (flash, "launches")}


# Launches a batch must show: None is "at least once", a number exact.  The
# fused trunk (tiny to medium) never runs K8; large-v3's unfused trunk runs
# K8 once per layer and never the fused block.
FUSED_EXPECT = {"mel": None, "stem": None, "attn": None, "finish": None, "packed": 0}


def large_expect(dims):
    return {"mel": None, "stem": None, "attn": 0, "finish": 0,
            "packed": dims.n_audio_layer}


def counted_run(port, model, pcm, expect):
    """One f32 batch with every launch counter set to 0 just before it;
    ``expect`` maps a counter to an exact count, or None for "at least 1"."""
    cs = counters()
    for mod, attr in cs.values():
        setattr(mod, attr, 0)
    res = run_requests(port, model, pcm, fp16=False)
    torch.cuda.synchronize()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in cs.items()}
    log(f"main-path launches ({model.name}, f32, {pcm.shape[0]} requests):",
        json.dumps(launches))
    for k, want in expect.items():
        got = launches[k]
        if (want is None and got == 0) or (want is not None and got != want):
            raise AssertionError(f"{model.name}: {k} launched {got} times, expected "
                                 f"{'at least 1' if want is None else want}")
    return res, launches


def teacher_forced_check(port, cpu_model, pcm0, card_result):
    """Request 0 on the CPU plain path, teacher-forced on the card's tokens."""
    from qasr_ijcnlp_tpu_torch.decode import DecodingTask
    from qasr_ijcnlp_tpu_torch.decode.filters import apply_filters
    from qasr_ijcnlp_tpu_torch.models.whisper import decoder_apply, encoder_apply

    dims = cpu_model.dims
    task = DecodingTask(cpu_model, options(port, False))
    with torch.inference_mode():
        mel = port.log_mel_spectrogram(pcm0[None], n_mels=dims.n_mels, device="cpu")
        xa = encoder_apply(cpu_model.module.encoder, mel, dims)
        feat_err = float((card_result.audio_features.float().cpu() - xa[0]).abs().max())
        toks = list(task.initial_tokens) + list(card_result.tokens)
        logits = decoder_apply(cpu_model.module.decoder, torch.tensor([toks]), xa, dims)[0]
    sb = task.sample_begin
    last = prev = torch.tensor([-1])
    min_margin, worst = math.inf, 0.0
    for i, tok in enumerate(card_result.tokens):
        f = apply_filters(task.loop_cfg.filters, logits[sb - 1 + i][None], sb + i, last,
                          prev, torch.zeros(1, dtype=torch.long))[0]
        top2 = torch.topk(f, 2).values
        min_margin = min(min_margin, float(top2[0] - top2[1]))
        behind = float(top2[0] - f[tok])
        worst = max(worst, behind)
        if behind > TOKEN_TIE:
            raise AssertionError(f"{cpu_model.name}: step {i}, card token {tok} is "
                                 f"{behind:.3e} below the CPU's top logit")
        prev, last = last, torch.tensor([tok])
    log(f"{cpu_model.name}: request 0 f32 tokens pass the CPU teacher-forced check "
        f"({len(card_result.tokens)} steps; card token behind the CPU top logit by at "
        f"most {worst:.3e}; smallest top-2 margin {min_margin:.3e}; encoder output "
        f"max |card - CPU| {feat_err:.3e})")
    return min_margin


def family_path(port, dims_name, dims, dev, smi, expect, kernel_phase):
    """Kernel phases and end to end for one size."""
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
    res32, launches = counted_run(port, gpu, pcm, expect)
    check_results(res32, B_KERNEL, dims)
    margin = teacher_forced_check(port, cpu, pcm[0], res32[0])
    res16 = run_requests(port, gpu, pcm, fp16=True)
    check_results(res16, B_KERNEL, dims)
    same = sum(a == b for r, s in zip(res32, res16) for a, b in zip(r.tokens, s.tokens))
    total = sum(len(r.tokens) for r in res32)
    log(f"{dims_name}: bf16 vs f32 token agreement {same}/{total} = {same / total:.4f}")
    log(f"{dims_name}: request 0 text: {res32[0].text[:120]!r}")
    for fp16 in (True, False):
        sec, rate = time_batch(port, gpu, pcm, fp16, repeats=2)
        log(f"{dims_name} end to end B={B_KERNEL} {'bf16' if fp16 else 'f32'}: "
            f"{sec * 1000:.1f} ms/batch, {rate:.1f} audio-s/s ({smi})")
        stage_times(port, gpu, pcm, fp16)
    del gpu, cpu, sd, res32, res16
    gc.collect()
    torch.cuda.empty_cache()
    return kres, launches, margin


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this "
                         "check runs only on an NVIDIA GPU")
    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for, tiny_dims
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    # TF32 off for every plain fp32 product and convolution on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = device_lines()
    build_kernels()

    # == tiny ===================================================================
    dims = tiny_dims()
    sd = init_params(torch.Generator().manual_seed(SEED), dims)
    gpu_model = port.WhisperModel.from_state_dict(sd, dims, dev, name="tiny (random)")
    cpu_model = port.WhisperModel.from_state_dict(sd, dims, "cpu", name="tiny (random)")

    with torch.inference_mode():
        kres = tiny_kernel_phase(gpu_model, dev)

    pcm16 = synthetic_pcm(16, SEED)
    res32, tiny_launches = counted_run(port, gpu_model, pcm16, FUSED_EXPECT)
    check_results(res32, 16, dims)

    cpu_res = run_requests(port, cpu_model, pcm16[:2], fp16=False)
    for i in range(2):
        if cpu_res[i].tokens != res32[i].tokens:
            raise AssertionError(f"request {i}: GPU f32 tokens differ from the CPU "
                                 f"plain path:\n{res32[i].tokens}\n{cpu_res[i].tokens}")
    log("f32 tokens identical to the CPU plain path for requests 0, 1")
    log("request 0 text:", repr(res32[0].text[:120]))

    res16 = run_requests(port, gpu_model, pcm16, fp16=True)
    check_results(res16, 16, dims)
    same = sum(a == b for r, s in zip(res32, res16) for a, b in zip(r.tokens, s.tokens))
    total = sum(len(r.tokens) for r in res32)
    log(f"bf16 vs f32 token agreement: {same}/{total} = {same / total:.4f}")
    pcm64 = np.concatenate([pcm16] * 4)
    for B, pcm in ((16, pcm16), (64, pcm64)):
        for fp16 in (True, False):
            sec, rate = time_batch(port, gpu_model, pcm, fp16)
            log(f"end to end B={B} {'bf16' if fp16 else 'f32'}: {sec * 1000:.1f} ms/batch, "
                f"{rate:.1f} audio-s/s ({smi})")
            stage_times(port, gpu_model, pcm, fp16)
    del gpu_model, cpu_model, sd
    gc.collect()
    torch.cuda.empty_cache()

    # == medium and large-v3, full width and depth ==================================
    medium, large = dims_for("medium"), dims_for("large-v3")
    mres, medium_launches, _ = family_path(
        port, "medium", medium, dev, smi, FUSED_EXPECT, medium_kernel_phase)
    lres, large_launches, _ = family_path(
        port, "large-v3", large, dev, smi, large_expect(large), large_kernel_phase)
    kres.update(mres)
    kres.update(lres)

    by_path = {"tiny": tiny_launches, "medium": medium_launches, "large-v3": large_launches}
    src = "qasr_ijcnlp_tpu_torch/csrc/"
    tpu = "qasr_ijcnlp_tpu/ops/"
    # (entry, TPU kernel, source, replaces, counter, path, shape)
    rows = [
        ("mel", "K1", src + "melfront.cu", tpu + "melfront.py:48", "mel", "tiny",
         "(8, 480000) -> (8, 80, 3000)"),
        ("conv_stem", "K2", src + "conv_stem.cu", tpu + "conv_stem.py:82", "stem", "tiny",
         "(8, 80, 3000) -> (8, 1536, 384)"),
        ("conv_stem_d1024", "K3", src + "conv_stem.cu", tpu + "conv_stem.py:119", "stem",
         "medium", "(8, 80, 3000) -> (8, 1536, 1024)"),
        ("encoder_attention", "K4", src + "encoder_block.cu", tpu + "encoder_block.py:148",
         "attn", "tiny", "(8, 1536, 384), 6 heads, t_real 1500"),
        ("encoder_finish", "K5", src + "encoder_block.cu", tpu + "encoder_block.py:238",
         "finish", "tiny", "(8, 1536, 384)"),
        ("encoder_finish_d1024", "K6", src + "encoder_block.cu",
         tpu + "encoder_block.py:259", "finish", "medium", "(8, 1536, 1024)"),
        ("packed_attention", "K8", src + "flash.cu", tpu + "flash.py:119", "packed",
         "large-v3", "(8, 1536, 1280), 20 heads, t_real 1500"),
    ]
    kernels = []
    for name, kid, source, replaces, counter, path, shape in rows:
        entry = {"name": name, "tpu_kernel": kid, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": by_path[path][counter], "path": path,
                 "shape": shape, **kres[kid]["f32"],
                 "launches_by_path": {p: c[counter] for p, c in by_path.items()}}
        if "bf16" in kres[kid]:
            entry.update({f"bf16_{key}": v for key, v in kres[kid]["bf16"].items()})
        kernels.append(entry)
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
