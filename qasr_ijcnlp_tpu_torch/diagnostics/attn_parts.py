"""The attention core's diagnostic split (K11): dots only, softmax only, or
both, timed on the card.

    python3 -m qasr_ijcnlp_tpu_torch.diagnostics.attn_parts [--batch 512] [--repeats 5]

Replaces ``scripts/bench_attn_parts.py`` (its Pallas ``kernel``): bf16 q, k
and v (B, Tp, D) at tiny's encoder geometry (Tp 1536, D 384, six 64-wide
heads), no mask, no scale, in three modes, each as the TPU body writes it:

* ``dots``: p = bf16(fp32 q k^T) with no softmax; out = bf16(p v);
* ``softmax``: logits = q[:, 0] k[:, 0]^T in fp32 (one product per pair,
  no dot product); p = bf16(softmax(logits)); out = the first 64 columns of
  p.  The script writes the product in bf16 and then casts it to fp32;
  XLA folds that round trip, so the kernel computes the product in fp32
  (its interpret-mode output equals the unrounded product's bit for bit),
  and the port follows the kernel;
* ``full``: p = bf16(softmax(fp32 q k^T)), normalised before PV;
  out = bf16(p v).

The kernel (``csrc/attn_parts.cu``) runs ``dots`` and ``full`` on the
tensor-core attention core that K4, K7 and K8 run (``csrc/
attention_tc.cuh``, its kTcDots and kTcFull modes), so full - dots is that
core's softmax cost; ``full`` walks the key tiles twice (each row's max and
fp32 denominator, then the products with the normalised, rounded p).
``softmax`` is a SIMT kernel bound by the special-function units: one
exponential per (query, key) pair.  The TPU grid ran its head pairs in
order into one (B, Tp, 128) output block, so only heads 4-5 remained;
blocks on the card run in no order, so every head writes its own columns
of a (B, Tp, D) output, whose columns 256-383 are the TPU kernel's output.

The module prints each mode's time (CUDA events, median of the repeats,
one launch each, after a warm-up), its bound and the card's name and power
limit.  It runs only on an NVIDIA GPU: the plain versions below serve CPU
tensors and the checks, and at B = 512 the plain softmax's fp32 logits
alone would take 29 GB.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

from .. import _kernels

MODES = ("dots", "softmax", "full")
# The TPU script's shapes: B, Tp, D, heads (of 64).
BATCH, T_PAD, D_MODEL, N_HEAD = 512, 1536, 384, 6
HEAD_WIDTH = 64
# H100 SXM datasheet peaks: fp32 on the CUDA cores, bf16 dense on the
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# exp2 results per SM per clock on compute capability 9.0 (the special-
# function units; CUDA C++ Programming Guide, throughput of native
# arithmetic instructions), and the H100 SXM's SM count and maximum SM
# clock (MHz), which ``exp_rate`` reads from the card where it runs.
SFU_EXP_PER_SM_CLOCK = 16
H100_SMS, H100_MAX_SM_MHZ = 132, 1980

launches = 0


def _split(x):
    B, T, D = x.shape
    return x.reshape(B, T, D // HEAD_WIDTH, HEAD_WIDTH).transpose(1, 2)


def attn_parts_plain(q, k, v, mode: str):
    """Plain PyTorch version of ``mode`` on (B, Tp, D) q, k, v -> (B, Tp, D).
    The bf16 roundings of the mode happen where the inputs are bf16; on
    float32 inputs the same formulas run with none of them."""
    qh, kh, vh = _split(q), _split(k), _split(v)
    if mode == "softmax":
        logits = qh[..., :1].float() * kh[..., :1].float().transpose(-1, -2)
    else:
        logits = qh.float() @ kh.float().transpose(-1, -2)
    if mode == "dots":
        p = logits
    else:
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    p = p.to(q.dtype)
    out = p[..., :HEAD_WIDTH] if mode == "softmax" else p.float() @ vh.float()
    B, _, T, _ = out.shape
    return out.transpose(1, 2).reshape(B, T, q.shape[-1]).to(q.dtype)


def attn_parts(q, k, v, mode: str):
    """``mode`` of the split on bf16 (B, Tp, D) q, k, v (D in heads of 64,
    Tp a multiple of 64; on the card contiguous and 16-byte aligned, which
    the core's TMA copies need) -> bf16 (B, Tp, D)."""
    if mode not in MODES:
        raise ValueError(f"attn_parts: mode {mode!r} is not one of {MODES}")
    if not q.is_cuda:
        return attn_parts_plain(q, k, v, mode)
    global launches
    if q.dim() != 3 or q.dtype != torch.bfloat16 or k.shape != q.shape or \
            v.shape != q.shape:
        raise ValueError(f"attn_parts: expected bf16 (B, Tp, D) q, k, v of one shape, "
                         f"got {tuple(q.shape)} {q.dtype}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tp, D = q.shape
    if D % HEAD_WIDTH or Tp % 64 or Tp < HEAD_WIDTH:
        raise ValueError(f"attn_parts: needs D a multiple of {HEAD_WIDTH} and Tp a "
                         f"multiple of 64, got Tp={Tp}, D={D}")
    out = torch.empty_like(q)
    _kernels.check_cuda("attn_parts", q, k, v, out, dtype=torch.bfloat16)
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("attn_parts: q, k and v must be 16-byte aligned")
    _kernels.library().call("qasr_attn_parts", q.device, MODES.index(mode), q.data_ptr(),
                            k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tp, D)
    launches += 1
    return out


def work(mode: str, B: int, Tp: int, D: int):
    """(operations, bytes, peak key, exponentials) the function needs at
    these shapes: the products of q k^T and p v (dots, full) at the bf16
    peak, or the softmax's four fp32 operations per (query, key) pair
    (product, max, subtraction, sum; softmax); q, k, v read once (softmax:
    column 0 of each head of q and k) and out written once, in bf16; one
    exponential per pair for softmax and full (their softmax), none for
    dots."""
    pairs = B * (D // HEAD_WIDTH) * Tp * Tp
    if mode == "softmax":
        return 4 * pairs, 2 * (2 * B * Tp * (D // HEAD_WIDTH) + B * Tp * D), "f32", pairs
    return 4 * pairs * HEAD_WIDTH, 2 * 4 * B * Tp * D, "bf16", 0 if mode == "dots" else pairs


def exp_rate(sms: int = H100_SMS, sm_mhz: float = H100_MAX_SM_MHZ) -> float:
    """Exponentials per second of the special-function units: 16 per SM
    per clock (compute capability 9.0) x ``sms`` x the maximum SM clock,
    4.18e12 /s on an H100 SXM (132 SMs, 1,980 MHz)."""
    return SFU_EXP_PER_SM_CLOCK * sms * sm_mhz * 1e6


def card_exp_rate(device) -> float:
    """``exp_rate`` of the card: its SM count and ``nvidia-smi --query-gpu=
    clocks.max.sm``."""
    index = torch.device(device).index or 0
    mhz = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return exp_rate(torch.cuda.get_device_properties(index).multi_processor_count, float(mhz))


def bound_ms(flops: float, nbytes: float, key: str, exps: float = 0,
             exp_per_s: float = exp_rate()):
    """Least time (ms) the card could take, and what bounds it: the largest
    of the operations at the peak of their type, the bytes at the HBM rate
    and the exponentials at ``exp_per_s`` (special-function operations,
    reported as "operations")."""
    t_ops = max(flops / PEAK_FLOPS[key], exps / exp_per_s) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def inputs(batch: int, seed: int, device, tp: int = T_PAD):
    """Seeded N(0, 1) bf16 q, k, v of (batch, tp, D_MODEL), made on the
    device."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(batch, tp, D_MODEL, generator=g, device=device)
            .to(torch.bfloat16) for _ in range(3)]


def peaked_inputs(batch: int, seed: int, device, tp: int = T_PAD, lift: float = 4.0):
    """bf16 q, k, v whose logits are peaked in the last key tile: per
    (batch item, head) a unit vector u, every query row N(0, 0.5^2) + lift
    u, keys N(0, 0.5^2) but key tp - 1 - (b H + h) % 64 = lift u (so its
    logit is ~lift^2 = 16, the rest spread by ~3 and topping out near 10),
    values N(0, 1).  A two-pass softmax that took its max or denominator
    from the first key tiles only, or normalised p late, misses by the
    output's own size."""
    g = torch.Generator(device=device).manual_seed(seed)
    H = D_MODEL // HEAD_WIDTH
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    u = r(batch, 1, H, HEAD_WIDTH)
    u = u / u.norm(dim=-1, keepdim=True)
    q = r(batch, tp, H, HEAD_WIDTH) * 0.5 + lift * u
    k = r(batch, tp, H, HEAD_WIDTH) * 0.5
    bh = torch.arange(batch * H, device=device).view(batch, H)
    k[bh // H, tp - 1 - bh % 64, bh % H] = lift * u[:, 0]
    v = r(batch, tp, D_MODEL)
    return [x.reshape(batch, tp, D_MODEL).to(torch.bfloat16) for x in (q, k, v)]


def measure(batch: int = BATCH, repeats: int = 5, seed: int = 0, device="cuda"):
    """Each mode's kernel time on the card: {mode: {"ms", "bound_ms",
    "bound_by", "times_ms"}}, the median of ``repeats`` single launches
    after one warm-up, each timed by CUDA events; the exponentials of the
    bound at the card's own rate (``card_exp_rate``)."""
    q, k, v = inputs(batch, seed, device)
    rate = card_exp_rate(device)
    res = {}
    for mode in MODES:
        attn_parts(q, k, v, mode)  # warm-up
        times = []
        for _ in range(repeats):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            attn_parts(q, k, v, mode)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        b_ms, b_by = bound_ms(*work(mode, batch, T_PAD, D_MODEL), exp_per_s=rate)
        res[mode] = {"ms": statistics.median(times), "bound_ms": b_ms, "bound_by": b_by,
                     "times_ms": times}
    return res


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_parts: needs an NVIDIA GPU (torch.cuda.is_available() "
                         "is False)")
    card = card_line()
    print(card)
    print(f"B={args.batch}, Tp={T_PAD}, D={D_MODEL}, {N_HEAD} heads of {HEAD_WIDTH}, bf16")
    for mode, r in measure(args.batch, args.repeats, args.seed).items():
        print(f"{mode}: {r['ms']:.3f} ms (median of {args.repeats}); bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}) [{card}]")


if __name__ == "__main__":
    main()
