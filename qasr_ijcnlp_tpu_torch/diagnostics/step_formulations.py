"""The decode step's cross-attention in four formulations (K12), timed on
the card against the read floor.

    python3 -m qasr_ijcnlp_tpu_torch.diagnostics.step_formulations [B]

Replaces ``scripts/bench_step_formulations.py`` (its Pallas bodies
``_dma_kernel``, ``_vpu_kernel``, ``_mxu_t_kernel`` and ``_mxu_r_kernel``):
one bf16 query row per batch item, q (B, 384), over its own K/V cache of Ta
positions, six heads of 64, no scale, no mask:

* ``dma``: q 1e-30 + sum_t k + sum_t v in fp32 on (B, Ta, D) k, v, output
  (B, 1, D) fp32: every byte read once and reduced, the floor the others
  are held to;
* ``vpu``: per row and head softmax(q k^T) v, all fp32, on the
  "T-on-lanes" layout (B, D, Ta), output bf16 (B, D);
* ``mxu_t``: the same on the tensor cores on (B, D, Ta): q expanded
  block-diagonally, products in bf16 with fp32 sums, p rounded to bf16
  for PV and for the denominator;
* ``mxu_r``: the same on the tensor cores on row-major (B, Ta, D) blocks of
  8 rows, the cross-row products computed and masked, p rounded to bf16
  for PV (the denominator sums the fp32 p).  The TPU body wrote its raw,
  unnormalised accumulator rows; the port writes the normalised attention.

The script's CHUNK (256 positions) and BT (8 rows) are TPU tile sizes; the
port's kernel (``csrc/step_formulations.cu``, one launch a call for every
mode: a producer warp's bulk copies or TMA boxes into a ring of shared-
memory slots, the consumers of the mode, and the splits of t merged in the
same launch by the last block of each group) chooses its own tiles, so the
entry point takes only B (Ta is the script's 1536).  Each block runs an
online softmax over chunks of ``CHUNK[mode]`` positions within its split
of t (``splits``); the plain versions below take one max over the whole
row, which moves each bf16-rounded p by at most its own rounding step.

For each mode the module prints the time per call (CUDA-graph replays of
a run of launches, timed by CUDA events; one set of inputs, 151 MB at
B = 64, more than the 50-MB L2, so every call reads from device memory),
the effective rate 2 B Ta D 2 bytes / time (flagged above the card's 3,350
GB/s, where the timing must be wrong), the spread of three replays (ok at
<= 10%, as the script) and the card's name and power limit.  It runs only
on an NVIDIA GPU; the plain versions serve CPU tensors and the checks.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from .. import _kernels

MODES = ("dma", "vpu", "mxu_t", "mxu_r")
# The TPU script's shapes: B, Ta, D, heads (of 64).
BATCH, T_AUDIO, D_MODEL, N_HEAD = 64, 1536, 384, 6
HEAD_WIDTH = 64
# Positions of each mode's chunk: one ring item of K or V
# (csrc/step_formulations.cu ``sf_chunk``; mxu_r's item holds 8 rows).
CHUNK = {"dma": 64, "vpu": 64, "mxu_t": 64, "mxu_r": 8}
# Rows of a group (mxu_r's block-diagonal q columns cover 8 rows).
GROUP_ROWS = {"dma": 1, "vpu": 1, "mxu_t": 1, "mxu_r": 8}
# H100 SXM datasheet peaks: fp32 on the CUDA cores, bf16 dense on the
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12

launches = 0
_tickets = {}  # device -> int32 zeros, one merge ticket per group, left 0 by every call


def lanes(mode: str) -> bool:
    """True where the mode takes k, v as (B, D, Ta) ("T-on-lanes")."""
    return mode in ("vpu", "mxu_t")


def splits(mode: str, B: int, Ta: int, sms: int) -> int:
    """The kernel's splits of t (``sf_splits``): one block per SM for the
    groups (rows, or mxu_r's groups of 8 rows), at most one per chunk."""
    groups = B // GROUP_ROWS[mode]
    return max(1, min(Ta // CHUNK[mode], sms // max(groups, 1)))


def split_chunks(mode: str, Ta: int, S: int):
    """[first, end) chunk of each of the S splits, as the blocks take them."""
    n = Ta // CHUNK[mode]
    return [(s * n // S, (s + 1) * n // S) for s in range(S)]


def card_splits(mode: str, B: int, Ta: int, device) -> int:
    """``splits`` on the card holding ``device``."""
    sms = torch.cuda.get_device_properties(torch.device(device)).multi_processor_count
    return splits(mode, B, Ta, sms)


def _ticket_buffer(device, groups: int):
    """The device's merge tickets: zeroed once (a fill launch, on the first
    call on the device), then reset to 0 by the block that merges.  Calls on
    one device must not overlap."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < groups:
        buf = _tickets[device] = torch.zeros(max(groups, 4096), dtype=torch.int32,
                                             device=device)
    return buf


def step_formulations_plain(q, k, v, mode: str):
    """Plain PyTorch version of ``mode``: q (B, D); k, v (B, D, Ta) for vpu
    and mxu_t, (B, Ta, D) for dma and mxu_r.  The bf16 roundings of p happen
    where q is bf16; on float32 inputs the same formulas run with none."""
    B, D = q.shape
    if mode == "dma":
        return (q.float() * 1e-30 + k.float().sum(1) + v.float().sum(1))[:, None]
    H = D // HEAD_WIDTH
    if lanes(mode):
        kh, vh = (x.float().reshape(B, H, HEAD_WIDTH, -1) for x in (k, v))
    else:
        kh, vh = (x.float().reshape(B, -1, H, HEAD_WIDTH).permute(0, 2, 3, 1) for x in (k, v))
    logits = (q.float().reshape(B, H, 1, HEAD_WIDTH) @ kh)[:, :, 0]  # (B, H, Ta)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    pr = p if mode == "vpu" else p.to(q.dtype).float()
    den = (p if mode in ("vpu", "mxu_r") else pr).sum(-1)
    out = (vh @ pr[..., None])[..., 0] / den[..., None]  # (B, H, dh)
    return out.reshape(B, D).to(q.dtype)


def step_formulations(q, k, v, mode: str):
    """``mode`` on bf16 q (B, 384) and k, v in the mode's layout (Ta a
    multiple of 64; mxu_r: B a multiple of 8) -> (B, 1, 384) fp32 for dma,
    else bf16 (B, 384)."""
    if mode not in MODES:
        raise ValueError(f"step_formulations: mode {mode!r} is not one of {MODES}")
    if not q.is_cuda:
        return step_formulations_plain(q, k, v, mode)
    global launches
    if q.dim() != 2 or k.dim() != 3 or q.shape[1] != D_MODEL:
        raise ValueError(f"step_formulations: expected q (B, {D_MODEL}), got "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    B = q.shape[0]
    Ta = k.shape[2] if lanes(mode) else k.shape[1]
    want = (B, D_MODEL, Ta) if lanes(mode) else (B, Ta, D_MODEL)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"step_formulations {mode}: expected k, v of {want}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Ta % 64 or (mode == "mxu_r" and B % 8):
        raise ValueError(f"step_formulations {mode}: needs Ta % 64 == 0"
                         + (" and B % 8 == 0" if mode == "mxu_r" else "")
                         + f", got B={B}, Ta={Ta}")
    _kernels.check_cuda("step_formulations", q, k, v, dtype=torch.bfloat16)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("step_formulations: k and v must be 16-byte aligned")
    S = card_splits(mode, B, Ta, q.device)
    # one (m, l, acc) slot of a group's rows per block
    scratch = torch.empty(B * S * (D_MODEL + 2 * N_HEAD), dtype=torch.float32,
                          device=q.device)
    tickets = _ticket_buffer(q.device, B // GROUP_ROWS[mode])
    out = (torch.empty(B, 1, D_MODEL, dtype=torch.float32, device=q.device) if mode == "dma"
           else torch.empty(B, D_MODEL, dtype=torch.bfloat16, device=q.device))
    _kernels.library().call("qasr_step_formulations", q.device, MODES.index(mode),
                            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), tickets.data_ptr(), B, Ta, S)
    launches += 1
    return out


def work(mode: str, B: int, Ta: int, D: int = D_MODEL):
    """(operations, bytes, peak key) of the function at these shapes: K and
    V read once and q too (bf16), the output written once; the
    attention's q k^T and p v products (4 B Ta D, the tensor-core peak for
    the mxu modes, fp32 for vpu), or dma's 2 B Ta D additions."""
    nbytes = 2 * (2 * B * Ta * D + B * D) + (4 if mode == "dma" else 2) * B * D
    if mode == "dma":
        return 2 * B * Ta * D, nbytes, "f32"
    return 4 * B * Ta * D, nbytes, "f32" if mode == "vpu" else "bf16"


def bound_ms(flops: float, nbytes: float, key: str):
    """Least time (ms) the card could take, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[key] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def inputs(batch: int, mode: str, seed: int, device, ta: int = T_AUDIO,
           scale: float = 0.1):
    """The script's inputs: N(0, 1) x ``scale`` (the script's 0.1) in bf16,
    q (batch, D) and k, v in the mode's layout, made on the device.  At
    0.1 the logits spread by about 0.08 and the softmax is nearly uniform;
    at 0.5 they spread by about 2, so the online softmax's rescale and
    the merge of the splits show in the output."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, D_MODEL, ta) if lanes(mode) else (batch, ta, D_MODEL)
    q = (torch.randn(batch, D_MODEL, generator=g, device=device) * scale).to(torch.bfloat16)
    k, v = ((torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def peaked_inputs(batch: int, mode: str, seed: int, device, ta: int = T_AUDIO,
                  n_splits: int = 2, margin: float = 6.0):
    """``inputs`` at N(0, 0.5^2) with, per (row, head), one position of the
    last of ``n_splits`` splits (``split_chunks``) planted ``margin`` above
    the row's largest logit: its key slice is q's head slice times (max +
    margin) / |q_h|^2, rounded to bf16.  The first split's running max then
    lies units below the row's, so a merge or rescale that drops e^(m_s -
    M) moves the output by its own size."""
    q, k, v = inputs(batch, mode, seed, device, ta, scale=0.5)
    C = CHUNK[mode]
    first = split_chunks(mode, ta, n_splits)[-1][0] * C
    H, dh = N_HEAD, HEAD_WIDTH
    kh = (k.float().view(batch, H, dh, ta) if lanes(mode)
          else k.float().view(batch, ta, H, dh).permute(0, 2, 3, 1))  # (B, H, dh, Ta)
    qh = q.float().view(batch, H, dh)
    top = torch.einsum("bhd,bhdt->bht", qh, kh).amax(-1)  # (B, H)
    slot = first + (torch.arange(batch * H, device=device).view(batch, H) * 37) % (ta - first)
    key = (qh * ((top + margin) / (qh * qh).sum(-1))[..., None]).to(k.dtype)  # (B, H, dh)
    b = torch.arange(batch, device=device)[:, None, None]
    d = torch.arange(D_MODEL, device=device).view(1, H, dh)
    t = slot[..., None]
    k = k.clone()
    if lanes(mode):
        k[b, d, t] = key
    else:
        k[b, t, d] = key
    return q, k, v


def graph_times(fn, iters: int, runs: int):
    """Device ms per call of ``fn``: one eager call (a warm-up), ``iters``
    calls captured once in a CUDA graph, then ``runs`` replays, each timed
    by CUDA events (the host's launch overhead is not timed)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def measure(batch: int = BATCH, runs: int = 3, iters: int = 20, seed: int = 0,
            device="cuda"):
    """Each mode's kernel time on the card: {mode: {"ms", "runs_ms",
    "spread", "gbps", "bound_ms", "bound_by"}}.  Per mode: one warm-up
    launch, ``iters`` launches captured in a CUDA graph (the wrapper counts
    1 + ``iters`` launches), then ``runs`` replays, each timed by CUDA
    events; "ms" is the fastest replay's time per launch.  One set of
    inputs per layout: at B = 64 its 151 MB exceed the L2, so each call
    reads them from device memory."""
    res, layout = {}, None
    for mode in MODES:
        if lanes(mode) != layout:  # one layout's inputs held at a time
            layout = lanes(mode)
            q, k, v = inputs(batch, mode, seed, device)
        times = graph_times(lambda: step_formulations(q, k, v, mode), iters, runs)
        flops, nbytes, key = work(mode, batch, T_AUDIO)
        b_ms, b_by = bound_ms(flops, nbytes, key)
        kv_bytes = 2 * batch * T_AUDIO * D_MODEL * 2
        res[mode] = {"ms": min(times), "runs_ms": times,
                     "spread": (max(times) - min(times)) / min(times),
                     "gbps": kv_bytes / (min(times) * 1e-3) / 1e9,
                     "bound_ms": b_ms, "bound_by": b_by}
    return res


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=BATCH)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_formulations: needs an NVIDIA GPU (torch.cuda.is_available() "
                         "is False)")
    card = card_line()
    print(card)
    print(f"B={args.batch}, Ta={T_AUDIO}, D={D_MODEL}, {N_HEAD} heads of {HEAD_WIDTH}, bf16")
    ceiling = HBM_BYTES_PER_S / 1e9
    for mode, r in measure(args.batch).items():
        flag = (f"  [> the card's {ceiling:.0f} GB/s: measurement invalid]"
                if r["gbps"] > ceiling else "")
        print(f"{mode:6s} B={args.batch}: {r['ms'] * 1e3:9.1f} us  ({r['gbps']:7.1f} GB/s "
              f"effective){flag}; bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}) [{card}]")
        ok = "ok" if r["spread"] <= 0.10 else "NOISY (>10%)"
        print(f"{mode:6s} 3-run spread: {r['spread'] * 100:5.1f}%  [{ok}]")


if __name__ == "__main__":
    main()
