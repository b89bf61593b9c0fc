"""Where K10's time goes, phase by phase, on the card.

    python3 -m qasr_ijcnlp_tpu_torch.diagnostics.decoder_step_stamps

Builds an instrumented copy of the fused decoder-layer kernel
(``csrc/decoder_step.cu``) in a temporary directory, with a
``%globaltimer`` stamp after a block barrier at kernel entry and before and
after every grid barrier of its phase loops, one row of stamps per block.
It then runs the copy at tiny's width (D 384, 6 heads, self positions
0..66 of 80, 1,500 audio positions) at B = 16 and 64 in f32 and bf16 and
prints, per configuration, the median over LAUNCHES launches of each
phase's time (from the earliest block's exit of the barrier before it to
the latest block's arrival at the barrier after it), each barrier's (from
the latest arrival to the latest exit) and the whole kernel's (from the
earliest entry stamp to the latest last stamp), with the kernel's error
against the plain version.  The stamps add a block barrier at each;
nothing is kept.  GPU only.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from .. import _kernels
from ..models.whisper import ResidualAttentionBlock
from ..ops import decoder_step

SLOTS = 24
BARRIERS = 7
LAUNCHES = 20  # stamped launches a configuration, after 3 warm-ups
STAMP = ("__device__ unsigned long long g_stamps[1024][%d];\n"
         "#define STAMP(i) do { __syncthreads(); if (threadIdx.x == 0) "
         "g_stamps[blockIdx.x][i] = global_ns(); } while (0)\n" % SLOTS)


def instrument(src: str) -> str:
    """The kernel source with the stamps: slot 0 at entry, slots 2 step + 1
    and 2 step + 2 before and after the grid barrier that ends phase step
    (slot 15 ends the last phase), in both roles' loops."""
    loop = "if (step < 7) grid.sync();"
    entry = "cg::grid_group grid = cg::this_grid();"
    header = '#include "hopper.cuh"\n'
    for anchor in (loop, entry, header):
        if anchor not in src:
            raise ValueError(f"decoder_step_stamps: {anchor!r} not in the kernel source")
    src = src.replace(loop, "STAMP(2 * step + 1); if (step < 7) { grid.sync(); "
                            "STAMP(2 * step + 2); }")
    src = src.replace(entry, entry + "\n  STAMP(0);", 1)
    src = src.replace(header, header + STAMP, 1)
    return src + ('\nextern "C" int qasr_read_stamps(void* dst) {\n'
                  '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n}\n')


def build(src: str, workdir: str):
    cu = os.path.join(workdir, "decoder_step_stamped.cu")
    so = os.path.join(workdir, "libdecoder_step_stamped.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-I", _kernels.CSRC,
                    "-o", so, cu], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.qasr_read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def phase_times(stamps: np.ndarray):
    """Per-phase and per-barrier us, and the whole kernel's, of one launch's
    (blocks, slots) stamps."""
    st = stamps.astype(np.int64)
    phases, bars = [], []
    start = st[:, 0].min()
    for p in range(BARRIERS + 1):
        end = st[:, 2 * p + 1].max()
        phases.append((end - start) / 1e3)
        if p < BARRIERS:
            exits = st[:, 2 * p + 2]
            bars.append((exits.max() - end) / 1e3)
            start = exits.min()
    return phases, bars, (st[:, 2 * BARRIERS + 1].max() - st[:, 0].min()) / 1e3


def run(lib, B: int, dt, dev):
    H, D, ctx, idx, Ta = 6, 384, 80, 66, 1500
    torch.manual_seed(B)
    blk = ResidualAttentionBlock(D, H, cross_attention=True).to(dev).requires_grad_(False)
    packed, ln = decoder_step.pack_layer(blk, dt)
    x = torch.randn(B, D, device=dev).to(dt)
    sk, sv = (torch.randn(B, H, ctx, 64, device=dev).to(dt) for _ in range(2))
    ck = (torch.randn(B, H, Ta, 64, device=dev) * 64 ** -0.25).to(dt)
    cv = torch.randn(B, H, Ta, 64, device=dev).to(dt)
    out = torch.empty_like(x)
    args = [_kernels.DTYPE_CODES[dt], x.data_ptr(), packed.data_ptr(), ln.data_ptr(),
            sk.data_ptr(), sv.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr()]
    cs, ss = decoder_step.attention_split(idx + 1, x.element_size())
    cx, sx = decoder_step.attention_split(Ta, x.element_size())
    work = torch.empty(decoder_step._work_floats(B, D, H, ss, sx), device=dev)
    ints = [B, D, H, ctx, Ta, idx, cs, ss, cx, sx, dev.index or 0]
    fn = lib.qasr_decoder_layer_step
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * len(ints) + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    ref = decoder_step.fused_decoder_layer_step_plain(x, packed, ln, sk.clone(), sv.clone(),
                                                      ck, cv, idx, H)
    buf = np.zeros((1024, SLOTS), np.uint64)
    phases, bars, totals = [], [], []
    for i in range(LAUNCHES + 3):
        if fn(*args, work.data_ptr(), *ints, stream):
            raise RuntimeError("qasr_decoder_layer_step failed")
        torch.cuda.synchronize()
        if i < 3:
            continue
        if lib.qasr_read_stamps(buf.ctypes.data):
            raise RuntimeError("reading the stamps failed")
        grid = int((buf[:, 0] > 0).sum())
        p, b, t = phase_times(buf[:grid])
        phases.append(p)
        bars.append(b)
        totals.append(t)
    err = float((out.float() - ref.float()).abs().max())
    return {"grid": grid, "max_abs_err": err,
            "phases_us": np.median(phases, 0).round(2).tolist(),
            "barriers_us": np.median(bars, 0).round(2).tolist(),
            "total_us": round(float(np.median(totals)), 2)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("decoder_step_stamps: needs an NVIDIA GPU")
    with open(os.path.join(_kernels.CSRC, "decoder_step.cu")) as f:
        stamped = instrument(f.read())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as workdir, torch.inference_mode():
        lib = build(stamped, workdir)
        for B in (16, 64):
            for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                r = run(lib, B, dt, dev)
                print(f"B={B} {key}", json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
