"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

One small geometry that still takes the JAX kernel paths in interpret mode:
n_audio_ctx 500 (tile-padded to 512, mel of 1000 frames), width 128 with
two 64-wide heads, two encoder and two decoder layers, the real multilingual
vocabulary and a 48-token text context.  Weights are JAX ``init_params``
moved to the port through numpy (``from_jax_params``).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.dims import ModelDimensions
from qasr_ijcnlp_tpu_torch.models import convert
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_params
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock
from qasr_ijcnlp_tpu_torch.ops import decode_attn, decoder_step

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=500, n_audio_state=128, n_audio_head=2,
    n_audio_layer=2, n_vocab=51865, n_text_ctx=48, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)
T_PAD = 512

# The long-form tests' geometry: transcribe's windows are 3000 frames, so
# n_audio_ctx is 1500; otherwise as DIMS, with a 96-token text context
# (prompts up to 47 tokens).
LF_DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
    n_audio_layer=2, n_vocab=51865, n_text_ctx=96, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)


def lf_models(seed: int = 0):
    """(JAX WhisperModel, the port's CPU WhisperModel) at LF_DIMS, one
    weight set."""
    import jax.numpy as jnp

    from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel

    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), LF_DIMS))
    jm = JModel(jax.tree.map(jnp.asarray, params), LF_DIMS)
    tm = WhisperModel.from_state_dict(from_jax_params(params, LF_DIMS), LF_DIMS, "cpu")
    return jm, tm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The long-form test modules run torch on one thread: their models are
    narrow, and idle OpenMP threads spinning beside the JAX compiles of
    the other pytest workers slow the whole run many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speechlike_pcm(seconds: float, seed: int = 5) -> np.ndarray:
    """Seeded 16 kHz PCM: an amplitude-modulated tone under noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    tone = 0.1 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 0.7 * t)
    return (tone + rng.standard_normal(n) * 0.05).astype(np.float32)


def jax_params(seed: int = 0):
    """JAX parameter tree with numpy leaves."""
    params = jmodel.init_params(jax.random.PRNGKey(seed), DIMS)
    return jax.tree.map(np.asarray, params)


def torch_model(params_np) -> WhisperModel:
    return WhisperModel.from_state_dict(from_jax_params(params_np, DIMS), DIMS, "cpu")


def jax_layer(blocks, i: int):
    """Layer ``i`` of a stacked JAX block tree."""
    return jax.tree.map(lambda a: a[i], blocks)


def jax_encoder_block(seed: int, n_state: int):
    """One JAX encoder block (``_init_block``) with numpy leaves."""
    bp = jmodel._init_block(jax.random.PRNGKey(seed), n_state, cross_attention=False)
    return jax.tree.map(np.asarray, bp)


def port_block(bp_np, n_state: int, n_head: int) -> ResidualAttentionBlock:
    """The port's encoder block holding the values of JAX block ``bp_np``."""
    sd = {}
    convert._block(sd, "blk", bp_np)
    blk = ResidualAttentionBlock(n_state, n_head)
    blk.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    return blk.eval().requires_grad_(False)


def int8_attention_split(q, k8, sk, v8, sv, n_head: int, t_real: int, S: int):
    """The int8 cross attention as the CUDA kernel computes it, in plain
    PyTorch: [0, t_real) cut into S chunks by the kernel's rule
    (``decode_attn.chunk``), each chunk's local max m_s, sum l_s of p =
    exp(logit - m_s) and unnormalised PV sum acc_s = sum p scale_v code_v,
    merged as sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s (a chunk with
    no real position has m_s = -inf, l_s = 0, acc_s = 0 and weighs 0).
    Arguments as ``int8_cross_attention``."""
    BG, T_new, D = q.shape
    B, H, Tp, Dh = k8.shape
    G = BG // B
    cs = decode_attn.chunk(t_real, S)
    qh = (q.float() * float(Dh) ** -0.5).reshape(B, G, T_new, H, Dh)
    qh = qh.permute(0, 3, 1, 2, 4).reshape(B, H, G * T_new, Dh)
    ms, ls, accs = [], [], []
    for s in range(S):
        t0 = min(s * cs, t_real)
        t1 = min(t_real, t0 + cs)
        logits = (qh @ k8[:, :, t0:t1].float().transpose(-1, -2)) * sk[:, :, None, t0:t1]
        if t1 > t0:
            m = logits.amax(dim=-1, keepdim=True)
        else:
            m = torch.full((B, H, G * T_new, 1), float("-inf"))
        p = torch.exp(logits - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append((p * sv[:, :, None, t0:t1]) @ v8[:, :, t0:t1].float())
    M = torch.stack(ms).amax(dim=0)
    e = [torch.exp(m - M) for m in ms]
    num = sum(ej * acc for ej, acc in zip(e, accs))
    den = sum(ej * l for ej, l in zip(e, ls))
    out = (num / den).reshape(B, H, G, T_new, Dh).permute(0, 2, 3, 1, 4)
    return out.reshape(BG, T_new, D)


def attention_split(q, k, v, t_vis: int, C: int, S: int, dt):
    """One token's attention as K10's CUDA kernel computes it, in plain
    PyTorch: [0, t_vis) cut into S chunks of C (``decoder_step.
    attention_split``), each chunk's max m_s, sum l_s of the unrounded p =
    exp(logit - m_s) and PV sum acc_s over p rounded to ``dt``, merged in
    fp32 as sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s and rounded to
    ``dt`` (a chunk with no visible position has m_s = -inf, l_s = 0, acc_s =
    0 and weighs 0).  The kernel also merges a block's consecutive cross
    chunks as it goes, by the same formula, before the last merge.  q (B, H,
    64) fp32 holding ``dt`` values; k, v (B, H, >= t_vis, 64) -> (B, H, 64)
    fp32 holding ``dt`` values."""
    ms, ls, accs = [], [], []
    for s in range(S):
        t0 = min(s * C, t_vis)
        t1 = min(t_vis, t0 + C)
        logits = torch.einsum("bhd,bhtd->bht", q, k[:, :, t0:t1].float())
        if t1 > t0:
            m = logits.amax(-1, keepdim=True)
        else:
            m = torch.full((*q.shape[:2], 1), float("-inf"))
        p = torch.exp(logits - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bht,bhtd->bhd", p.to(dt).float(), v[:, :, t0:t1].float()))
    M = torch.stack(ms).amax(0)
    e = [torch.exp(m - M) for m in ms]
    num = sum(ej * acc for ej, acc in zip(e, accs))
    den = sum(ej * l for ej, l in zip(e, ls))
    return (num / den).to(dt).float()


def decoder_layer_split(x, packed, ln, self_k, self_v, cross_k, cross_v, idx: int,
                        n_head: int, self_plan=None, cross_plan=None):
    """``decoder_step.fused_decoder_layer_step_plain`` with both attentions
    split and merged as K10 does (``attention_split``), over the plans the wrapper
    passes the kernel (``attention_split`` of idx + 1 and of Ta, or the
    (C, S) given).  Writes the fresh k/v into the self cache at idx."""
    import torch.nn.functional as F

    B, D = x.shape
    dt, H, DH = x.dtype, n_head, decoder_step.DH
    elem = x.element_size()
    Ta = cross_k.shape[2]
    self_plan = self_plan or decoder_step.attention_split(idx + 1, elem)
    cross_plan = cross_plan or decoder_step.attention_split(Ta, elem)
    w = {k: v.float() for k, v in decoder_step._unpack(packed, ln, D).items()}
    r = lambda t: t.to(dt).float()
    heads = lambda t: t.reshape(B, H, DH)

    h = decoder_step._ln(x, w["g1"], w["b1"], dt)
    qkv = h @ w["wqkv"].t() + w["bqkv"]
    q = r(qkv[:, :D] * float(DH) ** -0.5)
    self_k[:, :, idx] = heads(qkv[:, D:2 * D]).to(self_k.dtype)
    self_v[:, :, idx] = heads(qkv[:, 2 * D:]).to(self_v.dtype)
    a = attention_split(heads(q), self_k, self_v, idx + 1, *self_plan, dt)
    xmid = r(x.float() + r(a.reshape(B, D) @ w["wo"].t() + w["bo"]))

    hc = decoder_step._ln(xmid, w["gc"], w["bc"], dt)
    qc = r((hc @ w["wcq"].t() + w["bcq"]) * float(DH) ** -0.25)
    ca = attention_split(heads(qc), cross_k, cross_v, Ta, *cross_plan, dt)
    x2 = r(xmid + r(ca.reshape(B, D) @ w["wco"].t() + w["bco"]))

    h2 = decoder_step._ln(x2, w["g2"], w["b2"], dt)
    t = r(F.gelu(h2 @ w["wf"].t() + w["bf"]))
    return (x2 + r(t @ w["wp"].t() + w["bp"])).to(dt)


def jax_decoder_block(seed: int, n_state: int):
    """A JAX decoder block (``_init_block`` with cross attention) with numpy
    leaves, its LayerNorms and biases drawn at random so that none is the
    identity or zero."""
    bp = jax.tree.map(np.asarray, jmodel._init_block(jax.random.PRNGKey(seed), n_state,
                                                       cross_attention=True))
    rng = np.random.default_rng(seed)
    for name in ("attn_ln", "cross_attn_ln", "mlp_ln"):
        bp[name] = {"g": rng.uniform(0.5, 1.5, n_state).astype(np.float32),
                    "b": rng.uniform(-0.2, 0.2, n_state).astype(np.float32)}
    for group, lin in (("attn", "query"), ("attn", "value"), ("attn", "out"),
                       ("cross_attn", "query"), ("cross_attn", "out"), ("mlp", "fc"),
                       ("mlp", "proj")):
        b = bp[group][lin]["b"]
        bp[group][lin]["b"] = rng.uniform(-0.1, 0.1, b.shape).astype(np.float32)
    return bp


def port_decoder_block(bp_np, n_state: int, n_head: int) -> ResidualAttentionBlock:
    """The port's decoder block holding the values of JAX block ``bp_np``."""
    sd = {}
    convert._block(sd, "blk", bp_np)
    blk = ResidualAttentionBlock(n_state, n_head, cross_attention=True)
    blk.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    return blk.eval().requires_grad_(False)


# -- the conv stem's and the mel frontend's tensor-core layouts (K1-K3) -------

def tc_gemm(a_op, w_op):
    """(S, M, K) A operand times (S, N, K) W operand, transposed, as the
    tensor-core GEMM computes it (``csrc/gemm_tc.cuh``): bfloat16 slabs
    (S = 1) as exact products summed in fp32; float32 hi/lo slabs (S = 2)
    as 3xTF32, hi.lo' + lo.hi' + hi.hi'."""
    if a_op.shape[0] == 1:
        return a_op[0].float() @ w_op[0].float().t()
    (ah, al), (wh, wl) = a_op, w_op
    return ah @ wl.t() + al @ wh.t() + ah @ wh.t()


def tap_views(op, taps: int, stride: int, rows: int, shift: int = 0):
    """The tap-view A operand as the GEMM's producer reads it: ``rows`` rows
    whose tap j is row stride m + j of ``op`` (S, R, C), rows past R zero
    (TMA's fill), taps side by side (tap-major columns).  ``shift`` moves
    the last tap down that many rows: a planted fault."""
    pad = torch.nn.functional.pad(op, (0, 0, 0, stride * rows + taps + shift))
    starts = [j + (shift if j == taps - 1 else 0) for j in range(taps)]
    return torch.cat([pad[:, s:s + stride * rows:stride] for s in starts], -1)


def _gelu_erf(x):
    return 0.5 * x * (1 + torch.erf(x * 0.70710678118654752))


def stem_tap_model(encoder, mel, t_pad: int, dtype, fault=None):
    """The stem as ``csrc/conv_stem.cu`` computes it, in plain PyTorch on
    the CPU: the packed weights (``conv_stem.stem_pack``) times the tap
    views of its two padded buffers, with the kernel's row pitch
    (``conv_stem.stem_pitch``) and rounding points.  conv1's input holds
    item b's mel frame tau at row 2 b P + 2 + tau (channels padded to the
    pack's c_pad); conv1's output row r is y1's frame r mod 2P - 1 (zero
    outside [0, Tm)), which is also conv2's input row r; conv2's output row
    b P + t reads rows 2 (b P + t) + j.  ``fault`` ("conv1" or "conv2")
    shifts that convolution's last tap by one row."""
    from qasr_ijcnlp_tpu_torch.ops import conv_stem
    from qasr_ijcnlp_tpu_torch.ops.encoder_block import gemm_operand

    rnd = lambda x: x.to(dtype).float()
    p = conv_stem.stem_pack(encoder, dtype)
    B, C0, Tm = mel.shape
    D, c_pad = p["w2"].shape[1], p["c_pad"]
    P, t_out = conv_stem.stem_pitch(Tm, t_pad), Tm // 2
    rows = 2 * B * P
    x = torch.zeros(B, 2 * P, c_pad)
    x[:, 2:2 + Tm, :C0] = rnd(mel.float()).transpose(1, 2)
    x = gemm_operand(x.reshape(rows, c_pad), dtype)
    acc = tc_gemm(tap_views(x, 3, 1, rows, int(fault == "conv1")), p["w1"])
    y = _gelu_erf(rnd(rnd(acc) + p["b1"].float()))
    tau = torch.arange(rows) % (2 * P) - 1
    y = gemm_operand(torch.where(((tau >= 0) & (tau < Tm))[:, None], y, 0.0), dtype)
    acc = tc_gemm(tap_views(y, 3, 2, B * P, int(fault == "conv2")), p["w2"])
    t = torch.arange(B * P) % P
    pos = p["pos"].float()[t.clamp(max=t_out - 1)]
    v = rnd(_gelu_erf(rnd(rnd(acc) + p["b2"].float()))) + pos
    v = rnd(torch.where((t < t_out)[:, None], v, 0.0))
    return v.reshape(B, P, D)[:, :t_pad].to(dtype)


def mel_tap_model(padded, n_mels: int, fault: bool = False):
    """log10 mel as ``csrc/melfront.cu`` computes it, in plain PyTorch on
    the CPU: each padded waveform cut into R hop rows of 160 samples
    (``melfront.frame_rows``), frame f the three rows f, f + 1, f + 2 as
    tap views, times the cached basis (window folded in, rows (cos, -sin)
    per bin, ``melfront.gemm_tables``), (re, im) pairs squared and summed,
    the mel GEMM, log10, transposed.  ``fault`` shifts the third tap by one
    row."""
    from qasr_ijcnlp_tpu_torch.ops import melfront
    from qasr_ijcnlp_tpu_torch.ops.encoder_block import gemm_operand

    basis, melfb = melfront.gemm_tables(n_mels, torch.device("cpu"))
    B, L = padded.shape
    F_keep, R = melfront.frame_rows(L)
    hop = melfront.HOP_LENGTH
    rows = torch.zeros(B, R * hop)
    n = min(L, R * hop)
    rows[:, :n] = padded[:, :n]
    rows = gemm_operand(rows.reshape(B * R, hop), torch.float32)
    spec = tc_gemm(tap_views(rows, 3, 1, B * R, int(fault)), basis)
    power = spec[:, 0::2] ** 2 + spec[:, 1::2] ** 2
    mel = tc_gemm(gemm_operand(power, torch.float32), melfb)[:, :n_mels]
    out = torch.log10(torch.clamp(mel, min=1e-10)).reshape(B, R, n_mels)
    return out[:, :F_keep].transpose(1, 2)


# -- the diagnostics' schedules (K11 full, K12) and the TPU scripts that define them --

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")


def load_script(name: str, **env):
    """``scripts/<name>.py`` imported by path as a fresh module, after
    setting ``env`` in the environment (the step-formulations script reads
    BT from it at import)."""
    os.environ.update({k: str(v) for k, v in env.items()})
    spec = importlib.util.spec_from_file_location(f"{name}_under_test",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def attn_parts_script(mod, q, k, v, mode: str):
    """``scripts/bench_attn_parts.py``'s ``run`` with ``interpret=True`` at
    the module's (shrunk) globals: bf16 jax q, k, v (B, Tp, D) -> (B, Tp,
    128) float32 numpy, the last head pair (columns 256-383 of the port's
    output)."""
    import functools

    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = lambda: pl.BlockSpec((1, mod.Tp, mod.W), lambda b, h: (b, 0, h),
                                memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(mod.kernel, mode=mode),
        out_shape=jax.ShapeDtypeStruct((mod.B, mod.Tp, mod.W), jnp.bfloat16),
        grid=(mod.B, mod.H // 2),
        in_specs=[spec(), spec(), spec()],
        out_specs=pl.BlockSpec((1, mod.Tp, mod.W), lambda b, h: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(q, k, v)
    return np.asarray(out.astype(jnp.float32))


def step_formulations_script(mod, name: str, q, k, v, chunk: int):
    """``scripts/bench_step_formulations.py``'s ``run`` for ``name`` with
    ``interpret=True``, one call at the module's BT and CHUNK = ``chunk``:
    float32 numpy q (B, D) and k, v in the kernel's layout, each holding
    bf16 values -> float32 numpy (dma: (B, 1, D); mxu_r: its raw
    accumulator rows)."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    D, H, BT = mod.D, mod.H, mod.BT
    B = q.shape[0]
    Ta = k.shape[2] if name in ("vpu", "mxu_t") else k.shape[1]
    vmem = dict(memory_space=pltpu.VMEM)
    q_spec = pl.BlockSpec((BT, D), lambda b, c: (b, 0), **vmem)
    if name in ("vpu", "mxu_t"):
        kv_spec = pl.BlockSpec((BT, D, chunk), lambda b, c: (b, 0, c), **vmem)
        kern = mod._vpu_kernel if name == "vpu" else mod._mxu_t_kernel
        scratch = [pltpu.VMEM((BT, D), jnp.float32), pltpu.VMEM((BT, H), jnp.float32),
                   pltpu.VMEM((BT, H), jnp.float32)]
        out_shape, dtype = (B, D), jnp.bfloat16
        out_spec = pl.BlockSpec((BT, D), lambda b, c: (b, 0), **vmem)
    else:
        kv_spec = pl.BlockSpec((BT, chunk, D), lambda b, c: (b, c, 0), **vmem)
        if name == "mxu_r":
            kern = mod._mxu_r_kernel
            scratch = [pltpu.VMEM((128, D), jnp.float32), pltpu.VMEM((1, 128), jnp.float32),
                       pltpu.VMEM((1, 128), jnp.float32)]
            out_shape, dtype = (B, D), jnp.bfloat16
            out_spec = pl.BlockSpec((BT, D), lambda b, c: (b, 0), **vmem)
        else:
            kern, scratch = mod._dma_kernel, []
            out_shape, dtype = (B, 1, D), jnp.float32
            out_spec = pl.BlockSpec((BT, 1, D), lambda b, c: (b, 0, 0), **vmem)
    f = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, dtype), grid=(B // BT, Ta // chunk),
        in_specs=[q_spec, kv_spec, kv_spec], out_specs=out_spec, scratch_shapes=scratch,
        interpret=True,
    )
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    return np.asarray(f(*args).astype(jnp.float32))


def step_split_model(q, k, v, mode: str, S: int, fault: bool = False):
    """K12's attention modes as ``csrc/step_formulations.cu`` schedules them,
    in plain PyTorch: the positions cut into ``S`` splits of whole chunks
    (``step_formulations.split_chunks``); per split an online softmax over
    chunks of ``CHUNK[mode]`` positions, p = exp(logit - the running max)
    rounded to bf16 for PV (mxu_t, mxu_r) and for the sum (mxu_t), the sum
    and accumulator rescaled by e^(m_old - m_new) as the max moves; then
    the splits merged as sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
    and rounded to bf16.  ``fault`` drops the merge's e^(m_s - M).  q (B,
    D), k, v in the mode's layout, bf16 -> (B, D) bf16."""
    from qasr_ijcnlp_tpu_torch.diagnostics import step_formulations as sf

    B, D = q.shape
    H, dh, C = sf.N_HEAD, sf.HEAD_WIDTH, sf.CHUNK[mode]
    if sf.lanes(mode):
        kh, vh = (x.float().reshape(B, H, dh, -1) for x in (k, v))
    else:
        kh, vh = (x.float().reshape(B, -1, H, dh).permute(0, 2, 3, 1) for x in (k, v))
    logits = torch.einsum("bhd,bhdt->bht", q.float().reshape(B, H, dh), kh)
    ms, ls, accs = [], [], []
    for c0, c1 in sf.split_chunks(mode, kh.shape[-1], S):
        m = torch.full((B, H), float("-inf"))
        l, acc = torch.zeros(B, H), torch.zeros(B, H, dh)
        for c in range(c0, c1):
            lg = logits[..., c * C:(c + 1) * C]
            m_new = torch.maximum(m, lg.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(lg - m_new[..., None])
            pr = p if mode == "vpu" else p.to(torch.bfloat16).float()
            l = l * corr + (pr if mode == "mxu_t" else p).sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bht,bhdt->bhd", pr,
                                                       vh[..., c * C:(c + 1) * C])
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    M = torch.stack(ms).amax(0)
    w = [torch.ones_like(m) if fault else torch.exp(m - M) for m in ms]
    num = sum(wi[..., None] * a for wi, a in zip(w, accs))
    den = sum(wi * li for wi, li in zip(w, ls))
    return (num / den[..., None]).reshape(B, D).to(torch.bfloat16)


def attn_full_model(q, k, v, kt: int = 64, fault: bool = False):
    """K11 ``full`` as the tensor-core core's kTcFull mode computes it, in
    plain PyTorch: pass 1 walks the keys in tiles of ``kt`` for each row's
    online max m and fp32 denominator l of the unrounded p (l rescaled by
    e^(m_old - m_new) as the max moves); pass 2 takes p = bf16(exp(s - m)
    (1 / l)) into PV.  ``fault`` drops pass 1's rescale.  bf16 q, k, v (B,
    Tp, D), heads of 64 -> bf16 (B, Tp, D)."""
    B, T, D = q.shape
    heads = lambda x: x.float().reshape(B, T, D // 64, 64).transpose(1, 2)
    s = heads(q) @ heads(k).transpose(-1, -2)
    m = torch.full(s.shape[:-1], float("-inf"))
    l = torch.zeros(s.shape[:-1])
    for j in range(0, T, kt):
        st = s[..., j:j + kt]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = 1.0 if fault else torch.exp(m - m_new)
        l = l * alpha + torch.exp(st - m_new[..., None]).sum(-1)
        m = m_new
    p = (torch.exp(s - m[..., None]) * (1.0 / l)[..., None]).to(torch.bfloat16).float()
    out = p @ heads(v)
    return out.transpose(1, 2).reshape(B, T, D).to(torch.bfloat16)
