"""The numerics of the tensor-core fused encoder block (csrc/gemm_tc.cuh,
csrc/encoder_block.cu, K4 on csrc/attention_tc.cuh) vs JAX, and its packs.

The card kernels cannot run here, so this file emulates their arithmetic in
torch on the CPU and holds it against the JAX package's kernels in Pallas
interpret mode:

* the GEMM: f32 as 3xTF32 (each operand split hi = tf32(x), lo = tf32(x -
  hi), products hi.lo' + lo.hi' + hi.hi' summed in fp32), bf16 as exact
  products of bf16 operands summed in fp32;
* the four epilogues' rounding points: every product, bias add, scale and
  residual rounded to the compute dtype, LN and GELU (exact erf) in fp32;
* K4's attention: the core's tiles (``test_torch_flash_tc.emulate``) with
  K4's denominator, the sum of the p rounded to the compute dtype.

References: K5 (``_finish_kernel``, D <= 512) and K6
(``_finish_kernel_ftiled``, D > 512) as ``_fused_block_impl`` builds their
pallas_call, and K4 (``_attn_kernel``) through ``fused_attention_ln``.
Tolerances: f32 atol 2e-5 (tests/test_encoder_block.py's bound), 3e-5 at
D = 1024, whose proj sums K = 4096 products (the JAX suite's bound for its
widest F-tiled case); bf16 two ulps of bf16 at the largest output of the
finish and one for K4's attention output: both sides round at the same
points, so they differ only where an fp32 sum in another order lands on
the other side of a rounding midpoint, and such a flip in r or t moves
the output by about an ulp.

The packs (``attention_pack``, ``finish_pack``) are built once per module
and dtype, and the f32 pack's hi + lo is the weight to within 2^-22 of its
magnitude.
"""

import copy
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qasr_ijcnlp_tpu.ops import encoder_block as jeb
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.ops import encoder_block, head_scale
from tests.test_torch_flash_tc import TC, emulate, split_dot, tf32
from tests.torch_port_common import jax_encoder_block, port_block

TP, T_REAL = 512, 500


def rnd(x, dtype):
    """x rounded to the compute dtype, as fp32 values."""
    return x if dtype == "f32" else x.to(torch.bfloat16).float()


def gemm(a, w, dtype, terms=3):
    """a @ w^T as the kernel's tensor cores compute it (fp32 result)."""
    return split_dot(a, w.t(), terms if dtype == "f32" else 0)


def ln(x, mod, dtype):
    """fp32 LayerNorm, rounded to the compute dtype."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return rnd((x - mean) * torch.rsqrt(var + 1e-5) * mod.weight + mod.bias, dtype)


def weight(lin, dtype):
    return rnd(lin.weight.float(), dtype), rnd(lin.bias.float(), dtype)


def emulate_finish(x, attn, blk, dtype, terms=3):
    """K5/K6's arithmetic on (M, D) fp32 tensors holding compute-dtype
    values: OutProjEp, LN, FcEp, ProjEp around three GEMMs."""
    (wo, bo), (wf, bf), (wp, bp) = (weight(m, dtype) for m in
                                    (blk.attn.out, blk.mlp[0], blk.mlp[2]))
    r = rnd(x + rnd(rnd(gemm(attn, wo, dtype, terms), dtype) + bo, dtype), dtype)
    y = rnd(rnd(gemm(ln(r, blk.mlp_ln, dtype), wf, dtype, terms), dtype) + bf, dtype)
    t = rnd(0.5 * y * (1 + torch.erf(y * 0.70710678118654752)), dtype)
    return rnd(r + rnd(rnd(gemm(t, wp, dtype, terms), dtype) + bp, dtype), dtype)


def emulate_attn_ln(x, blk, n_head, t_real, dtype, terms=3):
    """K4's arithmetic on a (B, Tp, D) fp32 tensor holding compute-dtype
    values: LN, the QKV GEMM with QkvEp's rounding points, then the
    tensor-core core at its tiles with the rounded-p denominator."""
    B, Tp, D = x.shape
    dh = D // n_head
    sc = head_scale(dh, torch.float32 if dtype == "f32" else torch.bfloat16)
    a = blk.attn
    w = rnd(torch.cat([a.query.weight, a.key.weight, a.value.weight]).float(), dtype)
    bq, bv = rnd(a.query.bias.float(), dtype), rnd(a.value.bias.float(), dtype)
    y = rnd(gemm(ln(x, blk.attn_ln, dtype).reshape(-1, D), w, dtype, terms), dtype)
    q = rnd(rnd(y[:, :D] + bq, dtype) * sc, dtype)
    k = rnd(y[:, D:2 * D] * sc, dtype)
    v = rnd(y[:, 2 * D:] + bv, dtype)
    heads = lambda z: z.reshape(B, Tp, n_head, dh).transpose(1, 2)
    out = emulate(heads(q), heads(k), heads(v), t_real, dtype, dh, TC[(dtype, dh)], terms,
                  rounded_sum=True)
    return rnd(out, dtype).transpose(1, 2).reshape(B, Tp, D)


def jax_finish(x, attn, bp):
    """The JAX finish kernel alone in interpret mode, as
    ``_fused_block_impl`` builds its pallas_call: K5 at D <= 512, K6
    (streamed MLP weights, fp32 proj accumulator) above."""
    B, Tp, D = x.shape
    dt = x.dtype
    a, m = bp["attn"], bp["mlp"]
    F = m["fc"]["w"].shape[1]
    w = lambda p: jnp.asarray(p).astype(dt)
    f32 = lambda p: jnp.asarray(p).reshape(1, D).astype(jnp.float32)
    args = (x, attn, w(a["out"]["w"]), w(a["out"]["b"]).reshape(1, D),
            f32(bp["mlp_ln"]["g"]), f32(bp["mlp_ln"]["b"]),
            w(m["fc"]["w"]), w(m["fc"]["b"]).reshape(1, F),
            w(m["proj"]["w"]), w(m["proj"]["b"]).reshape(1, D))
    vm = pltpu.VMEM
    if D <= 512:
        const = lambda s: pl.BlockSpec(s, lambda b, t: (0,) * len(s), memory_space=vm)
        row = lambda: pl.BlockSpec((1, jeb.MT, D), lambda b, t: (b, t, 0), memory_space=vm)
        return pl.pallas_call(
            jeb._finish_kernel, out_shape=jax.ShapeDtypeStruct((B, Tp, D), dt),
            grid=(B, Tp // jeb.MT),
            in_specs=[row(), row(), const((D, D)), const((1, D)), const((1, D)),
                      const((1, D)), const((D, F)), const((1, F)), const((F, D)),
                      const((1, D))],
            out_specs=row(), interpret=True)(*args)
    MT2, FT = jeb._finish_tiles(D)
    const = lambda s: pl.BlockSpec(s, lambda b, t, f: (0,) * len(s), memory_space=vm)
    row = lambda: pl.BlockSpec((1, MT2, D), lambda b, t, f: (b, t, 0), memory_space=vm)
    return pl.pallas_call(
        jeb._finish_kernel_ftiled, out_shape=jax.ShapeDtypeStruct((B, Tp, D), dt),
        grid=(B, Tp // MT2, F // FT),
        in_specs=[row(), row(), const((D, D)), const((1, D)), const((1, D)), const((1, D)),
                  pl.BlockSpec((D, FT), lambda b, t, f: (0, f), memory_space=vm),
                  pl.BlockSpec((1, FT), lambda b, t, f: (0, f), memory_space=vm),
                  pl.BlockSpec((FT, D), lambda b, t, f: (f, 0), memory_space=vm),
                  const((1, D))],
        out_specs=row(),
        scratch_shapes=[pltpu.VMEM((MT2, D), dt), pltpu.VMEM((MT2, D), dt),
                        pltpu.VMEM((MT2, D), jnp.float32)],
        interpret=True)(*args)


@functools.lru_cache(maxsize=None)
def block(D, n_head):
    """A JAX encoder block (numpy leaves) and the port's block with its
    values."""
    bp = jax_encoder_block(D, D)
    return bp, port_block(bp, D, n_head)


def rows(seed, D, t_real=T_REAL, B=1):
    """N(0, 1) rows, the padding rows one repeated row (as the trunk leaves
    them), as float32 numpy."""
    x = np.random.default_rng(seed).standard_normal((B, TP, D)).astype(np.float32)
    x[:, t_real:] = x[:, -1:]
    return x


def as_dtype(x, dtype):
    """numpy rows -> (jax array in the compute dtype, torch fp32 of its values)."""
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == "f32" else jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32)))


def ulp(ref):
    """One bf16 ulp at the largest |value| of ``ref``."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def tol(dtype, ref, D):
    if dtype == "f32":
        return 3e-5 if D > 768 else 2e-5
    return 2 * ulp(ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [384, 1024], ids=["K5-D384", "K6-D1024"])
def test_finish_gemm_arithmetic_matches_jax(dtype, D):
    """The finish's three GEMMs and four rounding points (out-proj, LN, fc
    with exact GELU, proj) against JAX K5 at tiny's width and K6 at
    medium's, where proj sums K = 4096 products."""
    bp, blk = block(D, D // 64)
    jx, tx = as_dtype(rows(D, D), dtype)
    ja, ta = as_dtype(rows(D + 1, D), dtype)
    ref = np.asarray(jax_finish(jx, ja, bp).astype(jnp.float32))
    got = emulate_finish(tx.reshape(-1, D), ta.reshape(-1, D), blk, dtype).reshape(ref.shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol(dtype, ref, D), rtol=0)


def test_single_tf32_misses_the_f32_tolerance_at_k4096():
    """At K6's width the proj product sums K = 4096 terms: hi.hi' alone
    (one TF32 product) is over 1e-4 from JAX's fp32 finish, where 3xTF32
    is within 3e-5: the GEMM pays for three products."""
    bp, blk = block(1024, 16)
    jx, tx = as_dtype(rows(1024, 1024), "f32")
    ja, ta = as_dtype(rows(1025, 1024), "f32")
    ref = np.asarray(jax_finish(jx, ja, bp))
    err = lambda terms: np.abs(emulate_finish(tx.reshape(-1, 1024), ta.reshape(-1, 1024), blk,
                                              "f32", terms).numpy().reshape(ref.shape) - ref).max()
    one, three = err(1), err(3)
    assert one > 1e-4 and three < 3e-5, (one, three)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,n_head", [(128, 2), (256, 2)], ids=["dh64", "dh128"])
@pytest.mark.parametrize("t_real", [T_REAL, TP], ids=["t_real<Tp", "t_real==Tp"])
def test_k4_tile_arithmetic_matches_jax(dtype, D, n_head, t_real):
    """K4 (LN, the QKV GEMM with QkvEp's rounding points, the tensor-core
    core at its key tile with the rounded-p denominator) against the JAX
    ``_attn_kernel`` at heads of 64 (a pair) and of 128, with and without
    masked padding keys; bf16 within one ulp at the largest output."""
    bp, blk = block(D, n_head)
    jx, tx = as_dtype(rows(D + 2, D, t_real), dtype)
    a = bp["attn"]
    ref = np.asarray(jeb.fused_attention_ln(
        jx, {k: jnp.asarray(v) for k, v in bp["attn_ln"].items()},
        jax.tree.map(jnp.asarray, {k: a[k] for k in ("query", "key", "value")}),
        n_head, t_real).astype(jnp.float32))
    got = emulate_attn_ln(tx, blk, n_head, t_real, dtype)
    atol = 2e-5 if dtype == "f32" else ulp(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0)


def _small_block():
    torch.manual_seed(0)
    return tmodel.ResidualAttentionBlock(128, 2).requires_grad_(False)


def test_packs_built_once_per_module_and_dtype():
    """A second call returns the same pack; another dtype gets its own; the
    bf16 pack holds the weights cast once, one slab each."""
    blk = _small_block()
    p32 = encoder_block.attention_pack(blk.attn_ln, blk.attn, torch.float32)
    f32 = encoder_block.finish_pack(blk, torch.float32)
    assert encoder_block.attention_pack(blk.attn_ln, blk.attn, torch.float32) is p32
    assert encoder_block.finish_pack(blk, torch.float32) is f32
    p16 = encoder_block.attention_pack(blk.attn_ln, blk.attn, torch.bfloat16)
    assert p16 is not p32 and p16["wqkv"].shape == (1, 384, 128)
    assert p16["wqkv"].dtype == torch.bfloat16 and p32["wqkv"].shape == (2, 384, 128)
    w = torch.cat([blk.attn.query.weight, blk.attn.key.weight, blk.attn.value.weight])
    assert torch.equal(p16["wqkv"][0], w.to(torch.bfloat16))
    assert torch.equal(p16["bqkv"][128:256], torch.zeros(128, dtype=torch.bfloat16))
    assert encoder_block.finish_pack(blk, torch.bfloat16)["wf"].shape == (1, 512, 128)


def test_packs_rebuilt_for_a_copy_and_a_recast():
    """A deep copy packs its own weights; a module whose weights are
    replaced (``p.data = ...``, as ``decoder_for`` casts) packs anew."""
    blk = _small_block()
    pack = encoder_block.finish_pack(blk, torch.float32)
    twin = copy.deepcopy(blk)
    with torch.no_grad():
        twin.attn.out.weight.mul_(2)
    other = encoder_block.finish_pack(twin, torch.float32)
    assert other is not pack
    torch.testing.assert_close(other["wo"].sum(0), 2 * blk.attn.out.weight, rtol=0, atol=1e-6)
    blk.attn.out.weight.data = blk.attn.out.weight.data * 3
    again = encoder_block.finish_pack(blk, torch.float32)
    assert again is not pack
    torch.testing.assert_close(again["wo"].sum(0), blk.attn.out.weight, rtol=0, atol=1e-6)


def test_f32_pack_slabs_are_the_tf32_split():
    """hi = tf32(w), lo = tf32(w - hi), both TF32 values, and hi + lo is w
    to within 2^-22 |w| (lo keeps 11 of the residual's 13 bits)."""
    blk = _small_block()
    w = blk.mlp[0].weight
    hi, lo = encoder_block.finish_pack(blk, torch.float32)["wf"]
    assert torch.equal(hi, tf32(w)) and torch.equal(lo, tf32(w - hi))
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi + lo - w).abs() / w.abs()).max()) <= 2.0 ** -22
    assert torch.equal(encoder_block.tf32(w), tf32(w))


def test_init_kv_cache_defaults_to_the_card():
    """Like every other entry point, the cache is allocated on the card
    unless the caller asks for the CPU."""
    sig = inspect.signature(tmodel.init_kv_cache)
    assert sig.parameters["device"].default == "cuda"
