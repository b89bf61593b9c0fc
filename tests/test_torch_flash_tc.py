"""The numerics of K7/K8's tensor-core core (csrc/attention_tc.cuh) vs JAX.

The card kernel cannot run here, so this file emulates its arithmetic in
torch on the CPU, tile by tile at its real key tile (``KT``) and padded head
width (``W``), and holds the emulation against the JAX package's K7
(``flash_attention``) and K8 (``flash_attention_packed``) run in interpret
mode, at one head of the smoke's distribution (q, k, v ~ N(0, 1), q and k
scaled by dh^-0.25, padding keys from t_real to Tk):

* f32 as 3xTF32: each operand x split into hi = tf32(x), lo = tf32(x - hi)
  (round to nearest, ties away from zero, to 10 mantissa bits:
  cvt.rna.tf32.f32), each product summed as hi.lo' + lo.hi' + hi.hi' in
  fp32, for QK^T and for PV;
* bf16: fp32 logits of bf16 inputs, p rounded to bf16 for PV only, the
  denominator summing the unrounded fp32 p;
* the online softmax: per key tile a new running max, the old sum and
  output rescaled by exp(m_old - m_new).

Tolerances: f32 atol 1e-5 (the card holds the kernel to 1e-4 of its plain
version; the emulation comes within 2-4e-7), and single TF32 (hi.hi'
only) must miss 1e-4 (it is 1.3e-4 off on the K8 case), which is why the
kernel pays for three products.  bf16: one bf16 ulp of the output (2^-8 at |out| < 1): the two
sides differ only in fp32 summation order before the final rounding.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.ops import flash as jflash

TC = {  # (dtype, padded width W) -> key tile KT of attention_tc.cuh TcCfg
    ("f32", 64): 64, ("f32", 96): 32, ("f32", 128): 16,
    ("bf16", 64): 64, ("bf16", 96): 64, ("bf16", 128): 64,
}


def tf32(x):
    """Round fp32 to TF32 (10 mantissa bits), to nearest, ties away from 0."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split_dot(a, b, terms):
    """a @ b in fp32 as the kernel's tensor-core products: ``terms`` 3
    (hi.lo' + lo.hi' + hi.hi'), 1 (hi.hi', single TF32) or 0 (bf16-valued
    operands, exact products)."""
    if terms == 0:
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def emulate(q, k, v, t_real, dtype, W, KT, terms=3, rounded_sum=False):
    """The core's arithmetic on (B, H, T, dh) fp32 tensors holding values of
    ``dtype``: head width zero-padded to W, keys walked in tiles of KT with
    keys >= t_real zero-filled and masked; returns (B, H, Tq, dh) fp32.
    ``rounded_sum`` is K4's rule: the denominator sums the p rounded to
    ``dtype`` that PV multiplies (K7/K8 sum the unrounded fp32 p)."""
    dh = q.shape[-1]
    pad = lambda x: torch.nn.functional.pad(x, (0, W - dh))
    q, k, v = pad(q), pad(k[:, :, :t_real]), pad(v[:, :, :t_real])
    terms = terms if dtype == "f32" else 0
    B, H, Tq, _ = q.shape
    m = torch.full((B, H, Tq, 1), -torch.inf)
    l = torch.zeros(B, H, Tq, 1)
    o = torch.zeros(B, H, Tq, W)
    for k0 in range(0, t_real, KT):
        kt = torch.zeros(B, H, KT, W)
        vt = torch.zeros(B, H, KT, W)
        n = min(KT, t_real - k0)
        kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
        s = split_dot(q, kt.transpose(-1, -2), terms)
        s[..., n:] = -torch.inf
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        if dtype == "bf16":
            pr = p.to(torch.bfloat16).float()
            l = l * alpha + (pr if rounded_sum else p).sum(-1, keepdim=True)
            p = pr
        else:
            l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + split_dot(p, vt, terms)
        m = m_new
    return (o / l)[..., :dh]


def inputs(seed, B, H, Tq, Tk, dh, t_real, dtype):
    """Smoke-like operands, rounded to ``dtype``; the padding keys repeat
    one row, as the encoder trunk leaves them."""
    rng = np.random.default_rng(seed)
    sc = dh ** -0.25
    q = rng.standard_normal((B, H, Tq, dh)) * sc
    k = rng.standard_normal((B, H, Tk, dh)) * sc
    v = rng.standard_normal((B, H, Tk, dh))
    k[:, :, t_real:], v[:, :, t_real:] = k[:, :, -1:], v[:, :, -1:]
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return [np.asarray(jnp.asarray(x, jnp.float32).astype(jdt)) for x in (q, k, v)]


def jax_k7(q, k, v):
    return np.asarray(jflash.flash_attention(*map(jnp.asarray, (q, k, v))).astype(jnp.float32))


def jax_k8(q, k, v, t_real):
    B, H, T, dh = q.shape
    pk = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B, x.shape[2], H * dh)
    out = jflash.flash_attention_packed(pk(q), pk(k), pk(v), H, t_real)
    return np.asarray(out.astype(jnp.float32)).reshape(B, T, H, dh).transpose(0, 2, 1, 3)


def to_torch(arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def rounded(x, dtype):
    return x if dtype == "f32" else x.to(torch.bfloat16).float()


def tol(dtype):
    return 1e-5 if dtype == "f32" else 2.0 ** -8


@functools.lru_cache(maxsize=None)
def k8_case(dtype):
    """K8 at large-v3's head width (64), four heads, 256 queries over
    t_real 1500 of 1536 keys: operands and the JAX kernel's output."""
    q, k, v = inputs(0, 1, 4, 256, 1536, 64, 1500, dtype)
    return q, k, v, jax_k8(q, k, v, 1500)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k8_tile_arithmetic_matches_jax(dtype):
    """K8 at large-v3's head width (64), t_real 1500 of 1536 (23 full key
    tiles of 64 and a ragged 24th at bf16's and f32's KT)."""
    q, k, v, ref = k8_case(dtype)
    got = rounded(emulate(*to_torch((q, k, v)), 1500, dtype, 64, TC[(dtype, 64)]), dtype)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol(dtype), rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh,W", [(96, 96), (40, 64), (128, 128)])
def test_k7_tile_arithmetic_matches_jax(dtype, dh, W):
    """K7 at small-h96's head width, at 40 padded to 64 and at 128 (f32's
    key tile of 16 there); the JAX 4D kernel attends over every key."""
    q, k, v = inputs(dh, 1, 1, 192, 600, dh, 600, dtype)
    ref = jax_k7(q, k, v)
    got = rounded(emulate(*to_torch((q, k, v)), 600, dtype, W, TC[(dtype, W)]), dtype)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol(dtype), rtol=0)


def test_single_tf32_misses_the_f32_tolerance():
    """hi.hi' alone (one TF32 product) is over 1e-4 from the fp32 kernel on
    the K8 case, where 3xTF32 is within 1e-5: the split is needed."""
    q, k, v, ref = k8_case("f32")
    qt, kt, vt = to_torch((q, k, v))
    one = np.abs(emulate(qt, kt, vt, 1500, "f32", 64, 64, terms=1).numpy() - ref).max()
    three = np.abs(emulate(qt, kt, vt, 1500, "f32", 64, 64, terms=3).numpy() - ref).max()
    assert one > 1e-4 and three < 1e-5, (one, three)


def test_tf32_rounding_is_to_nearest_ties_away():
    """tf32() keeps 10 mantissa bits: 1 + 2^-11 (a tie) rounds up, away
    from 0, as cvt.rna does, 1 + 2^-12 down; lo = x - hi is exact."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11])
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2 * 2.0 ** -10])
    assert torch.equal(tf32(x), want)
    y = torch.randn(1000)
    hi = tf32(y)
    assert torch.equal(hi + (y - hi), y)
