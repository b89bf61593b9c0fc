"""Port of the attention core's diagnostic split (qasr_ijcnlp_tpu_torch/
diagnostics/attn_parts.py, K11) vs the TPU script's kernel.

``scripts/bench_attn_parts.py`` is imported by path and its Pallas ``kernel``
run in interpret mode on the CPU, with the script's own BlockSpecs, at a
small size set through its module globals (B 1, Tp 256, BQ 128; D 384 and
six 64-wide heads as in the script).  Its output block holds only the last
head pair (heads 4-5), which the port writes at columns 256-383 of its
(B, Tp, D) output.  Both sides round to bf16 at the same points (the
softmax mode's product, bf16 in the script's source, stays fp32 in its
kernel as XLA compiles it, and in the port); the sums differ only in fp32
order, so every output may differ by one bf16 rounding step of its own
value (rtol 2^-7, with atol 1e-6 for values near 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu_torch.diagnostics import attn_parts
from tests.torch_port_common import attn_parts_script, load_script

B, TP, BQ = 1, 256, 128


@pytest.fixture(scope="module")
def script():
    mod = load_script("bench_attn_parts")
    mod.B, mod.Tp, mod.BQ = B, TP, BQ
    return mod


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(11)
    return [jnp.asarray(rng.standard_normal((B, TP, attn_parts.D_MODEL)), jnp.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("mode", attn_parts.MODES)
def test_plain_modes_match_script_kernel(script, qkv, mode):
    assert (script.D, script.H, script.dh) == (attn_parts.D_MODEL, attn_parts.N_HEAD,
                                               attn_parts.HEAD_WIDTH)
    ref = attn_parts_script(script, *qkv, mode)
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in qkv]
    ours = attn_parts.attn_parts(*t, mode)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (B, TP, attn_parts.D_MODEL)
    np.testing.assert_allclose(ours[:, :, 256:].float().numpy(), ref, rtol=2.0 ** -7,
                               atol=1e-6)


def test_cpu_path_does_not_count_launches(qkv):
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in qkv]
    before = attn_parts.launches
    attn_parts.attn_parts(*t, "full")
    assert attn_parts.launches == before


def test_work_counts_the_functions_operations():
    """Products at the bf16 peak, bytes, and one exponential per (query,
    key) pair for softmax and full: at B = 8 softmax's 113 M exponentials
    at 16 per SM per clock (132 SMs, 1,980 MHz) take 27.1 us, four times
    its fp32 operations' 6.8 us."""
    pairs = 512 * 6 * 1536 ** 2
    flops, nbytes, key, exps = attn_parts.work("full", 512, 1536, 384)
    assert (flops, key, exps) == (4 * pairs * 64, "bf16", pairs)
    assert nbytes == 2 * 4 * 512 * 1536 * 384
    assert attn_parts.work("softmax", 512, 1536, 384)[2:] == ("f32", pairs)
    assert attn_parts.work("dots", 512, 1536, 384)[3] == 0
    ms, by = attn_parts.bound_ms(*attn_parts.work("softmax", 8, 1536, 384))
    assert by == "operations" and ms == pytest.approx(0.02708, abs=1e-5)
    ms_ops, _ = attn_parts.bound_ms(*attn_parts.work("softmax", 8, 1536, 384)[:3])
    assert ms_ops == pytest.approx(0.00676, abs=1e-5)
    with pytest.raises(ValueError):
        attn_parts.attn_parts(*[torch.zeros(1, 64, 64)] * 3, "exp")
