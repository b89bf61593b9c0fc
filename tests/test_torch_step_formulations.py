"""Port of the decode cross-attention formulations (qasr_ijcnlp_tpu_torch/
diagnostics/step_formulations.py, K12) vs the TPU script's kernels.

``scripts/bench_step_formulations.py`` is imported by path (BT = 8 set
through the environment before the import, as the script reads it) and its
four Pallas bodies run in interpret mode on the CPU with the script's own
BlockSpecs and scratch, at B = 8, Ta = 512, CHUNK = 256 (two chunks, so the
online softmax carries across grid steps).  Inputs are N(0, 0.5^2) rounded
to bf16.  ``dma`` is held in fp32 to 1e-5 relative (sums in other orders);
``vpu`` and ``mxu_t`` to one bf16 step of the output (rtol 2^-7, atol 2e-3:
the plain versions take one max per row where the kernels carry an online
max over chunks, which moves each bf16-rounded p by at most its own step).
``mxu_r``'s TPU body writes its raw accumulator rows, not the attention:
that quirk is pinned against numpy, and the port's ``mxu_r`` (the
normalised attention) is held to the script's ``mxu_t`` output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu_torch.diagnostics import step_formulations as sf
from tests.torch_port_common import load_script, step_formulations_script

B, TA, CHUNK, BT = 8, 512, 256, 8


@pytest.fixture(scope="module")
def script():
    mod = load_script("bench_step_formulations", BT=BT)
    assert (mod.D, mod.H, mod.DH, mod.BT) == (sf.D_MODEL, sf.N_HEAD, sf.HEAD_WIDTH, BT)
    return mod


@pytest.fixture(scope="module")
def data():
    """bf16-valued float32 q (B, D), and k, v (B, Ta, D) row-major."""
    rng = np.random.default_rng(12)
    r = lambda *s: np.asarray(jnp.asarray(rng.standard_normal(s) * 0.5, jnp.bfloat16)
                              .astype(jnp.float32))
    return r(B, sf.D_MODEL), r(B, TA, sf.D_MODEL), r(B, TA, sf.D_MODEL)


def _script_kernel(mod, name, q, k, v):
    """The script's ``run`` for ``name``, one call with ``interpret=True``;
    k, v in the kernel's layout."""
    return step_formulations_script(mod, name, q, k, v, CHUNK)


def _port(q, k, v, mode):
    """The port on the CPU (its plain version), k, v in the mode's layout."""
    t = lambda a: torch.from_numpy(np.array(a)).to(torch.bfloat16)
    return sf.step_formulations(t(q), t(k), t(v), mode).float().numpy()


def _lanes(a):
    return a.transpose(0, 2, 1)


def test_dma_matches_script(script, data):
    q, k, v = data
    ref = _script_kernel(script, "dma", q, k, v)
    ours = _port(q, k, v, "dma")
    assert ours.shape == (B, 1, sf.D_MODEL)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["vpu", "mxu_t"])
def test_lanes_modes_match_script(script, data, mode):
    q, k, v = data
    ref = _script_kernel(script, mode, q, _lanes(k), _lanes(v))
    ours = _port(q, _lanes(k), _lanes(v), mode)
    assert ours.shape == (B, sf.D_MODEL)
    np.testing.assert_allclose(ours, ref, rtol=2.0 ** -7, atol=2e-3)


def _raw_accumulator(q, k, v):
    """The script's mxu_r output as its body computes it, in numpy: row r of
    each block of BT rows is the raw accumulator of column r, the pair
    (row r // 6 of the block, head r % 6): sum_t p_t v_t over all D columns
    of that row's v, p = exp(logit - running max) rounded to bf16 per chunk
    of CHUNK positions and rescaled as the max moves."""
    H, DH = sf.N_HEAD, sf.HEAD_WIDTH
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    out = np.zeros((B, sf.D_MODEL), np.float64)
    for blk in range(B // BT):
        for r in range(BT):
            i, h = blk * BT + r // H, r % H
            lg = k[i, :, h * DH:(h + 1) * DH] @ q[i, h * DH:(h + 1) * DH]
            m, acc = -np.inf, np.zeros(sf.D_MODEL)
            for c0 in range(0, TA, CHUNK):
                m_new = max(m, lg[c0:c0 + CHUNK].max())
                p = bf(np.exp(lg[c0:c0 + CHUNK] - m_new))
                acc = acc * np.exp(m - m_new) + p @ v[i, c0:c0 + CHUNK]
                m = m_new
            out[blk * BT + r] = acc
    return out


def test_mxu_r_quirk_and_port(script, data):
    """The script's mxu_r rows are raw accumulators (values far from the
    attention's); the port's mxu_r is the attention the script's mxu_t
    computes."""
    q, k, v = data
    ref = _script_kernel(script, "mxu_r", q, k, v)
    raw = _raw_accumulator(q, k, v)
    np.testing.assert_allclose(ref, raw, rtol=2.0 ** -7, atol=2.0 ** -7 * np.abs(raw).max())
    attention = _script_kernel(script, "mxu_t", q, _lanes(k), _lanes(v))
    assert np.abs(ref - attention).max() > 0.5  # the quirk is not the attention
    ours = _port(q, k, v, "mxu_r")
    np.testing.assert_allclose(ours, attention, rtol=2.0 ** -7, atol=2e-3)


def test_cpu_path_does_not_count_launches(data):
    q, k, v = data
    before = sf.launches
    for mode in sf.MODES:
        kk, vv = (_lanes(k), _lanes(v)) if sf.lanes(mode) else (k, v)
        _port(q, kk, vv, mode)
    assert sf.launches == before


def test_work_and_bound():
    """Every mode moves 2 B Ta D bf16 bytes of K and V (151 MB at the
    script's B = 64, 45 us at 3.35 TB/s) and is bound by them."""
    kv = 2 * 64 * 1536 * 384 * 2
    assert kv == 150994944
    for mode in sf.MODES:
        flops, nbytes, key = sf.work(mode, 64, 1536)
        assert kv < nbytes < kv * 1.001
        assert flops == (2 if mode == "dma" else 4) * 64 * 1536 * 384
        ms, by = sf.bound_ms(flops, nbytes, key)
        assert by == "bytes" and ms == pytest.approx(0.0451, abs=2e-4)
    with pytest.raises(ValueError):
        sf.step_formulations(torch.zeros(8, 384), torch.zeros(8, 64, 384),
                             torch.zeros(8, 64, 384), "mma")
