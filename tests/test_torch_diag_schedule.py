"""The diagnostics' schedules on the card, modelled in plain PyTorch on the
CPU: K11 ``full``'s two passes over the key tiles (``attn_full_model``) and
K12's splits of t, each with its online softmax over the kernel's chunks,
merged in the same launch (``step_split_model``; both in
``tests/torch_port_common.py``).

Each model is held, on peaked inputs (``peaked_inputs`` of each
diagnostic: a key several units above the rest of its row, in the last key
tile or the last split), to the port's plain version and to the TPU
script's Pallas kernel in interpret mode (K11 at B 1, Tp 256; K12 at B 8,
Ta 512, the script's CHUNK 256 and BT 8, the model in 4 splits).  Both
sides round p to bf16 at the same points but against other maxima (the
running one, the row's), so an output may move by one bf16 step of its
own value (rtol 2^-7) plus one step of p times the values it weighs
(atol: K12 2e-3 on values N(0, 0.5^2); K11 1/64 on values N(0, 1), whose
largest is ~4).  A model whose merge (K12) or first pass (K11) drops the
e^(m_old - m_new) rescale misses by more than 100 times atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu_torch.diagnostics import attn_parts
from qasr_ijcnlp_tpu_torch.diagnostics import step_formulations as sf
from tests.torch_port_common import (attn_full_model, attn_parts_script, load_script,
                                     step_formulations_script, step_split_model)

B12, TA, CHUNK, BT, SPLITS = 8, 512, 256, 8, 4
B11, TP = 1, 256
RTOL = 2.0 ** -7
ATOL = {"k12": 2e-3, "k11": 2.0 ** -6}
ATTENTION_MODES = ["vpu", "mxu_t", "mxu_r"]


@pytest.fixture(scope="module")
def k12_script():
    mod = load_script("bench_step_formulations", BT=BT)
    assert (mod.D, mod.H, mod.DH, mod.BT) == (sf.D_MODEL, sf.N_HEAD, sf.HEAD_WIDTH, BT)
    return mod


@pytest.fixture(scope="module")
def k11_script():
    mod = load_script("bench_attn_parts")
    mod.B, mod.Tp, mod.BQ = B11, TP, 128
    return mod


def _np(t):
    return t.float().numpy()


def _k12(mode):
    return sf.peaked_inputs(B12, mode, 31, "cpu", ta=TA, n_splits=SPLITS)


def test_peaked_inputs_plant_the_peak_in_the_last_split():
    """Per (row, head) the largest logit lies in the last split, at least
    5 above the first split's largest."""
    for mode in ("mxu_t", "mxu_r"):
        q, k, _ = _k12(mode)
        kh = (k.float().view(B12, 6, 64, TA) if sf.lanes(mode)
              else k.float().view(B12, TA, 6, 64).permute(0, 2, 3, 1))
        logits = torch.einsum("bhd,bhdt->bht", q.float().view(B12, 6, 64), kh)
        (c0, c1), (l0, _) = sf.split_chunks(mode, TA, SPLITS)[0], sf.split_chunks(
            mode, TA, SPLITS)[-1]
        C = sf.CHUNK[mode]
        assert (logits.argmax(-1) >= l0 * C).all()
        gap = logits.amax(-1) - logits[..., c0 * C:c1 * C].amax(-1)
        assert gap.min() > 5.0


def test_splits_follow_the_kernel_rule():
    """One block per SM for the groups, at most one per chunk: 2 splits a
    row at B = 64 on 132 SMs (mxu_r: 16 a group of 8 rows), and the splits'
    chunks tile the positions."""
    assert [sf.splits(m, 64, 1536, 132) for m in sf.MODES] == [2, 2, 2, 16]
    assert sf.splits("mxu_t", 8, 1536, 132) == 16
    assert sf.splits("mxu_r", 8, 1536, 132) == 132
    assert sf.splits("vpu", 512, 1536, 132) == 1
    for mode in sf.MODES:
        S = sf.splits(mode, 8, 1536, 132)
        spans = sf.split_chunks(mode, 1536, S)
        assert spans[0][0] == 0 and spans[-1][1] == 1536 // sf.CHUNK[mode]
        assert all(a[1] == b[0] and a[1] > a[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("mode", ATTENTION_MODES)
def test_step_split_model_matches_plain_and_script(k12_script, mode):
    q, k, v = _k12(mode)
    model = _np(step_split_model(q, k, v, mode, SPLITS))
    plain = _np(sf.step_formulations_plain(q, k, v, mode))
    np.testing.assert_allclose(model, plain, rtol=RTOL, atol=ATOL["k12"])
    # mxu_r's TPU body writes raw accumulator rows: the port's mxu_r is held
    # to the script's mxu_t (the attention) on the same values
    name = "mxu_t" if mode == "mxu_r" else mode
    kk, vv = (k, v) if sf.lanes(mode) else (k.transpose(1, 2), v.transpose(1, 2))
    ref = step_formulations_script(k12_script, name, _np(q), _np(kk), _np(vv), CHUNK)
    np.testing.assert_allclose(model, ref, rtol=RTOL, atol=ATOL["k12"])


@pytest.mark.parametrize("mode", ATTENTION_MODES)
def test_step_split_model_without_the_merge_rescale_misses(mode):
    q, k, v = _k12(mode)
    plain = sf.step_formulations_plain(q, k, v, mode).float()
    fault = step_split_model(q, k, v, mode, SPLITS, fault=True).float()
    assert float((fault - plain).abs().max()) > 100 * ATOL["k12"]


def test_attn_full_model_matches_plain_and_script(k11_script):
    q, k, v = attn_parts.peaked_inputs(B11, 13, "cpu", tp=TP)
    model = _np(attn_full_model(q, k, v))
    plain = _np(attn_parts.attn_parts_plain(q, k, v, "full"))
    np.testing.assert_allclose(model, plain, rtol=RTOL, atol=ATOL["k11"])
    ref = attn_parts_script(k11_script, *(jnp.asarray(_np(x), jnp.bfloat16) for x in (q, k, v)),
                            "full")
    np.testing.assert_allclose(model[:, :, 256:], ref, rtol=RTOL, atol=ATOL["k11"])


def test_attn_full_model_without_the_first_pass_rescale_misses():
    q, k, v = attn_parts.peaked_inputs(B11, 13, "cpu", tp=TP)
    plain = attn_parts.attn_parts_plain(q, k, v, "full").float()
    fault = attn_full_model(q, k, v, fault=True).float()
    assert float((fault - plain).abs().max()) > 100 * ATOL["k11"]
