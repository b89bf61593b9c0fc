"""The yardstick's arithmetic against counts made by hand at small shapes."""

import pytest

from portbench import roofline as rf

TINY = dict(n_mels=80, n_audio_ctx=4, n_audio_state=8, n_audio_head=2, n_audio_layer=1,
            n_vocab=10, n_text_ctx=6, n_text_state=8, n_text_head=2, n_text_layer=1)


def test_mel_and_stem_work_by_hand():
    # 2 clips, 3 frames: a 400 x 402 DFT and a 201 x 80 projection per frame
    flops, nbytes = rf.mel_work(2, 880, 3, 80)
    assert flops == 2 * 2 * 3 * 400 * 402 + 2 * 2 * 3 * 201 * 80
    assert nbytes == 4 * (2 * 880 + 2 * 80 * 3)
    flops, nbytes = rf.stem_work(1, 80, 8, 16, 4, 128, 2)
    assert flops == 2 * 8 * 16 * 3 * 80 + 2 * 4 * 16 * 3 * 16
    assert nbytes == 4 * 80 * 8 + 2 * (16 * 80 * 3 + 16 * 16 * 3 + 32 + 4 * 16 + 128 * 16)


def test_model_flops_by_hand():
    # stem: conv1 (8 frames x 8 x 3 x 80) and conv2 (4 x 8 x 3 x 8); block:
    # 12 D^2 per row and 2 T^2 D for the two attention products
    stem = 2 * 8 * 8 * 3 * 80 + 2 * 4 * 8 * 3 * 8
    block = 2 * 4 * 12 * 64 + 4 * 16 * 8
    assert rf.encoder_flops(TINY) == stem + block
    assert rf.cross_kv_flops(TINY) == 2 * 4 * 2 * 64
    # position 2 sees 3 self keys and 4 audio keys; logits 2 D V
    layer = 2 * 14 * 64 + 4 * 3 * 8 + 4 * 4 * 8
    assert rf.decoder_token_flops(TINY, 2) == layer + 2 * 8 * 10
    per = [rf.decoder_token_flops(TINY, p) for p in range(5)]
    assert rf.decode_flops(TINY, 3, 3) == rf.encoder_flops(TINY) + rf.cross_kv_flops(TINY) + sum(per)
    assert rf.train_flops(TINY, 2) == 3 * (rf.encoder_flops(TINY) + rf.cross_kv_flops(TINY)
                                           + per[0] + per[1])


def test_bound_takes_the_larger_side():
    assert rf.bound_s(989e12, 0, "bf16") == pytest.approx(1.0)
    assert rf.bound_s(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert rf.bound_s(989e12, 6.7e12, "bf16") == pytest.approx(2.0)


@pytest.mark.parametrize("name, kid", [
    ("void qasr::gemm_tc_kernel<float, (anonymous namespace)::PowerEp, true>(...)", "K1"),
    ("(anonymous namespace)::audio_rows_kernel(float const*, float*, int, int, unsigned long)",
     "K1"),
    ("void (anonymous namespace)::mel_rows_kernel<__nv_bfloat16>(float const*, ...)", "K3"),
    ("void qasr::attn_tc_kernel<__nv_bfloat16, 64, false, 0>(...)", "K8"),
    ("void at::native::vectorized_layer_norm_kernel<float, float>(...)", ""),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", ""),
])
def test_kernel_names(name, kid):
    assert rf.kernel_of(name, ("K1", "K3", "K8")) == kid


def test_trace_share_counts_calls_by_anchor():
    kernels = {
        "void qasr::gemm_tc_kernel<bf16, (anonymous namespace)::QkvEp<bf16>, false>()": (4, 1e-3),
        "void qasr::attn_tc_kernel<bf16, 64, true, 0>()": (4, 2e-3),
        "void (anonymous namespace)::layer_norm_kernel<bf16>()": (8, 1e-3),
        "void qasr::gemm_tc_kernel<bf16, (anonymous namespace)::OutProjEp<bf16>, false>()":
            (4, 1e-3),
        "void qasr::gemm_tc_kernel<bf16, (anonymous namespace)::FcEp<bf16>, false>()": (4, 2e-3),
        "void qasr::gemm_tc_kernel<bf16, (anonymous namespace)::ProjEp<bf16>, false>()": (4, 2e-3),
        "void at::native::vectorized_layer_norm_kernel<float>()": (9, 5.0),
    }
    dims = dict(TINY, n_audio_ctx=1500, n_audio_state=1024, n_audio_head=16)
    entries = rf.trace_entries(kernels, dims, 2, 2)
    assert set(entries) == {"K4+K6"}
    bound, secs, calls = entries["K4+K6"]
    assert calls == 4 and secs == pytest.approx(9e-3)
    assert bound == pytest.approx(4 * rf.kernel_call_bound_s("K4+K6", dims, 2, 2))
    share = rf.trace_share({"trace": {"kernels": kernels}, "batch": 2}, dims)
    assert share == pytest.approx(100 * bound / secs)
    assert rf.trace_share({"trace": {"kernels": kernels}, "batch": 2}, dims, ("K8",)) is None
    assert rf.trace_share({"trace": None, "batch": 2}, dims) is None
