"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without one the ``cuda_dev``
fixture skips it (the check happens in the fixture, never at import, so
every pytest-xdist worker collects the same tests).  The card has no JAX, so
run this file without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are chip_smoke.py's: f32 atol 1e-4 (two fp32 summation orders;
the int8 attention's output is fp32 whatever q's dtype, so it is held to
1e-4 in both);
bf16 twice the plain bf16 version's own distance from the plain version in
f32 on the same bf16-valued inputs; mel atol 2e-4 (tests/test_ops.py).  The
rounding probes (chip_smoke.py ``k4_probe``, ``k8_probe``) must come out
exact.  The gradient tests hold each kernel's autograd Function (the
kernel forward, the plain version's VJP backward) against autograd through
the plain version: GRAD_TOL of each input's largest gradient.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from chip_smoke import NOISE_FACTOR, k4_probe, k8_probe

from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions, tiny_dims
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.models import whisper as tmodel
from qasr_ijcnlp_tpu_torch.models.whisper import init_params
from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock
from qasr_ijcnlp_tpu_torch.diagnostics import attn_parts
from qasr_ijcnlp_tpu_torch.diagnostics import step_formulations as sf
from qasr_ijcnlp_tpu_torch.ops import (
    conv_stem, decode_attn, decoder_step, encoder_block, flash, head_scale, melfront,
)

pytestmark = pytest.mark.cuda

SMALL = ModelDimensions(80, 500, 128, 2, 2, 51865, 48, 128, 2, 2)
# Medium's width (K3's stem and K6's finish) at one layer; 128 mels for the
# large-v3 stem shape.
WIDE = ModelDimensions(128, 1500, 1024, 16, 1, 51866, 48, 1024, 16, 1)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=["small", "tiny"])
def model(request, cuda_dev):
    dims = SMALL if request.param == "small" else tiny_dims()
    sd = init_params(torch.Generator().manual_seed(1), dims)
    return WhisperModel.from_state_dict(sd, dims, cuda_dev)


@pytest.fixture(scope="module")
def wide(cuda_dev):
    sd = init_params(torch.Generator().manual_seed(2), WIDE)
    return WhisperModel.from_state_dict(sd, WIDE, cuda_dev)


def _close(k, p, plain32):
    """Kernel output ``k`` against its plain version's ``p``; in bf16 within
    NOISE_FACTOR times the distance of ``p`` from ``plain32()``, the plain
    version in f32 on the same bf16-valued inputs."""
    assert k.shape == p.shape and k.dtype == p.dtype
    assert torch.isfinite(k).all()
    err = float((k.float() - p.float()).abs().max())
    if k.dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        noise = float((p.float() - plain32().float()).abs().max())
        assert err <= NOISE_FACTOR * noise, (err, noise)


def _x(model, seed, dtype, batch=2):
    """Random trunk rows; the padding rows past n_audio_ctx are one repeated
    row, as the trunk leaves them."""
    T = model.dims.n_audio_ctx
    Tp = (T + 127) // 128 * 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, Tp, model.dims.n_audio_state, generator=g, device="cuda")
    x[:, T:] = x[:, T:T + 1]
    return x.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_stem_kernel(model, dtype):
    enc, T = model.module.encoder, model.dims.n_audio_ctx
    Tp = (T + 127) // 128 * 128
    mel = torch.randn(2, 80, 2 * T, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    before = conv_stem.launches
    k = conv_stem.fused_conv_stem(enc, mel, Tp, dtype)
    assert conv_stem.launches == before + 1
    _close(k, conv_stem._plain_stem(enc, mel, Tp, dtype),
           lambda: conv_stem._plain_stem(enc, mel, Tp, torch.float32))
    assert float(k[:, T:].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad", [True, False], ids=["t_real<Tp", "t_real==Tp"])
def test_attention_kernel(model, dtype, pad):
    x = _x(model, 1, dtype)
    blk, H = model.module.encoder.blocks[0], model.dims.n_audio_head
    t_real = model.dims.n_audio_ctx if pad else x.shape[1]
    before = encoder_block.attn_launches
    k = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, t_real)
    assert encoder_block.attn_launches == before + 1
    plain = lambda x: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, t_real)
    _close(k, plain(x), lambda: plain(x.float()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_finish_kernel(model, dtype):
    x, a = _x(model, 2, dtype), _x(model, 3, dtype)
    blk = model.module.encoder.blocks[1]
    before = encoder_block.finish_launches
    k = encoder_block.fused_block_finish(x, a, blk)
    assert encoder_block.finish_launches == before + 1
    _close(k, encoder_block._plain_finish(x, a, blk),
           lambda: encoder_block._plain_finish(x.float(), a.float(), blk))


@pytest.mark.parametrize("seconds", [1.1, 30.0])
def test_mel_kernel(cuda_dev, seconds):
    pcm = torch.from_numpy((np.random.default_rng(4).standard_normal(
        (2, int(16000 * seconds))) * 0.1).astype(np.float32)).to(cuda_dev)
    padded = melfront.reflect_pad(pcm)
    before = melfront.launches
    k = melfront.clamp_and_scale(melfront.log10_mel(padded))
    assert melfront.launches == before + 1
    p = melfront.clamp_and_scale(melfront._plain_log10_mel(padded, 80))
    assert k.shape == p.shape
    assert float((k - p).abs().max()) <= 2e-4


# (D, mel bins, B, mel frames, t_pad): every Whisper width and the tier-1
# one; the last two with t_pad == t_out (no spare row after an item's last
# frame).
STEM_CASES = [(128, 80, 1, 1000, 512), (384, 80, 3, 3000, 1536), (768, 80, 1, 3000, 1536),
              (1024, 128, 1, 3000, 1536), (1280, 128, 3, 3000, 1536),
              (128, 128, 3, 1024, 512), (384, 80, 1, 1000, 500)]


def _stem_encoder(cuda_dev, D, n_mels):
    torch.manual_seed(D + n_mels)
    return tmodel.AudioEncoder(n_mels, 1500, D, max(1, D // 64), 0).to(
        cuda_dev).requires_grad_(False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,C0,B,Tm,t_pad", STEM_CASES, ids=str)
def test_conv_stem_kernel_at_every_width(cuda_dev, dtype, D, C0, B, Tm, t_pad):
    """The tensor-core stem against its plain version: D from 128 to 1280,
    80 and 128 mels, B 1 and 3, 1000 and 3000 frames; rows >= t_out
    exactly 0."""
    enc = _stem_encoder(cuda_dev, D, C0)
    mel = torch.randn(B, C0, Tm, generator=torch.Generator(device="cuda").manual_seed(Tm),
                      device="cuda")
    before = conv_stem.launches
    k = conv_stem.fused_conv_stem(enc, mel, t_pad, dtype)
    assert conv_stem.launches == before + 1
    _close(k, conv_stem._plain_stem(enc, mel, t_pad, dtype),
           lambda: conv_stem._plain_stem(enc, mel, t_pad, torch.float32))
    assert not k[:, Tm // 2:].any()


def test_conv_stem_raises_off_its_gate(cuda_dev):
    """D not a multiple of 128, mel bins other than 80 and 128, an odd mel
    length: ValueError before a launch, no fallback."""
    for D, C0, Tm in ((96, 80, 1000), (128, 64, 1000), (128, 80, 999)):
        enc = _stem_encoder(cuda_dev, D, C0)
        with pytest.raises(ValueError):
            conv_stem.fused_conv_stem(enc, torch.zeros(1, C0, Tm, device="cuda"), 512)


@pytest.mark.parametrize("B,n_samples,n_mels", [(2, 17600, 80), (2, 480000, 80),
                                                (1, 16001, 80), (1, 480000, 128),
                                                (3, 17600, 128)])
def test_mel_kernel_lengths_and_bins(cuda_dev, B, n_samples, n_mels):
    """K1 on the tensor cores: 1.1 s, 30 s, an odd sample count, B = 1, 128
    bins; within the mel bound after the clamp and scaling."""
    pcm = torch.from_numpy((np.random.default_rng(n_samples).standard_normal(
        (B, n_samples)) * 0.1).astype(np.float32)).to(cuda_dev)
    padded = melfront.reflect_pad(pcm)
    before = melfront.launches
    k = melfront.clamp_and_scale(melfront.log10_mel(padded, n_mels))
    assert melfront.launches == before + 1
    p = melfront.clamp_and_scale(melfront._plain_log10_mel(padded, n_mels))
    assert k.shape == p.shape == (B, n_mels, n_samples // 160)
    assert torch.isfinite(k).all()
    assert float((k - p).abs().max()) <= 2e-4
    with pytest.raises(ValueError):
        melfront.log10_mel(padded, 64)


@pytest.mark.parametrize("n_samples", [600 * 16000, 75 * 16000 + 37],
                         ids=["10min", "odd_length"])
def test_mel_kernel_file_lengths(cuda_dev, n_samples):
    """K1 at a whole file's length, with transcribe's 30 s of zero padding
    (10 min: ~63k frames in one launch), within the mel bound."""
    pcm = torch.from_numpy((np.random.default_rng(n_samples).standard_normal(
        (1, n_samples)) * 0.1).astype(np.float32)).to(cuda_dev)
    padded = melfront.reflect_pad(pcm, 480000)
    before = melfront.launches
    k = melfront.clamp_and_scale(melfront.log10_mel(padded))
    assert melfront.launches == before + 1
    p = melfront.clamp_and_scale(melfront._plain_log10_mel(padded, 80))
    assert k.shape == p.shape == (1, 80, (n_samples + 480000) // 160)
    assert torch.isfinite(k).all()
    assert float((k - p).abs().max()) <= 2e-4


@pytest.mark.parametrize("batch_windows", [False, 4], ids=["sequential", "batched"])
def test_longform_transcript_on_card_matches_cpu(cuda_dev, batch_windows):
    """tiny at full width: the f32 long-form transcript (65 s, three windows,
    word timestamps) through the kernels equals the CPU plain path's;
    word times by the rule of tests/test_align.py."""
    from qasr_ijcnlp_tpu_torch.transcribe import transcribe

    dims = tiny_dims()
    sd = init_params(torch.Generator().manual_seed(3), dims)
    card = WhisperModel.from_state_dict(sd, dims, cuda_dev)
    cpu = WhisperModel.from_state_dict(sd, dims, "cpu")
    rng = np.random.default_rng(7)
    t = np.arange(65 * 16000) / 16000
    pcm = (0.1 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 0.7 * t)
           + rng.standard_normal(t.size) * 0.05).astype(np.float32)
    kw = dict(language="en", temperature=0.0, compression_ratio_threshold=None,
              logprob_threshold=None, no_speech_threshold=None, fp16=False,
              sample_len=32, word_timestamps=True, batch_windows=batch_windows)
    ours, ref = transcribe(card, pcm, **kw), transcribe(cpu, pcm, **kw)
    assert ours["text"] == ref["text"]
    assert len(ours["segments"]) == len(ref["segments"]) >= 3
    ours_t, ref_t = [], []
    for a, b in zip(ours["segments"], ref["segments"]):
        assert (a["seek"], a["tokens"], a["text"]) == (b["seek"], b["tokens"], b["text"])
        assert [w["word"] for w in a["words"]] == [w["word"] for w in b["words"]]
        ours_t += [[w["start"], w["end"]] for w in a["words"]]
        ref_t += [[w["start"], w["end"]] for w in b["words"]]
    if ours_t:
        diff = np.abs(np.array(ours_t) - np.array(ref_t))
        assert np.median(diff) <= 0.02 and np.mean(diff <= 0.04) >= 0.7, diff


def test_wrappers_raise_on_unsupported_input(model):
    x = _x(model, 5, torch.float32)
    blk, H = model.module.encoder.blocks[0], model.dims.n_audio_head
    with pytest.raises(ValueError):
        encoder_block.fused_attention_ln(x.half(), blk.attn_ln, blk.attn, H, 10)
    with pytest.raises(ValueError):
        strided = x.transpose(1, 2).contiguous().transpose(1, 2)
        encoder_block.fused_attention_ln(strided, blk.attn_ln, blk.attn, H, 10)
    with pytest.raises(ValueError):
        encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, 0)
    with pytest.raises(ValueError):
        melfront.log10_mel(torch.zeros(2, 100, device="cuda"))


def test_decode_on_card_matches_cpu(model):
    """f32 greedy decode through the kernels equals the CPU plain path."""
    import qasr_ijcnlp_tpu_torch as port

    sd = {k: v.cpu() for k, v in model.module.state_dict().items()}
    cpu = WhisperModel.from_state_dict(sd, model.dims, "cpu")
    T = model.dims.n_audio_ctx
    pcm = (np.random.default_rng(6).standard_normal((2, 2 * T * 160)) * 0.1).astype(
        np.float32)
    opts = port.DecodingOptions(language="en", sample_len=8, fp16=False)
    ours = port.decode(model, port.log_mel_spectrogram(pcm, device="cuda"), opts)
    ref = port.decode(cpu, port.log_mel_spectrogram(pcm, device="cpu"), opts)
    assert [r.tokens for r in ours] == [r.tokens for r in ref]


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_stem_kernel_d1024(wide, dtype):
    """K3's width (D = 1024) with 128 mel bins, rows >= 1500 exactly 0."""
    enc = wide.module.encoder
    mel = torch.randn(2, 128, 3000, generator=torch.Generator(device="cuda").manual_seed(5),
                      device="cuda")
    before = conv_stem.launches
    k = conv_stem.fused_conv_stem(enc, mel, 1536, dtype)
    assert conv_stem.launches == before + 1
    _close(k, conv_stem._plain_stem(enc, mel, 1536, dtype),
           lambda: conv_stem._plain_stem(enc, mel, 1536, torch.float32))
    assert float(k[:, 1500:].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_and_finish_kernels_d1024(wide, dtype):
    """K4 with 16 heads and the finish at K6's width (D = 1024)."""
    x, a = _x(wide, 6, dtype), _x(wide, 7, dtype)
    blk = wide.module.encoder.blocks[0]
    before = (encoder_block.attn_launches, encoder_block.finish_launches)
    k_attn = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, 16, 1500)
    k_fin = encoder_block.fused_block_finish(x, a, blk)
    assert (encoder_block.attn_launches, encoder_block.finish_launches) == \
        (before[0] + 1, before[1] + 1)
    plain = lambda x: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, 16, 1500)
    _close(k_attn, plain(x), lambda: plain(x.float()))
    _close(k_fin, encoder_block._plain_finish(x, a, blk),
           lambda: encoder_block._plain_finish(x.float(), a.float(), blk))


# The fused-block gate's widths (D, heads): heads of 64 in pairs at every
# width the GEMM takes (D a multiple of 128: the probe test's 128 and the
# family's 384, 512, 768, 1024), and heads of 128.
BLOCK_WIDTHS = [(128, 2), (384, 6), (512, 8), (768, 12), (1024, 16), (768, 6), (1024, 8)]
# (N, K) of each GEMM epilogue at width D
GEMM_SHAPES = {"qkv": (3, 1), "out_proj": (1, 1), "fc": (4, 1), "proj": (1, 4)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [128, 384, 512, 768, 1024])
@pytest.mark.parametrize("epilogue", encoder_block.EPILOGUES)
def test_block_gemm_kernel(cuda_dev, dtype, D, epilogue):
    """The tensor-core GEMM with each of the block's four epilogues against
    its plain version at that product's (M, N, K) for width D (M = 1000
    rows, so the last row tile is ragged): weights N(0, 1/K), activations
    and residual N(0, 1), biases N(0, 0.1^2); f32 by 3xTF32 within 1e-4."""
    nN, nK = GEMM_SHAPES[epilogue]
    M, N, K = 1000, nN * D, nK * D
    g = torch.Generator(device="cuda").manual_seed(D + len(epilogue))
    randn = lambda *shape, sd=1.0: (torch.randn(*shape, generator=g, device="cuda")
                                    * sd).to(dtype)
    a, w, bias, res = randn(M, K), randn(N, K, sd=K ** -0.5), randn(N, sd=0.1), randn(M, N)
    if epilogue in ("qkv", "fc"):
        res = None
    scale = head_scale(64, dtype)
    before = encoder_block.gemm_launches
    out = encoder_block.block_gemm(encoder_block.gemm_operand(a, dtype),
                                   encoder_block.gemm_operand(w, dtype), bias, epilogue,
                                   res, scale)
    assert encoder_block.gemm_launches == before + 1
    if epilogue == "fc" and dtype == torch.float32:
        out = out[0] + out[1]  # t's hi/lo slabs
    f32 = lambda t: None if t is None else t.float()
    _close(out, encoder_block.block_gemm_plain(a, w, bias, epilogue, res, scale),
           lambda: encoder_block.block_gemm_plain(a.float(), w.float(), bias.float(),
                                                  epilogue, f32(res), scale))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,H", BLOCK_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("pad", [True, False], ids=["t_real<Tp", "t_real==Tp"])
def test_fused_block_kernels_at_gate_widths(cuda_dev, dtype, D, H, pad):
    """K4 and the finish (K5 at D <= 512, K6 above) at every width the
    fused-block gate admits, Tp 512, padding rows one repeated row."""
    torch.manual_seed(D + H)
    blk = ResidualAttentionBlock(D, H).to(cuda_dev).requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(D * H)
    x, a = (torch.randn(2, 512, D, generator=g, device="cuda") for _ in range(2))
    t_real = 500 if pad else 512
    x[:, t_real:] = x[:, -1:]
    x, a = x.to(dtype), a.to(dtype)
    before = (encoder_block.attn_launches, encoder_block.finish_launches)
    k_attn = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, t_real)
    k_fin = encoder_block.fused_block_finish(x, a, blk)
    assert (encoder_block.attn_launches, encoder_block.finish_launches) == \
        (before[0] + 1, before[1] + 1)
    plain = lambda x: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, t_real)
    _close(k_attn, plain(x), lambda: plain(x.float()))
    _close(k_fin, encoder_block._plain_finish(x, a, blk),
           lambda: encoder_block._plain_finish(x.float(), a.float(), blk))


def test_block_wrappers_raise_off_the_gate(cuda_dev):
    """K4 takes heads of 64 and 128 over D a multiple of 128, the finish D
    and an MLP width in multiples of 128: anything else raises before a
    launch."""
    x = torch.zeros(1, 512, 384, device="cuda")
    blk = ResidualAttentionBlock(384, 4).to(cuda_dev).requires_grad_(False)  # heads of 96
    with pytest.raises(ValueError):
        encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, 4, 500)
    blk = ResidualAttentionBlock(192, 3).to(cuda_dev).requires_grad_(False)  # D % 128
    x = torch.zeros(1, 512, 192, device="cuda")
    with pytest.raises(ValueError):
        encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, 3, 500)
    with pytest.raises(ValueError):
        encoder_block.fused_block_finish(x, x, blk)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq,tk,t_real", [(1536, 1536, 1500), (1536, 1536, 1536),
                                          (300, 700, 650), (700, 300, 300)],
                         ids=["t_real<Tk", "t_real==Tk", "Tq<Tk", "Tq>Tk"])
def test_packed_attention_kernel(cuda_dev, dtype, tq, tk, t_real):
    """K8 against its plain version, 20 heads of 64 (large-v3's width)."""
    g = torch.Generator(device="cuda").manual_seed(tq + tk)
    q, k, v = (torch.randn(2, t, 1280, generator=g, device="cuda") for t in (tq, tk, tk))
    k[:, t_real:], v[:, t_real:] = k[:, -1:], v[:, -1:]  # padding: one repeated row
    q, k, v = (q * 0.3).to(dtype), (k * 0.3).to(dtype), v.to(dtype)
    before = flash.launches
    out = flash.flash_attention_packed(q, k, v, 20, t_real)
    assert flash.launches == before + 1
    plain = lambda *qkv: flash._plain_attention_packed(*qkv, 20, t_real)
    _close(out, plain(q, k, v), lambda: plain(q.float(), k.float(), v.float()))


def test_packed_attention_ignores_padding_values(cuda_dev):
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(1, 512, 128, generator=g, device="cuda") for _ in range(3))
    a = flash.flash_attention_packed(q, k, v, 2, 500)
    k[:, 500:], v[:, 500:] = float("inf"), float("nan")
    b = flash.flash_attention_packed(q, k, v, 2, 500)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,H", [(128, 2), (256, 2)], ids=["dh64", "dh128"])
def test_attention_kernel_ignores_padding_values(cuda_dev, dtype, D, H):
    """K4 with non-finite padding rows in x: their q, k and v rows are NaN,
    and the key mask's zero-fill keeps them out of every real row."""
    torch.manual_seed(D)
    blk = ResidualAttentionBlock(D, H).to(cuda_dev).requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1, 512, D, generator=g, device="cuda").to(dtype)
    a = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, 500)
    x[:, 500:] = float("nan")
    b = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, H, 500)
    assert torch.equal(a[:, :500], b[:, :500])


def test_unpackable_long_attention_raises_on_card(cuda_dev):
    """A head wider than any kernel takes (one of 320) raises on the card;
    three 64-wide heads with 512 queries run K7."""
    x = torch.randn(1, 512, 320, device="cuda")
    with pytest.raises(ValueError, match="head width"):
        tmodel.attention(x, x, x, 1)
    x = x[..., :192].contiguous()
    before = flash.launches_4d
    out = tmodel.attention(x, x, x, 3)
    assert flash.launches_4d == before + 1 and out.shape == x.shape


def _heads_of_rows(B, T, H, dh, g, dtype, scale=1.0):
    """(B, H, T, dh) head views of a (B, T, H dh) tensor, as the unfused
    trunk hands them to K7 (unit column stride, not contiguous)."""
    x = torch.randn(B, T, H * dh, generator=g, device="cuda") * scale
    return x.to(dtype).view(B, T, H, dh).transpose(1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,dh", [(5, 64), (8, 96), (6, 128), (2, 256), (3, 40)],
                         ids=["odd-64", "dh96", "dh128", "dh256", "dh40"])
@pytest.mark.parametrize("layout", ["rows", "contiguous"])
def test_flash_attention_4d_kernel(cuda_dev, dtype, H, dh, layout):
    """K7 against its plain version at the head widths it serves, on the
    trunk's strided head views and on contiguous (B, H, T, dh) tensors;
    keys >= t_real hold garbage it must never read."""
    g = torch.Generator(device="cuda").manual_seed(H * dh)
    q, k, v = (_heads_of_rows(2, 640, H, dh, g, dtype, s) for s in (0.3, 0.3, 1.0))
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    t_real = 520
    ref_inputs = [t.clone() for t in (q, k, v)]
    k[:, :, t_real:], v[:, :, t_real:] = float("inf"), float("nan")
    before = flash.launches_4d
    out = flash.flash_attention(q, k, v, t_real)
    assert flash.launches_4d == before + 1
    plain = lambda *qkv: flash._plain_attention(*qkv, t_real)
    _close(out, plain(*ref_inputs), lambda: plain(*(t.float() for t in ref_inputs)))
    # the output merges its heads with no copy
    assert tmodel._merge_heads(out).is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,H,dh,tq,tk,t_real", [
    ("packed", 20, 64, 1000, 1536, 1001),
    ("packed", 4, 128, 77, 700, 5),
    ("4d", 2, 64, 130, 300, 63),
    ("4d", 3, 36, 200, 300, 250),
    ("4d", 2, 256, 65, 200, 17),
], ids=["tq-ragged", "t_real-in-first-tile", "t_real<key-tile", "dh36-plain-loads",
        "dh256-short"])
def test_attention_tc_edges(cuda_dev, dtype, kind, H, dh, tq, tk, t_real):
    """K7/K8 at the tensor-core core's edges: Tq not a multiple of the query
    tile, t_real not a multiple of the key tile or inside the first one, and
    inf/NaN in every key and value row >= t_real.  Three heads of 36 in bf16
    (a 216-byte row stride) are operands TMA cannot address, which the same
    kernel reads with plain loads; in f32 (432 bytes) they go through TMA."""
    g = torch.Generator(device="cuda").manual_seed(tq * 7 + dh)
    q = torch.randn(2, tq, H * dh, generator=g, device="cuda") * 0.3
    k = torch.randn(2, tk, H * dh, generator=g, device="cuda") * 0.3
    v = torch.randn(2, tk, H * dh, generator=g, device="cuda")
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    clean = [t.clone() for t in (q, k, v)]
    k[:, t_real:], v[:, t_real:] = float("inf"), float("nan")
    if kind == "packed":
        before = flash.launches
        out = flash.flash_attention_packed(q, k, v, H, t_real)
        assert flash.launches == before + 1
        plain = lambda *qkv: flash._plain_attention_packed(*qkv, H, t_real)
    else:
        heads = lambda x: x.view(2, x.shape[1], H, dh).transpose(1, 2)
        before = flash.launches_4d
        out = flash.flash_attention(heads(q), heads(k), heads(v), t_real)
        assert flash.launches_4d == before + 1
        plain = lambda *qkv: flash._plain_attention(*map(heads, qkv), t_real)
    _close(out, plain(*clean), lambda: plain(*(t.float() for t in clean)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_kernel_dh128(cuda_dev, dtype):
    """K4 at head width 128 (D 768, six heads), which the JAX gate admits."""
    torch.manual_seed(3)
    blk = ResidualAttentionBlock(768, 6).to(cuda_dev).requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 1536, 768, generator=g, device="cuda")
    x[:, 1500:] = x[:, 1500:1501]
    x = x.to(dtype)
    before = encoder_block.attn_launches
    k = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, 6, 1500)
    assert encoder_block.attn_launches == before + 1
    plain = lambda x: encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, 6, 1500)
    _close(k, plain(x), lambda: plain(x.float()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,H", [(1280, 10), (384, 12), (256, 16)],
                         ids=["dh128", "dh32", "dh16"])
def test_packed_attention_kernel_head_widths(cuda_dev, dtype, D, H):
    """K8 at head widths other than 64 that ``packed_applicable`` admits."""
    assert flash.packed_applicable(H, D)
    g = torch.Generator(device="cuda").manual_seed(D + H)
    q, k, v = (torch.randn(2, 1536, D, generator=g, device="cuda") for _ in range(3))
    k[:, 1500:], v[:, 1500:] = k[:, -1:], v[:, -1:]
    sc = head_scale(D // H, dtype)
    q, k, v = q.to(dtype) * sc, k.to(dtype) * sc, v.to(dtype)
    before = flash.launches
    out = flash.flash_attention_packed(q, k, v, H, 1500)
    assert flash.launches == before + 1
    plain = lambda *qkv: flash._plain_attention_packed(*qkv, H, 1500)
    _close(out, plain(q, k, v), lambda: plain(q.float(), k.float(), v.float()))


@pytest.mark.parametrize("mode", attn_parts.MODES)
def test_attn_parts_kernel(cuda_dev, mode):
    """K11's modes against their plain versions at B = 8 (bf16 only, as the
    TPU script)."""
    q, k, v = attn_parts.inputs(8, 0, cuda_dev)
    before = attn_parts.launches
    out = attn_parts.attn_parts(q, k, v, mode)
    assert attn_parts.launches == before + 1
    _close(out, attn_parts.attn_parts_plain(q, k, v, mode),
           lambda: attn_parts.attn_parts_plain(q.float(), k.float(), v.float(), mode))


@pytest.mark.parametrize("tp", [64, 1536])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mode", attn_parts.MODES)
def test_attn_parts_kernel_shapes(cuda_dev, mode, B, tp):
    """K11's modes off the script's batch: B 1 and 3, one key tile (64
    positions, half a query block) and the script's 1536."""
    q, k, v = attn_parts.inputs(B, B + tp, cuda_dev, tp=tp)
    out = attn_parts.attn_parts(q, k, v, mode)
    _close(out, attn_parts.attn_parts_plain(q, k, v, mode),
           lambda: attn_parts.attn_parts_plain(q.float(), k.float(), v.float(), mode))


@pytest.mark.parametrize("mode", ["full", "softmax"])
def test_attn_parts_kernel_peaked(cuda_dev, mode):
    """K11 on logits peaked in the last key tile (``attn_parts.
    peaked_inputs``): full's first pass must carry each row's max and
    denominator across the tiles, and normalise p before it rounds it."""
    q, k, v = attn_parts.peaked_inputs(8, 3, cuda_dev)
    before = attn_parts.launches
    out = attn_parts.attn_parts(q, k, v, mode)
    assert attn_parts.launches == before + 1
    _close(out, attn_parts.attn_parts_plain(q, k, v, mode),
           lambda: attn_parts.attn_parts_plain(q.float(), k.float(), v.float(), mode))


@pytest.mark.parametrize("shape", [(128, 2, 512, 500), (1024, 16, 1536, 1500),
                                   (1280, 20, 1536, 1500)],
                         ids=["D128", "medium", "large-v3"])
def test_rounding_probes_exact(cuda_dev, shape):
    """K4's softmax denominator sums the bf16-rounded p, K8's the fp32 p;
    on the probes the two rules are a bf16 ulp apart, and each kernel must
    give its own rule's output exactly (padding keys of the K8 probe have
    the largest logit, so a dropped mask fails too)."""
    D, H, Tp, t_real = shape
    x, ln, attn, want = k4_probe(cuda_dev, D, H, Tp, t_real)
    assert torch.equal(encoder_block.fused_attention_ln(x, ln, attn, H, t_real), want)
    q, k, v, want = k8_probe(cuda_dev, H, 128, Tp, t_real)
    assert torch.equal(flash.flash_attention_packed(q, k, v, H, t_real), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,T_new,H,Ta,Dh", [(1, 1, 20, 1500, 64), (1, 4, 20, 1500, 64),
                                             (1, 1, 6, 1500, 64), (3, 2, 6, 200, 64),
                                             (1, 9, 2, 500, 64), (1, 1, 6, 1500, 128),
                                             (1, 4, 6, 1500, 128), (3, 3, 2, 300, 256),
                                             (1, 4, 3, 300, 40), (5, 1, 20, 1500, 64),
                                             (1, 4, 4, 203, 64), (2, 3, 2, 40, 64),
                                             (1, 4, 2, 4, 64), (3, 3, 2, 1500, 256)],
                         ids=["large-v3-step", "large-v3-prompt", "tiny-step",
                              "grouped", "two-passes", "dh128-step", "dh128-prompt",
                              "dh256-grouped", "dh40-bytes", "g5", "empty-chunk",
                              "short", "t_real-1", "dh256-r9"])
def test_int8_cross_attention_kernel(cuda_dev, dtype, G, T_new, H, Ta, Dh):
    """K9 against its plain version; codes and scales past t_real hold
    garbage, which the kernel must never read.  t_real = Ta - 3 splits the
    audio over 8 blocks from 128 positions up (``decode_attn.split``); at
    200 (empty-chunk) the 8th block's chunk holds no position, at 37
    (short) 3 blocks split it, at 1 one block takes it."""
    B, D = 2, H * Dh
    g = torch.Generator(device="cuda").manual_seed(Ta + H + T_new)
    k, v = (torch.randn(B, Ta, D, generator=g, device="cuda") for _ in range(2))
    k8, sk = decode_attn.quantize_kv(k, H)
    v8, sv = decode_attn.quantize_kv(v, H)
    Tp = k8.shape[2]
    q = torch.randn(B * G, T_new, D, generator=g, device="cuda").to(dtype)
    t_real = Ta - 3
    for codes, scales in ((k8, sk), (v8, sv)):
        codes[:, :, t_real:] = 127
        scales[:, :, t_real:] = 1e3
    before = decode_attn.launches
    out = decode_attn.int8_cross_attention(q, k8, sk, v8, sv, H, t_real)
    assert decode_attn.launches == before + 1
    ref = decode_attn.int8_cross_attention_plain(q, k8, sk, v8, sv, H, t_real)
    assert out.dtype == torch.float32 and out.shape == (B * G, T_new, D) and Tp >= Ta
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-4


def _decoder_block(D, seed, device):
    torch.manual_seed(seed)
    blk = ResidualAttentionBlock(D, D // 64, cross_attention=True)
    for name in decoder_step.LN_NAMES:  # LayerNorms other than the identity
        getattr(blk, name).weight.data.uniform_(0.5, 1.5)
        getattr(blk, name).bias.data.uniform_(-0.2, 0.2)
    return blk.to(device).requires_grad_(False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "D,B,idx,ctx,Ta,peak",
    [(384, 16, 5, 80, 1500, 1.0), (384, 64, 66, 80, 1500, 1.0), (512, 8, 0, 80, 1500, 1.0),
     (384, 72, 40, 80, 1500, 1.0), (384, 16, 20, 80, 37, 1.0), (384, 8, 0, 80, 1, 1.0),
     (384, 16, 447, 448, 1500, 1.0), (384, 16, 447, 448, 1500, 4.0)],
    ids=["tiny-B16", "tiny-B64", "base-B8", "tiny-B72", "tiny-Ta37", "tiny-Ta1-idx0",
         "tiny-full-self", "tiny-peaked"])
def test_fused_decoder_layer_kernel(cuda_dev, dtype, D, B, idx, ctx, Ta, peak):
    """K10 against its plain version: the layer output and the fresh k/v it
    writes into the self cache at idx (and nowhere else).  B = 72 runs a
    full row tile of 64 and a partial one; Ta 37 and 1 one short cross
    chunk; idx 447 a full 448-position self cache (four self chunks).
    ``peak`` scales the keys at self positions [128, 256) and audio
    positions [1280, 1408): those chunks' maxima stand several units above
    the others', so a merge without the e^(m_s - M) rescale fails in bf16
    too (on random keys the chunk maxima are nearly equal)."""
    H = D // 64
    packed, ln = decoder_step.pack_layer(_decoder_block(D, D + B, cuda_dev), dtype)
    g = torch.Generator(device="cuda").manual_seed(idx + B)
    # every input holds values of ``dtype``, so the fp32 plain run below sees
    # the same inputs
    x = torch.randn(B, D, generator=g, device="cuda").to(dtype)
    sk, sv = (torch.randn(B, H, ctx, 64, generator=g, device="cuda").to(dtype)
              for _ in range(2))
    ck = (torch.randn(B, H, Ta, 64, generator=g, device="cuda") * 64 ** -0.25).to(dtype)
    cv = torch.randn(B, H, Ta, 64, generator=g, device="cuda").to(dtype)
    sk[:, :, 128:256] *= peak
    ck[:, :, 1280:1408] *= peak

    def run(fn, dt):
        caches = [t.to(dt).clone() for t in (sk, sv)]
        out = fn(x.to(dt), packed.to(dt), ln, *caches, ck.to(dt), cv.to(dt), idx, H)
        return out, caches

    before = decoder_step.launches
    out, caches = run(decoder_step.fused_decoder_layer_step, dtype)
    assert decoder_step.launches == before + 1
    ref, ref_caches = run(decoder_step.fused_decoder_layer_step_plain, dtype)
    ref32, ref32_caches = run(decoder_step.fused_decoder_layer_step_plain, torch.float32)
    _close(out, ref, lambda: ref32)
    for c, rc, rc32 in zip(caches, ref_caches, ref32_caches):
        _close(c[:, :, idx], rc[:, :, idx], lambda: rc32[:, :, idx])
        keep = torch.arange(ctx, device="cuda") != idx
        assert torch.equal(c[:, :, keep], rc[:, :, keep])


def test_fused_decoder_layer_raises_on_unsupported_input(cuda_dev):
    packed, ln = decoder_step.pack_layer(_decoder_block(384, 1, cuda_dev), torch.float32)
    x = torch.randn(12, 384, device="cuda")  # batch not a multiple of 8
    sk = torch.zeros(12, 6, 16, 64, device="cuda")
    ck = torch.zeros(12, 6, 100, 64, device="cuda")
    with pytest.raises(ValueError):
        decoder_step.fused_decoder_layer_step(x, packed, ln, sk, sk.clone(), ck, ck, 0, 6)
    with pytest.raises(ValueError):  # idx past the cache
        decoder_step.fused_decoder_layer_step(x[:8], packed, ln, sk[:8], sk[:8].clone(),
                                              ck[:8], ck[:8], 16, 6)


@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("mode", sf.MODES)
def test_step_formulations_kernel(cuda_dev, mode, B):
    """K12's modes against their plain versions at the script's shapes (bf16
    inputs; dma's output is fp32)."""
    q, k, v = sf.inputs(B, mode, B + len(mode), cuda_dev)
    before = sf.launches
    out = sf.step_formulations(q, k, v, mode)
    assert sf.launches == before + 1
    _close(out, sf.step_formulations_plain(q, k, v, mode),
           lambda: sf.step_formulations_plain(q.float(), k.float(), v.float(), mode))


@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("mode", ["vpu", "mxu_t", "mxu_r"])
def test_step_formulations_kernel_wide_logits(cuda_dev, mode, B):
    """The attention modes on inputs N(0, 0.5^2): the logits spread by
    about 2 per head, so a fault in the online softmax's rescale or in the
    merge of the splits moves the output by tenths.  The kernel rounds p
    against its chunk's running max, the plain version against the row's:
    the kernel is held to NOISE_FACTOR times the plain bf16 version's
    distance from the plain version in f32, both measured from the f32
    one."""
    q, k, v = sf.inputs(B, mode, B + len(mode), cuda_dev, scale=0.5)
    out = sf.step_formulations(q, k, v, mode)
    p = sf.step_formulations_plain(q, k, v, mode)
    p32 = sf.step_formulations_plain(q.float(), k.float(), v.float(), mode).float()
    assert out.shape == p.shape and out.dtype == p.dtype and torch.isfinite(out).all()
    err = float((out.float() - p32).abs().max())
    noise = float((p.float() - p32).abs().max())
    assert err <= NOISE_FACTOR * noise, (err, noise)


@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("mode", ["vpu", "mxu_t", "mxu_r"])
def test_step_formulations_kernel_peaked(cuda_dev, mode, B):
    """The attention modes on ``step_formulations.peaked_inputs``: per row
    and head one position of the kernel's last split planted 6 above the
    row's other logits, so the first split's max lies units below the
    row's and a merge without e^(m_s - M) misses by the output's size; held
    as the wide case."""
    S = sf.card_splits(mode, B, sf.T_AUDIO, cuda_dev)
    q, k, v = sf.peaked_inputs(B, mode, B + 7 * len(mode), cuda_dev, n_splits=S)
    out = sf.step_formulations(q, k, v, mode)
    p = sf.step_formulations_plain(q, k, v, mode)
    p32 = sf.step_formulations_plain(q.float(), k.float(), v.float(), mode).float()
    assert out.shape == p.shape and out.dtype == p.dtype and torch.isfinite(out).all()
    err = float((out.float() - p32).abs().max())
    noise = float((p.float() - p32).abs().max())
    assert err <= NOISE_FACTOR * noise, (err, noise)


@pytest.mark.parametrize("mode", sf.MODES)
def test_step_formulations_graph_replay_and_tickets(cuda_dev, mode):
    """One launch a call: captured in a CUDA graph, a replay gives the
    eager call's output bit for bit (the merge reads the splits in a fixed
    order whichever block merges), and every call leaves the merge tickets
    at 0."""
    q, k, v = sf.inputs(8, mode, 5, cuda_dev, ta=512)
    eager = sf.step_formulations(q, k, v, mode)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sf.step_formulations(q, k, v, mode)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = sf.launches
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = sf.step_formulations(q, k, v, mode)
    assert sf.launches == before + 1
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert int(sf._tickets[q.device].abs().sum()) == 0


def test_step_formulations_raise_on_unsupported_input(cuda_dev):
    q, k, v = sf.inputs(8, "mxu_r", 0, cuda_dev, ta=128)
    with pytest.raises(ValueError):  # B not a multiple of 8
        sf.step_formulations(q[:4], k[:4], v[:4], "mxu_r")
    with pytest.raises(ValueError):  # Ta not a multiple of 64
        sf.step_formulations(q, k[:, :100], v[:, :100], "dma")
    with pytest.raises(ValueError):  # fp32
        sf.step_formulations(q.float(), k.float(), v.float(), "dma")
    with pytest.raises(ValueError):  # the other layout
        sf.step_formulations(q, k, v, "vpu")


def test_beam_transition_ties_on_card(cuda_dev):
    """The beam selection on the card equals the CPU's where scores tie
    (torch.topk orders ties differently on CUDA; the port sorts stably)."""
    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch.decode import DecodingTask
    from qasr_ijcnlp_tpu_torch.decode import loop as tloop

    sd = init_params(torch.Generator().manual_seed(1), SMALL)
    cfg = DecodingTask(WhisperModel.from_state_dict(sd, SMALL, "cpu"), port.DecodingOptions(
        language="en", without_timestamps=True, beam_size=4)).loop_cfg
    B, K, C, W, eot = 2, 4, 3, 20, cfg.eot
    cur = cfg.sample_begin
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(B * K, SMALL.n_vocab, generator=g) * 3
    logits[0, 100:110] = logits[0].max() + 1.0  # a ten-way tie at the top
    logits[1] = logits[0]
    logits[2, eot] = logits[2].max() + 0.5
    start = torch.full((K,), float("-inf"))
    start[0] = 0.0
    state = tloop.BeamState(
        torch.full((B * K, W), eot), start.repeat(B), torch.full((B, C, W), eot),
        torch.full((B, C), float("-inf")), torch.zeros(B, dtype=torch.long),
        torch.full((B * K,), -1), torch.full((B * K,), -1), torch.zeros(B * K, dtype=torch.long))
    on = lambda st, dev: tloop.BeamState(*(t.to(dev) for t in st))
    cpu, gpu = state, on(state, cuda_dev)
    for _ in range(3):
        cpu, src, tok = tloop.beam_transition(cfg, K, C, logits, cur, cpu)
        gpu, gsrc, gtok = tloop.beam_transition(cfg, K, C, logits.to(cuda_dev), cur, gpu)
        assert torch.equal(gsrc.cpu(), src) and torch.equal(gtok.cpu(), tok)
        for a, b in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b)
        cur += 1


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_grouped_decoder_step_on_card(model, int8):
    """A prompt and one beam step of G = 5 rows per audio over the grouped
    cross cache (one row per audio), card vs CPU in f32; with the int8
    cache K9 runs at G = 5, once per layer and step."""
    dims, B, G = model.dims, 2, 5
    sd = {k: v.cpu() for k, v in model.module.state_dict().items()}
    cpu = WhisperModel.from_state_dict(sd, dims, "cpu")
    g = torch.Generator().manual_seed(4)
    xa = torch.randn(B, dims.n_audio_ctx, dims.n_audio_state, generator=g)
    prompt = torch.randint(0, 50000, (B * G, 3), generator=g)
    step = torch.randint(0, 50000, (B * G, 1), generator=g)
    src = torch.tensor([0, 0, 2, 1, 3, 5, 9, 9, 6, 7])  # a parent gather within groups
    outs = []
    for m in (model, cpu):
        dev = m.device
        cache = tmodel.precompute_cross_kv(
            m.module.decoder, xa.to(dev),
            tmodel.init_kv_cache(dims, B * G, device=dev, cross_batch=B, ctx=16,
                                 cross_int8=int8))
        before = decode_attn.launches
        a, cache = tmodel.decoder_step(m.module.decoder, prompt.to(dev), cache, dims)
        cache = {**cache, "self_k": [k.index_select(0, src.to(dev)) for k in cache["self_k"]],
                 "self_v": [v.index_select(0, src.to(dev)) for v in cache["self_v"]]}
        b, _ = tmodel.decoder_step(m.module.decoder, step.to(dev), cache, dims)
        if dev.type == "cuda":
            assert decode_attn.launches - before == (2 * dims.n_text_layer if int8 else 0)
        outs.append((a.cpu(), b.cpu()))
    for x, y in zip(*outs):
        assert float((x - y).abs().max()) <= 1e-3


def test_beam_decode_on_card_matches_cpu(model):
    """f32 beam decode (K = 3) through the kernels equals the CPU plain
    path."""
    import qasr_ijcnlp_tpu_torch as port

    sd = {k: v.cpu() for k, v in model.module.state_dict().items()}
    cpu = WhisperModel.from_state_dict(sd, model.dims, "cpu")
    T = model.dims.n_audio_ctx
    pcm = (np.random.default_rng(6).standard_normal((2, 2 * T * 160)) * 0.1).astype(
        np.float32)
    opts = port.DecodingOptions(language="en", sample_len=8, fp16=False, beam_size=3)
    ours = port.decode(model, port.log_mel_spectrogram(pcm, device="cuda"), opts)
    ref = port.decode(cpu, port.log_mel_spectrogram(pcm, device="cpu"), opts)
    assert [r.tokens for r in ours] == [r.tokens for r in ref]


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_per_row_offsets_on_card(model, int8):
    """``decoder_step(offsets=...)`` on the card against the CPU in f32: the
    per-row scatter of the self K/V (a row at the cache's end clamped to
    Tmax - T_new) and the per-row causal mask, a prompt then a ragged slab
    of 3; with the int8 cache K9 runs once per layer and step on the pool
    (the engine's and the speculative verify's shapes: T_new 1 and 3)."""
    dims, B = model.dims, 4
    sd = {k: v.cpu() for k, v in model.module.state_dict().items()}
    cpu = WhisperModel.from_state_dict(sd, dims, "cpu")
    g = torch.Generator().manual_seed(7)
    xa = torch.randn(B, dims.n_audio_ctx, dims.n_audio_state, generator=g)
    prompt = torch.randint(0, 50000, (B, 5), generator=g)
    slab = torch.randint(0, 50000, (B, 3), generator=g)
    one = torch.randint(0, 50000, (B, 1), generator=g)
    steps = ((prompt, [0, 0, 0, 0]), (slab, [5, 2, 15, 4]), (one, [8, 3, 15, 6]))
    outs = []
    for m in (model, cpu):
        dev = m.device
        cache = tmodel.precompute_cross_kv(
            m.module.decoder, xa.to(dev),
            tmodel.init_kv_cache(dims, B, device=dev, ctx=16, cross_int8=int8))
        before = decode_attn.launches
        logits = []
        for toks, off in steps:
            lg, cache = tmodel.decoder_step(m.module.decoder, toks.to(dev), cache, dims,
                                            offsets=torch.tensor(off, device=dev))
            logits.append(lg.cpu())
        if dev.type == "cuda":
            assert decode_attn.launches - before == (3 * dims.n_text_layer if int8 else 0)
        outs.append((logits, [k.cpu() for k in cache["self_k"] + cache["self_v"]]))
    for x, y in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
        assert float((x - y).abs().max()) <= 1e-3


@pytest.mark.parametrize("kind", ["int8", "lookup", "beam"])
def test_engine_pool_on_card_matches_cpu_decode(model, kind):
    """A pool of 3 slots, 5 requests with mid-flight admission, on the card:
    each request's f32 tokens equal the CPU plain path's decode; the int8
    pool runs K9 once per layer in every step and prompt pass."""
    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine

    sd = {k: v.cpu() for k, v in model.module.state_dict().items()}
    cpu = WhisperModel.from_state_dict(sd, model.dims, "cpu")
    T = model.dims.n_audio_ctx
    pcm = (np.random.default_rng(8).standard_normal((5, 2 * T * 160)) * 0.1).astype(
        np.float32)
    extra = {"int8": dict(kv_int8=True), "lookup": {}, "beam": dict(beam_size=3)}[kind]
    opts = port.DecodingOptions(language="en", sample_len=8, fp16=False, **extra)
    mel = port.log_mel_spectrogram(pcm, device="cpu")
    ref = port.decode(cpu, mel, opts)
    engine = DecodeEngine(model, opts, slots=3, unroll=2,
                          lookup_gamma=3 if kind == "lookup" else 0)
    try:
        before = decode_attn.launches
        with concurrent.futures.ThreadPoolExecutor(5) as pool:
            out = list(pool.map(engine.submit, mel))
    finally:
        engine.close()
    if kind != "int8":
        assert decode_attn.launches == before
    else:
        assert decode_attn.launches > before
    assert [o["tokens"] for o in out] == [r.tokens for r in ref]


# -- the quantum encoder, the char heads and the data views on the card -------------------

def _quantum_pair(dims, dev, seed=2):
    from qasr_ijcnlp_tpu_torch.models.quantum import QuantumWhisperModel, init_quantum_params

    sd = init_quantum_params(torch.Generator().manual_seed(seed), dims, 4)
    return (QuantumWhisperModel.from_state_dict(sd, dims, dev),
            QuantumWhisperModel.from_state_dict(sd, dims, "cpu"))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_quantum_encoder_on_card(cuda_dev, dtype):
    """The quantum stem on the card against the CPU's (f32: 1e-4; it runs
    in f32 in both dtypes), then a counted encoder pass: the classical stem
    kernel never, K4 and the finish once a layer."""
    from qasr_ijcnlp_tpu_torch.models.quantum import quantum_stem

    gpu, cpu = _quantum_pair(SMALL, cuda_dev)
    mel = torch.randn(2, 80, 1000, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got = quantum_stem(gpu.module.encoder, mel.to(cuda_dev), dtype)
        want = quantum_stem(cpu.module.encoder, mel, dtype)
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * float(want.abs().max())
        assert float((got.float().cpu() - want.float()).abs().max()) <= tol
        conv_stem.launches = encoder_block.attn_launches = encoder_block.finish_launches = 0
        feats = tmodel.dispatch_encoder_apply(gpu.module.encoder, mel.to(cuda_dev), SMALL,
                                              dtype)
        torch.cuda.synchronize()
    assert conv_stem.launches == 0
    assert encoder_block.attn_launches == encoder_block.finish_launches == SMALL.n_audio_layer
    assert feats.shape == (2, 500, 128) and torch.isfinite(feats).all()
    if dtype == torch.float32:
        ref = tmodel.dispatch_encoder_apply(cpu.module.encoder, mel, SMALL)
        assert float((feats.cpu() - ref).abs().max()) <= 1e-4


def test_quantum_decode_on_card_matches_cpu(cuda_dev):
    import qasr_ijcnlp_tpu_torch as port

    gpu, cpu = _quantum_pair(SMALL, cuda_dev)
    mel = np.random.default_rng(4).standard_normal((2, 80, 1000)).astype(np.float32)
    opts = port.DecodingOptions(fp16=False, language="en", without_timestamps=True,
                                sample_len=8)
    assert [r.tokens for r in port.decode(gpu, mel, opts)] == \
        [r.tokens for r in port.decode(cpu, mel, opts)]


def test_char_heads_on_card_match_cpu(cuda_dev):
    """The LSTM and MLP heads on the card against the CPU on the same
    encoder output: logits to 1e-4, greedy ids equal."""
    import copy

    from qasr_ijcnlp_tpu_torch.models import asr

    enc = torch.randn(3, 50, 128, generator=torch.Generator().manual_seed(5))
    ids = torch.randint(0, 30, (3, 12), generator=torch.Generator().manual_seed(6))
    for init, hidden in ((asr.init_lstm_decoder, 64), (asr.init_mlp_head, 128)):
        head = init(torch.Generator().manual_seed(7), 128, 30, hidden, 2)
        card = copy.deepcopy(head).to(cuda_dev)
        with torch.inference_mode():
            if init is asr.init_lstm_decoder:
                pairs = [(asr.lstm_teacher_forced, (enc, ids))]
                greedy = asr.lstm_greedy_decode
            else:
                pairs = [(asr.mlp_head_apply, (enc, ids)), (asr.mlp_head_char_logits, (enc, ids))]
                greedy = asr.mlp_greedy_decode
            for fn, (e, i) in pairs:
                got = fn(card, e.to(cuda_dev), i.to(cuda_dev)).cpu()
                assert float((got - fn(head, e, i)).abs().max()) <= 1e-4
            out, n = greedy(card, enc.to(cuda_dev), 2, 3, 20)
            want, wn = greedy(head, enc, 2, 3, 20)
        assert torch.equal(out.cpu(), want) and torch.equal(n.cpu(), wn)


def test_data_views_and_prefetch_on_card(cuda_dev):
    """A view asked for the card computes its mel there (K1 once an item) and
    returns numpy within the mel tolerance of the CPU's; the prefetcher
    lands batches on the card through pinned memory."""
    from qasr_ijcnlp_tpu_torch.data import CharASRView, CharVocabulary, SyntheticLibriSpeech
    from qasr_ijcnlp_tpu_torch.data.loader import DataLoader, prefetch_to_device

    base = SyntheticLibriSpeech("test", 2)
    vocab = CharVocabulary.build([base[i][1] for i in range(2)])
    melfront.launches = 0
    mel, ids = CharASRView(base, vocab, 32, device=cuda_dev)[0]
    assert melfront.launches == 1 and isinstance(mel, np.ndarray)
    ref, rids = CharASRView(base, vocab, 32, device="cpu")[0]
    np.testing.assert_allclose(mel, ref, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(ids, rids)
    loader = DataLoader(CharASRView(base, vocab, 32, device=cuda_dev), 2, shuffle=False)
    (m, i), = list(prefetch_to_device(iter(loader), device=cuda_dev))
    assert m.device.type == "cuda" and i.device.type == "cuda"
    np.testing.assert_allclose(m[0].cpu().numpy(), ref, atol=2e-4, rtol=1e-4)


# -- gradients: each kernel's autograd Function against the plain version --------------

GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _grad_check(counter, wrapper, plain, inputs, dtype, plain32=None):
    """``wrapper`` (through its Function: the kernel forward, one launch, the
    plain version's VJP backward, no launch) against autograd through
    ``plain`` on the same inputs: the forward as the kernel tests hold it,
    and the gradient of every input within GRAD_TOL of its largest
    magnitude (the same plain ops on both sides; the tolerance covers
    non-deterministic reductions, in bf16 one ulp).  ``plain32``: the plain
    version in f32 for the bf16 forward's noise (default: ``plain`` on the
    inputs in f32)."""
    mod, attr = counter
    cot = None
    res = []
    for fn in (wrapper, plain):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        before = getattr(mod, attr)
        out = fn(*xs)
        assert getattr(mod, attr) == before + (fn is wrapper)
        if cot is None:
            cot = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(9),
                              device="cuda").to(out.dtype)
        grads = torch.autograd.grad(out, xs, cot)
        assert getattr(mod, attr) == before + (fn is wrapper)  # no launch in the backward
        res.append((out.detach(), grads))
    (k, gk), (p, gp) = res
    with torch.no_grad():
        _close(k, p, plain32 or (lambda: plain(*(t.float() for t in inputs))))
    for i, (a, b) in enumerate(zip(gk, gp)):
        assert a.dtype == b.dtype and torch.isfinite(a).all(), i
        err = float((a.float() - b.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * float(b.float().abs().max()), (i, err)


def _ns(**kw):
    from types import SimpleNamespace

    return SimpleNamespace(**kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,C0", [(384, 80), (1024, 80)], ids=["K2_tiny", "K3_medium"])
def test_conv_stem_gradients(cuda_dev, dtype, D, C0):
    enc = _stem_encoder(cuda_dev, D, C0)
    mel = torch.randn(2, C0, 3000, generator=torch.Generator(device="cuda").manual_seed(3),
                      device="cuda")
    ins = [mel, *conv_stem._stem_weights(enc)]
    wrapper = lambda mel, w1, b1, w2, b2, pos: conv_stem.fused_conv_stem(
        _ns(conv1=_ns(weight=w1, bias=b1), conv2=_ns(weight=w2, bias=b2),
            positional_embedding=pos), mel, 1536, dtype)
    plain = lambda mel, w1, b1, w2, b2, pos: conv_stem._plain_stem(
        _ns(conv1=_ns(weight=w1, bias=b1), conv2=_ns(weight=w2, bias=b2),
            positional_embedding=pos), mel, 1536, dtype)
    _grad_check((conv_stem, "launches"), wrapper, plain, ins, dtype,
                lambda: conv_stem._plain_stem(enc, mel, 1536, torch.float32))


@pytest.mark.parametrize("peak", [1.0, 8.0], ids=["random", "peaked"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,H", [(384, 6), (1024, 16)], ids=["tiny", "medium"])
def test_fused_block_gradients(cuda_dev, dtype, D, H, peak):
    """K4 and the finish (K5 at tiny, K6 at medium) at one block, Tp 1536,
    t_real 1500; ``peaked``: the query weight scaled 8x, which sharpens
    the softmax."""
    torch.manual_seed(D)
    blk = ResidualAttentionBlock(D, H).to(cuda_dev)
    with torch.no_grad():
        blk.attn.query.weight.mul_(peak)
    g = torch.Generator(device="cuda").manual_seed(D)
    x, a = (torch.randn(2, 1536, D, generator=g, device="cuda").to(dtype) for _ in range(2))

    def attn_ns(g_, b_, wq, bq, wk, wv, bv):
        return (_ns(weight=g_, bias=b_), _ns(query=_ns(weight=wq, bias=bq),
                                              key=_ns(weight=wk, bias=None),
                                              value=_ns(weight=wv, bias=bv)))

    _grad_check((encoder_block, "attn_launches"),
                lambda x, *w: encoder_block.fused_attention_ln(x, *attn_ns(*w), H, 1500),
                lambda x, *w: encoder_block._plain_attn_ln(x, *attn_ns(*w), H, 1500),
                [x, *encoder_block._attention_weights(blk.attn_ln, blk.attn)], dtype)

    def block_ns(wo, bo, g_, b_, wf, bf, wp, bp):
        return _ns(attn=_ns(out=_ns(weight=wo, bias=bo)), mlp_ln=_ns(weight=g_, bias=b_),
                   mlp=[_ns(weight=wf, bias=bf), None, _ns(weight=wp, bias=bp)])

    _grad_check((encoder_block, "finish_launches"),
                lambda x, a, *w: encoder_block.fused_block_finish(x, a, block_ns(*w)),
                lambda x, a, *w: encoder_block._plain_finish(x, a, block_ns(*w)),
                [x, a, *encoder_block._finish_weights(blk)], dtype)


@pytest.mark.parametrize("peak", [1.0, 8.0], ids=["random", "peaked"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_gradients(cuda_dev, dtype, peak):
    """K7 at small-h96 (8 heads of 96 as strided views of (2, 1536, 768)) and
    K8 at large-v3 ((2, 1536, 1280), 20 heads), t_real 1500; ``peaked``: q
    scaled 8x."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (_heads_of_rows(2, 1536, 8, 96, g, dtype, s) for s in (0.35 * peak, 0.35, 1.0))
    _grad_check((flash, "launches_4d"), lambda q, k, v: flash.flash_attention(q, k, v, 1500),
                lambda q, k, v: flash._plain_attention(q, k, v, 1500), [q, k, v], dtype)
    q, k, v = (torch.randn(2, 1536, 1280, generator=g, device="cuda").mul(s).to(dtype)
               for s in (0.35 * peak, 0.35, 1.0))
    _grad_check((flash, "launches"),
                lambda q, k, v: flash.flash_attention_packed(q, k, v, 20, 1500),
                lambda q, k, v: flash._plain_attention_packed(q, k, v, 20, 1500), [q, k, v],
                dtype)


def test_packs_follow_in_place_updates_on_card(cuda_dev):
    """An optimizer step writes the weights in place: the next kernel call
    repacks and equals the plain version on the new weights."""
    torch.manual_seed(0)
    blk = ResidualAttentionBlock(384, 6).to(cuda_dev).requires_grad_(False)
    enc = _stem_encoder(cuda_dev, 384, 80)
    x = torch.randn(2, 1536, 384, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    mel = torch.randn(2, 80, 3000, generator=torch.Generator(device="cuda").manual_seed(2),
                      device="cuda")
    for step in range(2):
        a = encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, 6, 1500)
        f = encoder_block.fused_block_finish(x, a, blk)
        s = conv_stem.fused_conv_stem(enc, mel, 1536)
        _close(a, encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, 6, 1500), None)
        _close(f, encoder_block._plain_finish(x, a, blk), None)
        _close(s, conv_stem._plain_stem(enc, mel, 1536, torch.float32), None)
        with torch.no_grad():
            for p in list(blk.parameters()) + list(enc.parameters()):
                p.add_(0.01 * torch.randn_like(p))


# -- the kernels as qasr:: custom ops (export.py with_kernels=True) ----------------------

def _op_cases(cuda_dev, dtype):
    """(name, op call, wrapper call) on one weight set each: K1, the stem,
    K4, K5, K7 at small-h96's heads (8 of 96) and K8."""
    from qasr_ijcnlp_tpu_torch.ops import library

    g = torch.Generator(device="cpu").manual_seed(11)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda_dev)
    blk = ResidualAttentionBlock(384, 6).to(cuda_dev).requires_grad_(False)
    x = r(2, 1536, 384).to(dtype)
    attn_out = r(2, 1536, 384, scale=0.1).to(dtype)
    audio = r(2, 16000 * 30 + 400, scale=0.1)
    enc = tmodel.Whisper(tiny_dims()).encoder.to(cuda_dev).requires_grad_(False)
    mel = r(2, 80, 3000)
    q, k, v = (r(2, 8, 1536, 96, scale=0.3).to(dtype) for _ in range(3))
    qp, kp, vp = (r(2, 1536, 1280, scale=0.3).to(dtype) for _ in range(3))
    aw, fw = encoder_block._attention_weights(blk.attn_ln, blk.attn), \
        encoder_block._finish_weights(blk)
    sw = conv_stem._stem_weights(enc)
    return [
        ("log10_mel", lambda: library.log10_mel(audio, 80), lambda: melfront.log10_mel(audio, 80)),
        ("conv_stem", lambda: library.conv_stem_op(mel, *sw, 1536, dtype),
         lambda: conv_stem.fused_conv_stem(enc, mel, 1536, dtype)),
        ("attention_ln", lambda: library.attention_ln(x, *aw, 6, 1500),
         lambda: encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, 6, 1500)),
        ("block_finish", lambda: library.block_finish(x, attn_out, *fw),
         lambda: encoder_block.fused_block_finish(x, attn_out, blk)),
        ("flash_attention", lambda: library.flash_attention(q, k, v, 1500),
         lambda: flash.flash_attention(q, k, v, 1500)),
        ("flash_attention_packed", lambda: library.flash_attention_packed(qp, kp, vp, 20, 1500),
         lambda: flash.flash_attention_packed(qp, kp, vp, 20, 1500)),
    ]


# op name -> the launch counter its body bumps (module, attribute)
OP_COUNTERS = {
    "log10_mel": (melfront, "launches"),
    "conv_stem": (conv_stem, "launches"),
    "attention_ln": (encoder_block, "attn_launches"),
    "block_finish": (encoder_block, "finish_launches"),
    "flash_attention": (flash, "launches_4d"),
    "flash_attention_packed": (flash, "launches"),
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_custom_ops_equal_their_wrappers(cuda_dev, dtype):
    """Each op launches its wrapper's kernel once and returns its bits."""
    for name, op, wrapper in _op_cases(cuda_dev, dtype):
        if name == "log10_mel" and dtype != torch.float32:
            continue  # K1 is f32 only
        mod, attr = OP_COUNTERS[name]
        before = getattr(mod, attr)
        got = op()
        assert getattr(mod, attr) == before + 1, name
        want = wrapper()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert got.stride() == want.stride(), name
        assert torch.equal(got, want), name


def test_op_pack_follows_an_in_place_weight_update(cuda_dev):
    """The op builds its weight pack at every call: after an in-place update
    of the weights it computes with the new values (the wrapper's cached
    pack is rebuilt on the version change, so both agree again)."""
    from qasr_ijcnlp_tpu_torch.ops import library

    blk = ResidualAttentionBlock(384, 6).to(cuda_dev).requires_grad_(False)
    x = torch.randn(2, 1536, 384, generator=torch.Generator().manual_seed(3)).to(cuda_dev)
    aw = encoder_block._attention_weights(blk.attn_ln, blk.attn)
    first = library.attention_ln(x, *aw, 6, 1500)
    with torch.no_grad():
        blk.attn.query.weight.mul_(1.5)
        blk.attn_ln.bias.add_(0.25)
    second = library.attention_ln(x, *aw, 6, 1500)
    assert not torch.equal(first, second)
    assert torch.equal(second, encoder_block.fused_attention_ln(x, blk.attn_ln, blk.attn, 6,
                                                                1500))
    plain = encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, 6, 1500)
    assert float((second - plain).abs().max()) <= 1e-4


def test_kernels_artifact_token_exact_on_card(cuda_dev, tmp_path):
    """A kernels artifact (tiny, B=4, from audio, f32), saved and loaded:
    the live decode's tokens, and the live path's encoder launches."""
    from chip_smoke import read_counters, synthetic_pcm, zero_counters

    from qasr_ijcnlp_tpu_torch import export, log_mel_spectrogram
    from qasr_ijcnlp_tpu_torch.decode import DecodingOptions, decode

    dims = tiny_dims()
    m = WhisperModel.from_state_dict(init_params(torch.Generator().manual_seed(5), dims), dims,
                                     cuda_dev)
    opts = DecodingOptions(fp16=False, language="en", without_timestamps=True, sample_len=24)
    pcm = synthetic_pcm(4, 9)
    ep, meta = export.export_greedy_decode(m, opts, batch=4, device="cuda", with_kernels=True)
    path = str(tmp_path / "tiny.qasrt")
    export.save_artifact(path, ep, meta)
    call, meta = export.load_artifact(path)
    assert meta["with_kernels"] and meta["device"] == "cuda"
    cs = zero_counters()
    out = call(pcm)
    got = read_counters(cs)
    cs = zero_counters()
    want = decode(m, log_mel_spectrogram(pcm, device=cuda_dev), opts)
    live = read_counters(cs)
    assert got == live and got["attn"] == dims.n_audio_layer and got["mel"] == 1
    assert [list(t) for t in export.decode_artifact_tokens(out[0], out[1], meta)] == \
        [list(r.tokens) for r in want]
