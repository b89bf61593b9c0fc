"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without one the ``cuda_dev``
fixture skips it (the check happens in the fixture, never at import, so
every pytest-xdist worker collects the same tests).  The card has no JAX, so
run this file without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are chip_smoke.py's: f32 atol 1e-4 (two fp32 summation orders),
bf16 atol 0.08 + 2^-7 |x| (tests/test_encoder_block.py's bf16 bound plus
two bf16 ulps), mel atol 2e-4 (tests/test_ops.py).
"""

import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions, tiny_dims
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.models.whisper import init_params
from qasr_ijcnlp_tpu_torch.ops import conv_stem, encoder_block, melfront

pytestmark = pytest.mark.cuda

SMALL = ModelDimensions(80, 500, 128, 2, 2, 51865, 48, 128, 2, 2)
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


def _close(k, p, dtype):
    assert k.shape == p.shape and k.dtype == p.dtype
    assert torch.isfinite(k).all()
    diff = (k.float() - p.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4, float(diff.max())
    else:
        assert float((diff - 0.08 - 2.0 ** -7 * p.float().abs()).max()) <= 0


def _x(model, seed, dtype, batch=2):
    Tp = (model.dims.n_audio_ctx + 127) // 128 * 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(batch, Tp, model.dims.n_audio_state, generator=g,
                       device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_stem_kernel(model, dtype):
    enc, T = model.module.encoder, model.dims.n_audio_ctx
    Tp = (T + 127) // 128 * 128
    mel = torch.randn(2, 80, 2 * T, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    before = conv_stem.launches
    k = conv_stem.fused_conv_stem(enc, mel, Tp, dtype)
    assert conv_stem.launches == before + 1
    _close(k, conv_stem._plain_stem(enc, mel, Tp, dtype), dtype)
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
    _close(k, encoder_block._plain_attn_ln(x, blk.attn_ln, blk.attn, H, t_real), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_finish_kernel(model, dtype):
    x, a = _x(model, 2, dtype), _x(model, 3, dtype)
    blk = model.module.encoder.blocks[1]
    before = encoder_block.finish_launches
    k = encoder_block.fused_block_finish(x, a, blk)
    assert encoder_block.finish_launches == before + 1
    _close(k, encoder_block._plain_finish(x, a, blk), dtype)


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
    ref = port.decode(cpu, port.log_mel_spectrogram(pcm), opts)
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
