"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

One small geometry that still takes the JAX kernel paths in interpret mode:
n_audio_ctx 500 (tile-padded to 512, mel of 1000 frames), width 128 with
two 64-wide heads, two encoder and two decoder layers, the real multilingual
vocabulary and a 48-token text context.  Weights are JAX ``init_params``
moved to the port through numpy (``from_jax_params``).
"""

import jax
import numpy as np
import torch

from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.dims import ModelDimensions
from qasr_ijcnlp_tpu_torch.models import convert
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_params
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock
from qasr_ijcnlp_tpu_torch.ops import decode_attn

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=500, n_audio_state=128, n_audio_head=2,
    n_audio_layer=2, n_vocab=51865, n_text_ctx=48, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)
T_PAD = 512


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
