"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

One small geometry that still takes the JAX kernel paths in interpret mode:
n_audio_ctx 500 (tile-padded to 512, mel of 1000 frames), width 128 with
two 64-wide heads, two encoder and two decoder layers, the real multilingual
vocabulary and a 48-token text context.  Weights are JAX ``init_params``
moved to the port through numpy (``from_jax_params``).
"""

import jax
import numpy as np

from qasr_ijcnlp_tpu.models import whisper as jmodel
from qasr_ijcnlp_tpu.models.dims import ModelDimensions
from qasr_ijcnlp_tpu_torch.models import convert
from qasr_ijcnlp_tpu_torch.models.convert import from_jax_params
from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
from qasr_ijcnlp_tpu_torch.models.whisper import ResidualAttentionBlock

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
