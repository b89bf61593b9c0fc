"""The encoder-path kernels as ``torch.library`` custom ops (``qasr::``).

``torch.export`` cannot look inside a ctypes launch, so a program that
keeps the kernels (``export.export_greedy_decode(with_kernels=True)``)
records each kernel call as one opaque node: the ops below, traced in place
of the wrappers while ``ops.record_ops()`` is on.  Each op's body is the
wrapper's own launch (K1 ``_launch_log_mel``, K2/K3 ``_launch_stem``, K4
``_launch_attention``, K5/K6 ``_launch_finish``, K7 ``_launch_4d``, K8
``_launch_packed``), so the kernels and their launch counters are the live
path's; on CPU tensors the body is the plain version, as the wrappers'.
Each op has a ``register_fake`` that gives its output's shape, strides and
dtype, which is all the tracer sees.

The weight packs (TF32 hi/lo slabs, the stem's tap-major layout) are built
inside the body at every call, on a holder that lives for that call only:
a traced program holds tensors without storage, so no pack may be keyed
on a storage or a version counter while it is traced, and at run time a
pack made per call follows any change to the weights (an in-place update,
the int8 program's weights dequantized anew each call).  The live wrappers
keep their cached packs.

Loading a kernels artifact needs these registrations: import this module
(``export.load_artifact`` does).
"""

from __future__ import annotations

from types import SimpleNamespace as _NS

import torch

from . import conv_stem, encoder_block, flash, melfront
from .melfront import HOP_LENGTH, N_FFT


@torch.library.custom_op("qasr::log10_mel", mutates_args=())
def log10_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """K1: reflect-padded (B, L) float32 -> (B, n_mels, F) log10 mel."""
    if not audio.is_cuda:
        return melfront._plain_log10_mel(audio, n_mels).contiguous()
    return melfront._launch_log_mel(audio, n_mels)


@log10_mel.register_fake
def _(audio, n_mels):
    return audio.new_empty(audio.shape[0], n_mels, (audio.shape[-1] - N_FFT) // HOP_LENGTH)


def _encoder(w1, b1, w2, b2, pos):
    return _NS(conv1=_NS(weight=w1, bias=b1), conv2=_NS(weight=w2, bias=b2),
               positional_embedding=pos)


@torch.library.custom_op("qasr::conv_stem", mutates_args=())
def conv_stem_op(mel: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, pos: torch.Tensor, t_pad: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """K2/K3: (B, n_mels, T) mel -> (B, t_pad, D) trunk input in ``dtype``."""
    enc = _encoder(w1, b1, w2, b2, pos)
    if not mel.is_cuda:
        return conv_stem._plain_stem(enc, mel, t_pad, dtype)
    return conv_stem._launch_stem(enc, mel, t_pad, dtype)


@conv_stem_op.register_fake
def _(mel, w1, b1, w2, b2, pos, t_pad, dtype):
    return mel.new_empty(mel.shape[0], t_pad, w1.shape[0], dtype=dtype)


@torch.library.custom_op("qasr::attention_ln", mutates_args=())
def attention_ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, wq: torch.Tensor,
                 bq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, bv: torch.Tensor,
                 n_head: int, t_real: int) -> torch.Tensor:
    """K4: LN + QKV + masked attention, (B, Tp, D) -> (B, Tp, D)."""
    ln = _NS(weight=g, bias=b)
    attn = _NS(query=_NS(weight=wq, bias=bq), key=_NS(weight=wk, bias=None),
               value=_NS(weight=wv, bias=bv))
    if not x.is_cuda:
        return encoder_block._plain_attn_ln(x, ln, attn, n_head, t_real)
    return encoder_block._launch_attention(x, ln, attn, n_head, t_real)


@attention_ln.register_fake
def _(x, g, b, wq, bq, wk, wv, bv, n_head, t_real):
    return torch.empty_like(x)


@torch.library.custom_op("qasr::block_finish", mutates_args=())
def block_finish(x: torch.Tensor, attn_out: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                 g: torch.Tensor, b: torch.Tensor, wf: torch.Tensor, bf: torch.Tensor,
                 wp: torch.Tensor, bp: torch.Tensor) -> torch.Tensor:
    """K5/K6: out-projection + residual, LN + MLP + residual."""
    block = _NS(attn=_NS(out=_NS(weight=wo, bias=bo)), mlp_ln=_NS(weight=g, bias=b),
                mlp=[_NS(weight=wf, bias=bf), None, _NS(weight=wp, bias=bp)])
    if not x.is_cuda:
        return encoder_block._plain_finish(x, attn_out, block)
    return encoder_block._launch_finish(x, attn_out, block)


@block_finish.register_fake
def _(x, attn_out, wo, bo, g, b, wf, bf, wp, bp):
    return torch.empty_like(x)


@torch.library.custom_op("qasr::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    t_real: int) -> torch.Tensor:
    """K7: (B, H, Tq, dh) heads -> (B, H, Tq, dh), a view of (B, Tq, H, dh)
    on the card (the wrapper's layout)."""
    if not q.is_cuda:
        return flash._plain_attention(q, k, v, t_real)
    return flash._launch_4d(q, k, v, t_real)


@flash_attention.register_fake
def _(q, k, v, t_real):
    B, H, Tq, dh = q.shape
    if q.is_cuda:
        return q.new_empty(B, Tq, H, dh).transpose(1, 2)
    return q.new_empty(B, H, Tq, dh)


@torch.library.custom_op("qasr::flash_attention_packed", mutates_args=())
def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                           t_real: int) -> torch.Tensor:
    """K8: packed (B, T, D) heads -> (B, Tq, D)."""
    if not q.is_cuda:
        return flash._plain_attention_packed(q, k, v, n_head, t_real)
    return flash._launch_packed(q, k, v, n_head, t_real)


@flash_attention_packed.register_fake
def _(q, k, v, n_head, t_real):
    return torch.empty_like(q, memory_format=torch.contiguous_format)
