"""Quantum Whisper: the hybrid quantum-classical conv stem on the encoder.

Port of ``qasr_ijcnlp_tpu/models/quantum.py``.  Each of the two stem
convolutions becomes

    unfold windows -> pre Linear -> quantum circuit <Z_i> -> post Linear

with the expectations from the closed-form simulator (``ops/qsim.py``): the
whole convolution is four products over (batch x positions).  Trainable
parameters per layer: ``pre``, ``post`` and the (n_qubits, 3) rotation
angles ``qweights``.  The transformer trunk is the classical encoder's
(``models.whisper.transformer_trunk``), so the trunk runs the same kernels
(K4 + K5/K6 up to D = 1024, the unfused block around K8 above).

The stem runs in f32 whatever the compute dtype, with exact-erf GELU, and
is cast to the compute dtype only after conv2, as in the JAX package; the
classical stem kernel (K2/K3) never runs for a quantum encoder.  A window
lists its taps fastest: feature c k + j is channel c at tap j (the JAX
code's order; its comment says channels, its reshape puts taps), so the
``pre`` weight's input columns are in that order.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Set, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gelu
from ..ops.qsim import quantum_expvals
from . import whisper as cmodel
from .dims import ModelDimensions
from .registry import WhisperModel

QUANTUM_LAYERS = ("qconv1", "qconv2")


def quantum_conv_spec(in_channels: int, kernel_size: int, n_qubits: int) -> int:
    """Effective qubit count: at most one qubit per window feature."""
    return min(n_qubits, in_channels * kernel_size)


class QuantumConv1d(nn.Module):
    """One hybrid layer's parameters: ``pre`` (C k -> nq), ``post`` (nq ->
    C_out) and ``qweights`` (nq, 3).  Stride and padding are the stem's
    architectural constants, passed to :func:`quantum_conv1d`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 n_qubits: int = 4):
        super().__init__()
        nq = quantum_conv_spec(in_channels, kernel_size, n_qubits)
        self.kernel_size = kernel_size
        self.pre = nn.Linear(in_channels * kernel_size, nq)
        self.post = nn.Linear(nq, out_channels)
        self.qweights = nn.Parameter(torch.empty(nq, 3))


def _conv_channels_last(layer: QuantumConv1d, x, kernel_size: int, stride: int,
                        padding: int):
    """The hybrid convolution on channels-last input: (B, L, C) -> (B,
    L_out, C_out).  ``unfold`` gives the (B, L_out, C, k) windows as a
    view; the reshape lays each out tap-fastest (feature c k + j)."""
    B, L, C = x.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding))
    windows = x.unfold(1, kernel_size, stride)  # (B, L_out, C, k), a view
    windows = windows.reshape(B, windows.shape[1], C * kernel_size)
    pre = F.linear(windows, layer.pre.weight, layer.pre.bias)  # (B, L_out, nq)
    q = quantum_expvals(pre, layer.qweights, layer.qweights.shape[0])
    return F.linear(q, layer.post.weight, layer.post.bias)


def quantum_conv1d(layer: QuantumConv1d, x, kernel_size: int, stride: int, padding: int):
    """Hybrid quantum conv forward: (B, C_in, L) -> (B, C_out, L_out), every
    output position of every item through the circuit in one batch."""
    return _conv_channels_last(layer, x.transpose(1, 2), kernel_size, stride,
                               padding).transpose(1, 2)


class QuantumAudioEncoder(nn.Module):
    """The audio encoder with the quantum stem: ``qconv1`` (k3, p1) and
    ``qconv2`` (k3, s2, p1) in place of ``conv1`` / ``conv2``; positions,
    blocks and ``ln_post`` as ``models.whisper.AudioEncoder``'s."""

    def __init__(self, n_mels: int, n_ctx: int, n_state: int, n_head: int, n_layer: int,
                 n_qubits: int = 4):
        super().__init__()
        self.qconv1 = QuantumConv1d(n_mels, n_state, 3, n_qubits)
        self.qconv2 = QuantumConv1d(n_state, n_state, 3, n_qubits)
        # a parameter, as in models.whisper.AudioEncoder (frozen by the mask)
        self.positional_embedding = nn.Parameter(
            torch.from_numpy(cmodel.sinusoids(n_ctx, n_state)))
        self.blocks = nn.ModuleList(
            cmodel.ResidualAttentionBlock(n_state, n_head) for _ in range(n_layer)
        )
        self.ln_post = nn.LayerNorm(n_state)


class QuantumWhisper(nn.Module):
    """``models.whisper.Whisper`` with a :class:`QuantumAudioEncoder`."""

    def __init__(self, dims: ModelDimensions, n_qubits: int = 4):
        super().__init__()
        self.dims = dims
        self.encoder = QuantumAudioEncoder(
            dims.n_mels, dims.n_audio_ctx, dims.n_audio_state, dims.n_audio_head,
            dims.n_audio_layer, n_qubits,
        )
        self.decoder = cmodel.TextDecoder(
            dims.n_vocab, dims.n_text_ctx, dims.n_text_state, dims.n_text_head,
            dims.n_text_layer,
        )


def quantum_stem(encoder: QuantumAudioEncoder, mel, compute_dtype=torch.float32):
    """The trunk's input: (B, n_mels, 2 T) -> (B, T, D) in the compute
    dtype.  Both hybrid convolutions and their GELUs in f32, then the cast
    and the positions."""
    x = mel.float().transpose(1, 2)
    x = gelu(_conv_channels_last(encoder.qconv1, x, 3, 1, 1))
    x = gelu(_conv_channels_last(encoder.qconv2, x, 3, 2, 1))
    x = x.to(compute_dtype)
    return x + encoder.positional_embedding.to(x.dtype)


def quantum_encoder_apply(encoder: QuantumAudioEncoder, mel, dims: ModelDimensions,
                          compute_dtype=torch.float32, mesh=None):
    """Audio encoder with the quantum stem: (B, n_mels, 2 n_audio_ctx) ->
    (B, n_audio_ctx, D).  The trunk pads to the tile length itself.  With
    ``mesh`` the quantum stem runs whole on each rank (its rows are this
    data rank's) and the trunk takes the mesh."""
    if mel.shape[-1] != 2 * dims.n_audio_ctx:
        raise ValueError(f"expected {2 * dims.n_audio_ctx} mel frames, got {mel.shape[-1]}")
    return cmodel.transformer_trunk(encoder, quantum_stem(encoder, mel, compute_dtype), dims,
                                    mesh=mesh)


class QuantumWhisperModel(WhisperModel):
    """A ``WhisperModel`` whose encoder stem is quantum; decode, transcribe,
    align and the decode engine take it unchanged (their encoder calls go
    through ``models.whisper.dispatch_encoder_apply``)."""

    @classmethod
    def from_state_dict(cls, state_dict: Dict[str, torch.Tensor], dims: ModelDimensions,
                        device: Union[str, torch.device] = "cuda", name: str = "custom",
                        compute_dtype="float32") -> "QuantumWhisperModel":
        """The model on ``device`` (the card unless the caller asks for the
        CPU); the qubit count is read from ``qconv1``'s angles."""
        n_qubits = state_dict["encoder.qconv1.qweights"].shape[0]
        with torch.device("meta"):
            module = QuantumWhisper(dims, n_qubits)
        module.load_state_dict(state_dict, strict=True, assign=True)
        module = module.to(device).eval().requires_grad_(False)
        return cls(dims, module, name=name, compute_dtype=compute_dtype)

    @property
    def n_qubits(self) -> int:
        return self.module.encoder.qconv1.qweights.shape[0]


def init_quantum_conv(generator: torch.Generator, in_channels: int, out_channels: int,
                      kernel_size: int = 3, n_qubits: int = 4,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """One hybrid layer's state dict with the JAX package's distributions:
    pre and post U(+-1/sqrt(fan_in)) for weights and biases, the angles
    N(0, 1); drawn on the CPU from ``generator``."""
    nq = quantum_conv_spec(in_channels, kernel_size, n_qubits)
    d_in = in_channels * kernel_size

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    b1, b2 = 1.0 / math.sqrt(d_in), 1.0 / math.sqrt(nq)
    return {
        f"{prefix}pre.weight": uniform((nq, d_in), b1),
        f"{prefix}pre.bias": uniform((nq,), b1),
        f"{prefix}post.weight": uniform((out_channels, nq), b2),
        f"{prefix}post.bias": uniform((out_channels,), b2),
        f"{prefix}qweights": torch.randn((nq, 3), generator=generator),
    }


def init_quantum_params(generator: torch.Generator, dims: ModelDimensions,
                        n_qubits: int = 4) -> Dict[str, torch.Tensor]:
    """Random-init state dict with a quantum stem (classical trunk and
    decoder from ``models.whisper.init_params``)."""
    sd = cmodel.init_params(generator, dims)
    for name in ("conv1", "conv2"):
        del sd[f"encoder.{name}.weight"], sd[f"encoder.{name}.bias"]
    sd.update(init_quantum_conv(generator, dims.n_mels, dims.n_audio_state, 3, n_qubits,
                                "encoder.qconv1."))
    sd.update(init_quantum_conv(generator, dims.n_audio_state, dims.n_audio_state, 3,
                                n_qubits, "encoder.qconv2."))
    return sd


def create_quantum_whisper_from_model(official: WhisperModel, n_qubits: int = 4,
                                      generator: Optional[torch.Generator] = None
                                      ) -> QuantumWhisperModel:
    """A quantum model from a classical one: its positions, blocks,
    ``ln_post`` and decoder copied, only the quantum stem random (seed 0
    unless ``generator`` is given); on the classical model's device."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    sd = init_quantum_params(generator, official.dims, n_qubits)
    for k, v in official.module.state_dict().items():
        if k.startswith(("encoder.positional_embedding", "encoder.blocks.",
                         "encoder.ln_post.", "decoder.")):
            sd[k] = v.detach().cpu()
    model = QuantumWhisperModel.from_state_dict(
        sd, official.dims, official.device, name=f"quantum-{official.name}",
        compute_dtype=official.compute_dtype)
    model.alignment_heads = official.alignment_heads
    return model


# "from_official" copies every matching pretrained weight; the conv stems
# have no quantum-shaped match, so it is the same function.
create_quantum_whisper_from_official = create_quantum_whisper_from_model


def create_quantum_whisper_tiny(n_qubits: int = 4, compute_dtype="float32",
                                device: Union[str, torch.device] = "cuda",
                                download_root: Optional[str] = None) -> QuantumWhisperModel:
    """Official tiny weights where a checkpoint is at hand (random
    otherwise), with a quantum stem; on ``device``, the card unless the
    caller asks for the CPU."""
    from .registry import load_model

    official = load_model("tiny", download_root=download_root, compute_dtype=compute_dtype,
                          init_if_missing=True, device=device)
    return create_quantum_whisper_from_model(official, n_qubits)


def trainable_mask(params: Union[nn.Module, Dict[str, torch.Tensor], Iterable[str]],
                   extra_names=("asr_head",), set_requires_grad: bool = False) -> Set[str]:
    """The names of the trainable parameters: those under a quantum layer
    (or a task head named in ``extra_names``); every other weight stays
    frozen.  ``params`` is a module or a state dict (or its names); with
    ``set_requires_grad`` a module's parameters get the flags to match."""
    marks = set(QUANTUM_LAYERS) | set(extra_names)
    if isinstance(params, nn.Module):
        names = [n for n, _ in params.named_parameters()]
    else:
        names = list(params.keys() if isinstance(params, dict) else params)
    mask = {n for n in names if marks & set(n.split("."))}
    if set_requires_grad:
        if not isinstance(params, nn.Module):
            raise TypeError("set_requires_grad needs a module")
        for n, p in params.named_parameters():
            p.requires_grad_(n in mask)
    return mask


def count_params(params: Union[nn.Module, Dict[str, torch.Tensor]]) -> int:
    """Elements over a module's parameters or a state dict's tensors."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(t.numel() for t in tensors)
