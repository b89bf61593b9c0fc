"""Deployment artifacts: the whole greedy decode as one exported program.

Port of ``qasr_ijcnlp_tpu/export.py``.  :func:`export_greedy_decode`
traces raw audio (or a mel) -> log-mel -> encoder -> greedy token loop
(:func:`.decode.loop.greedy_decode_program`) with ``torch.export`` into one
``ExportedProgram`` that holds the weights as its buffers;
:func:`save_artifact` / :func:`load_artifact` wrap it in one
self-describing file (8-byte magic, u32 header length, JSON metadata, the
``torch.export.save`` payload).  A deployment host needs torch, not this
package's model code, checkpoints or tokenizer, to get token ids:
:func:`decode_artifact_tokens` is the post-processing (slice at
``sample_begin``, cut at ``eot``).

``with_kernels=False`` (the default, as in JAX) traces the plain versions
(``models.whisper.set_flash_attention(False)``, ``audio.set_fused_mel(
False)``, restored after): an explicit request for a program that runs
wherever torch runs, on the device it was exported for.
``with_kernels=True`` keeps the encoder-path kernels (K1-K8) in the
program as ``qasr::`` custom ops (:mod:`.ops.library`); it is for the card
only, and loading it needs those registrations (this module imports them)
and the same kernel sources and torch version, which the metadata records
and :func:`load_artifact` checks.  Neither form traces the int8 cross
attention (``kv_int8`` is refused, as in JAX) or the fused decoder step.

``quantize="int8"`` stores the large weights as per-channel int8 with f32
scales (:mod:`.models.quantize`, the JAX package's channels) and
dequantizes them inside the program at every call; its tokens equal the
decode of the dequantized weights, not the f32 model's.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import warnings
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

# The port's magic; the JAX package's artifacts start with _JAX_MAGIC.
_MAGIC = b"QASRT001"
_JAX_MAGIC = b"QASRX001"


def _holder(tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """A module holding ``tensors`` as buffers ("." in names becomes "__")."""
    m = nn.Module()
    for name, t in tensors.items():
        m.register_buffer(name.replace(".", "__"), t)
    return m


def _held(m: nn.Module) -> Dict[str, torch.Tensor]:
    return {k.replace("__", "."): v for k, v in m.named_buffers()}


def _view(sd: Dict[str, torch.Tensor], prefix: str):
    """The module tree under ``prefix`` as nested namespaces over the
    tensors of the flat state dict ``sd`` (numbered children as lists, a
    missing ``bias`` None, as ``nn.Linear(bias=False)``'s), so the model
    functions read a program's weights as they read modules."""
    root: dict = {}
    for name, t in sd.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            items = [None] * (max(int(k) for k in node) + 1)
            for k, v in node.items():
                items[int(k)] = build(v)
            return items
        if "weight" in node:
            node.setdefault("bias", None)
        return SimpleNamespace(**{k: build(v) for k, v in node.items()})

    return build(root)


class GreedyProgram(nn.Module):
    """The traced module: weights as buffers (fp, or int8 ``q`` and f32 ``s``
    plus the small fp entries), the prompt, and ``forward(x)`` -> (buf,
    cur_len, sum_logprobs, no_speech_probs)."""

    def __init__(self, state: Dict, cfg, initial_tokens: torch.Tensor, n_mels: int,
                 from_audio: bool):
        super().__init__()
        from .models.quantize import is_quantized

        self.cfg, self.n_mels, self.from_audio = cfg, n_mels, from_audio
        self.fp = _holder({k: v for k, v in state.items() if not is_quantized(v)})
        self.q = _holder({k: v["q"] for k, v in state.items() if is_quantized(v)})
        self.s = _holder({k: v["s"] for k, v in state.items() if is_quantized(v)})
        self.register_buffer("initial_tokens", initial_tokens)

    def weights(self) -> Dict[str, torch.Tensor]:
        """The f32 state dict, the int8 entries dequantized; the decoder
        blocks' Linear weights cast to the compute dtype once a call, as
        ``WhisperModel.decoder_for`` casts them once."""
        from .models.quantize import dequantize_params

        q, s = _held(self.q), _held(self.s)
        sd = {**_held(self.fp), **dequantize_params({k: {"q": q[k], "s": s[k]} for k in q})}
        dt = self.cfg.compute_dtype
        return {k: v.to(dt) if k.startswith("decoder.blocks.") and "_ln." not in k else v
                for k, v in sd.items()}

    def forward(self, x):
        from .audio import log_mel_spectrogram
        from .decode.loop import greedy_decode_program

        sd = self.weights()
        mel = log_mel_spectrogram(x, self.n_mels, device=None) if self.from_audio else x
        return greedy_decode_program(_view(sd, "encoder."), _view(sd, "decoder."), self.cfg,
                                     mel, self.initial_tokens)


def export_greedy_decode(
    model_obj,
    options=None,
    batch: int = 8,
    from_audio: bool = True,
    device: str = "cuda",
    quantize: Optional[str] = None,
    with_kernels: bool = False,
):
    """Trace the greedy decode to ``(torch.export.ExportedProgram, meta)``.

    ``from_audio``: the program takes (batch, 480000) float32 16 kHz audio
    and runs the mel frontend inside; otherwise a (batch, n_mels, 3000)
    mel.  ``device`` is where the program runs (the card unless the caller
    asks for the CPU); the compute dtype is resolved there as ``decode``
    resolves ``fp16`` (bfloat16 on the card, float32 on the CPU).
    ``meta`` holds what the deployment side needs to slice tokens out of
    the returned buffer."""
    from . import _kernels, audio as _audio
    from .audio import N_SAMPLES
    from .decode import DecodingOptions, DecodingTask, _compute_dtype
    from .decode.filters import _masks
    from .models import whisper as _whisper
    from .models.quantize import quantize_params
    from .ops import record_ops
    from .ops.melfront import _device_tables

    options = options or DecodingOptions(language="en", without_timestamps=True)
    if options.language is None:
        raise ValueError(
            "export needs a fixed language (the prompt is part of the program); "
            "pass DecodingOptions(language=...)")
    if options.temperature != 0 or options.beam_size or options.best_of:
        raise ValueError("export_greedy_decode is greedy-only")
    if options.kv_int8:
        raise ValueError(
            "export does not support kv_int8 (its kernel is not one of the program's "
            "qasr:: ops)")
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    dev = torch.empty(0, device=device).device  # "cuda" -> cuda:0
    if with_kernels and dev.type != "cuda":
        raise ValueError(
            "with_kernels=True artifacts hold the port's CUDA kernels (qasr:: ops) "
            "and run on the card only; pass device='cuda', or with_kernels=False")

    task = DecodingTask(model_obj, options)
    cfg = task.loop_cfg._replace(compute_dtype=_compute_dtype(options.fp16, dev))
    dims = model_obj.dims
    sd = {k: v.detach().contiguous() for k, v in model_obj.module.state_dict().items()}
    if quantize == "int8":
        state = {k: {n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev)
                 for k, v in quantize_params(sd, dims).items()}
    else:
        state = {k: v.to(dev) for k, v in sd.items()}
    init = torch.tensor(task.initial_tokens, dtype=torch.long, device=dev).repeat(batch, 1)
    program = GreedyProgram(state, cfg, init, dims.n_mels, from_audio).eval()
    shape = (batch, N_SAMPLES) if from_audio else (batch, dims.n_mels, 3000)
    example = torch.zeros(shape, device=dev)
    # Tables kept in lru_caches are made here, outside the trace: made
    # inside it, the caches would keep traced stand-ins for real tensors.
    _masks(cfg.filters, dev)
    _device_tables(dims.n_mels, dev)

    prev = _whisper._USE_FLASH, _audio._USE_FUSED_MEL
    try:
        if not with_kernels:
            _whisper.set_flash_attention(False)
            _audio.set_fused_mel(False)
        with torch.no_grad(), (record_ops() if with_kernels else contextlib.nullcontext()):
            exported = torch.export.export(program, (example,), strict=False)
    finally:
        _whisper.set_flash_attention(prev[0])
        _audio.set_fused_mel(prev[1])

    meta = {
        "model": getattr(model_obj, "name", "?"),
        "batch": batch,
        "from_audio": from_audio,
        "input_shape": list(shape),
        "sample_begin": task.sample_begin,
        "eot": int(task.tokenizer.eot),
        "language": options.language,
        "task": options.task,
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "compute_dtype": str(cfg.compute_dtype).replace("torch.", ""),
        "torch_version": torch.__version__,
        "quantize": quantize,
        "outputs": ["buf", "cur_len", "sum_logprobs", "no_speech_probs"],
        "with_kernels": with_kernels,
    }
    if with_kernels:
        # The ops launch the kernels built from this host's sources at load
        # time; load_artifact warns when they or torch differ.
        meta["kernels_source_hash"] = _kernels.source_hash()
    return exported, meta


def save_artifact(path: str, exported, meta: dict) -> None:
    """One self-describing file: magic, u32 header length, JSON metadata,
    the ``torch.export.save`` payload (weights included).  The program's
    node stack traces and its example input are dropped first (in place):
    the loop body's traces alone were 46 of tiny's 202 MB."""
    for module in exported.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                node.meta.pop("stack_trace", None)
    exported._example_inputs = None
    payload = io.BytesIO()
    torch.export.save(exported, payload)
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint32(len(head)).tobytes())
        f.write(head)
        f.write(payload.getbuffer())


def load_artifact(path: str):
    """Returns ``(call, meta)``: ``call(x)`` takes a tensor or numpy array
    of ``meta["input_shape"]`` and returns the program's four outputs on
    the device it was exported for (never another)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(
                f"{path} is a JAX export artifact (qasr_ijcnlp_tpu.export); load it with "
                "the JAX package, or export the model with this package")
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a qasr export artifact")
        n = int(np.frombuffer(f.read(4), np.uint32)[0])
        meta = json.loads(f.read(n).decode())
        payload = f.read()
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for the card, and torch sees no CUDA device")
    if meta.get("with_kernels"):
        from . import _kernels
        from .ops import library  # noqa: F401  (the qasr:: ops the program calls)

        here = (torch.__version__, _kernels.source_hash())
        there = (meta.get("torch_version"), meta.get("kernels_source_hash"))
        if here != there:
            warnings.warn(
                f"artifact {path} holds the port's CUDA kernels as qasr:: ops, exported "
                f"with torch {there[0]} and kernel sources {there[1]}, but this host runs "
                f"torch {here[0]} with kernel sources {here[1]}; custom ops carry no "
                "cross-version stability guarantee — re-export here or use a kernel-free "
                "artifact for portability", stacklevel=2)
    # The loop's unbacked sizes are reported one line each at load; quiet.
    serde = logging.getLogger("torch._export.serde.serialize")
    level = serde.level
    serde.setLevel(logging.ERROR)
    try:
        module = torch.export.load(io.BytesIO(payload)).module()
    finally:
        serde.setLevel(level)
    device = torch.device(meta["device"])

    def call(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
        with torch.no_grad():
            return module(x.to(device, torch.float32))

    return call, meta


def decode_artifact_tokens(buf, cur_len, meta: dict) -> Tuple[list, ...]:
    """Per-row token ids out of an artifact's ``buf`` output (the
    deployment side's post-processing; pair with any tiktoken-rank decoder
    for text).  Tensors or numpy arrays."""
    host = lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    buf, cur = host(buf), host(cur_len)
    sb, eot = meta["sample_begin"], meta["eot"]
    if cur.ndim == 0:  # the greedy loop's position counter is lockstep
        cur = np.full(buf.shape[0], int(cur))
    out = []
    for row, n in zip(buf, cur):
        s = row[sb: int(n)]
        hits = np.nonzero(s == eot)[0]
        out.append((s[: hits[0]] if hits.size else s).tolist())
    return tuple(out)
