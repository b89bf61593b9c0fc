"""Whisper written out from the published architecture in plain PyTorch.

The yardstick that decides ``correct``: it imports no code of the program
and takes none of its tables.  Each function reads a flat state dict with
the OpenAI names (``encoder.blocks.0.attn.query.weight`` ...) and computes
in float32 with TF32 off (:func:`exact_fp32`).  Departures from the
published model: none in the arithmetic; the mel filterbank is the Slaney
one librosa builds, written out here.

``Precision`` chooses the compute dtype: ``"fp32"`` rounds nothing;
``"fp8"`` rounds to float8 e4m3 wherever the program's policy rounds to its
compute dtype (bfloat16): the weights and activations entering every matrix
product, every product's output, the residual stream, LayerNorm, GELU and
softmax outputs (each computed in float32 first), each row scaled to the
e4m3 range by its own largest magnitude.  It is the control of one
precision below the bfloat16 that the decode and the training step compute
in.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP_LENGTH
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Precision:
    """The compute dtype of the reference: "fp32" or "fp8"."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the product sees it: each row along the last dim scaled
        to the e4m3 range by its own largest magnitude and rounded (fp8)."""
        if self.name == "fp32":
            return t
        with torch.no_grad():
            scale = t.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
            q = (t / scale).to(torch.float8_e4m3fn).float() * scale
        # the backward passes straight through the rounding
        return q if not t.requires_grad else t + (q - t).detach()

    def linear(self, x, w, b=None):
        y = self.round(x) @ self.round(w).t()
        return self.round(y if b is None else y + b)

    def conv1d(self, x, w, b, stride):
        # rows of the input are its channels at one time step
        xr = self.round(x.transpose(1, 2)).transpose(1, 2)
        wr = self.round(w.reshape(w.shape[0], -1)).reshape(w.shape)
        y = F.conv1d(xr, wr, b, stride=stride, padding=1)
        return self.round(y.transpose(1, 2)).transpose(1, 2)


FP32 = Precision("fp32")


# -- audio --------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filterbank(n_mels: int) -> np.ndarray:
    """The Slaney-normalized triangular filterbank (n_mels, 201) for 16 kHz
    and a 400-point FFT (librosa.filters.mel's defaults)."""
    fft_hz = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    weights = np.zeros((n_mels, fft_hz.size))
    for i in range(n_mels):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        rise = (fft_hz - lo) / (mid - lo)
        fall = (hi - fft_hz) / (hi - mid)
        weights[i] = np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return weights.astype(np.float32)


def log_mel(pcm: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, N_SAMPLES) float32 PCM -> (B, n_mels, N_FRAMES) log-mel, each
    clip clamped to its own maximum less 8 (OpenAI's log_mel_spectrogram)."""
    window = torch.hann_window(N_FFT, device=pcm.device)
    stft = torch.stft(pcm, N_FFT, HOP_LENGTH, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filterbank(n_mels)).to(pcm.device)
    spec = torch.clamp(filters @ power, min=1e-10).log10()
    spec = torch.maximum(spec, spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (spec + 4.0) / 4.0


def pad_to_30s(pcm: np.ndarray) -> np.ndarray:
    """Zero-pad (or cut) clips to 30 s along the last axis."""
    n = pcm.shape[-1]
    if n >= N_SAMPLES:
        return pcm[..., :N_SAMPLES]
    return np.pad(pcm, [(0, 0)] * (pcm.ndim - 1) + [(0, N_SAMPLES - n)])


def wire_int16(pcm: np.ndarray):
    """A clip as the decode engine's contract carries it: padded to 30 s,
    quantized to int16 against its own peak (truncating), and back to
    float32: what the engine's frontend sees."""
    audio = pad_to_30s(np.asarray(pcm, np.float32))
    peak = float(max(np.max(np.abs(audio)), 1e-9))
    codes = (audio * (32767.0 / peak)).astype(np.int16)
    return codes.astype(np.float32) * np.float32(peak / 32767.0)


# -- the model ----------------------------------------------------------------------

def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def _ln(x, w, p, prec):
    return prec.round(F.layer_norm(x, (x.shape[-1],), w[p + ".weight"], w[p + ".bias"], 1e-5))


def _heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _attention(w, p, x, kv, n_head, prec, mask=None):
    """OpenAI MultiHeadAttention: q and k each scaled by dh^-0.25."""
    d = x.shape[-1]
    scale = (d // n_head) ** -0.25
    q = prec.linear(x, w[p + ".query.weight"], w[p + ".query.bias"])
    k = prec.linear(kv, w[p + ".key.weight"])
    v = prec.linear(kv, w[p + ".value.weight"], w[p + ".value.bias"])
    qh, kh = prec.round(_heads(q, n_head) * scale), prec.round(_heads(k, n_head) * scale)
    qk = prec.round(qh @ kh.transpose(-1, -2))
    if mask is not None:
        qk = qk + mask
    out = prec.round(prec.round(torch.softmax(qk, dim=-1)) @ _heads(v, n_head))
    out = out.transpose(1, 2).reshape(x.shape)
    return prec.linear(out, w[p + ".out.weight"], w[p + ".out.bias"])


def _mlp(w, p, x, prec):
    h = prec.round(F.gelu(prec.linear(x, w[p + ".mlp.0.weight"], w[p + ".mlp.0.bias"])))
    return prec.linear(h, w[p + ".mlp.2.weight"], w[p + ".mlp.2.bias"])


def encoder(w: Dict[str, torch.Tensor], mel: torch.Tensor, dims: Dict,
            prec: Precision = FP32) -> torch.Tensor:
    """(B, n_mels, 3000) -> (B, 1500, D)."""
    H = dims["n_audio_head"]
    x = F.gelu(prec.conv1d(mel, w["encoder.conv1.weight"], w["encoder.conv1.bias"], 1))
    x = F.gelu(prec.conv1d(x, w["encoder.conv2.weight"], w["encoder.conv2.bias"], 2))
    x = prec.round(x.transpose(1, 2) + w["encoder.positional_embedding"])
    for i in range(dims["n_audio_layer"]):
        p = f"encoder.blocks.{i}"
        h = _ln(x, w, p + ".attn_ln", prec)
        x = prec.round(x + _attention(w, p + ".attn", h, h, H, prec))
        x = prec.round(x + _mlp(w, p, _ln(x, w, p + ".mlp_ln", prec), prec))
    return _ln(x, w, "encoder.ln_post", prec)


def decoder(w: Dict[str, torch.Tensor], tokens: torch.Tensor, xa: torch.Tensor, dims: Dict,
            prec: Precision = FP32) -> torch.Tensor:
    """Teacher-forced logits (B, T, V) of tokens (B, T) over the encoder
    output xa (B, 1500, D)."""
    H = dims["n_text_head"]
    T = tokens.shape[1]
    emb = w["decoder.token_embedding.weight"]
    x = prec.round(emb[tokens] + w["decoder.positional_embedding"][:T])
    causal = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    for i in range(dims["n_text_layer"]):
        p = f"decoder.blocks.{i}"
        h = _ln(x, w, p + ".attn_ln", prec)
        x = prec.round(x + _attention(w, p + ".attn", h, h, H, prec, causal))
        h = _ln(x, w, p + ".cross_attn_ln", prec)
        x = prec.round(x + _attention(w, p + ".cross_attn", h, xa, H, prec))
        x = prec.round(x + _mlp(w, p, _ln(x, w, p + ".mlp_ln", prec), prec))
    return prec.linear(_ln(x, w, "decoder.ln", prec), emb)


# -- the tokenizer's special ids ---------------------------------------------------------

def special_tokens(n_vocab: int) -> Dict[str, int]:
    """The multilingual Whisper vocabulary's special tokens: eot and sot
    after the 50,257 text tokens, then one token per language (99, or 100
    from large-v3's vocabulary of 51,866 on), then the task and timestamp
    tokens."""
    n_lang = n_vocab - 51765 - 1
    eot = 50257
    after = eot + 2 + n_lang
    names = ("translate", "transcribe", "startoflm", "startofprev", "nospeech",
             "notimestamps")
    out = {"eot": eot, "sot": eot + 1, "en": eot + 2}
    out.update({n: after + i for i, n in enumerate(names)})
    out["timestamp_begin"] = after + len(names)
    return out


def prompt_tokens(n_vocab: int):
    """sot, en, transcribe, notimestamps: English transcription without
    timestamps."""
    s = special_tokens(n_vocab)
    return [s["sot"], s["en"], s["transcribe"], s["notimestamps"]]


def suppressed_tokens(n_vocab: int):
    """What the decode may never emit with ``suppress_tokens=[eot]``: eot,
    and always the task, start and no-speech tokens."""
    s = special_tokens(n_vocab)
    return sorted({s["eot"], s["sot"], s["translate"], s["transcribe"], s["startoflm"],
                   s["startofprev"], s["nospeech"]})


def served_token_gap(logits: torch.Tensor, served: torch.Tensor, n_vocab: int) -> torch.Tensor:
    """Per position, how far below the reference's best allowed logit the
    served token's logit lies: (T, V) logits at the positions that chose
    ``served`` (T,).  A suppressed served token reads infinity."""
    allowed = torch.ones(n_vocab, dtype=torch.bool, device=logits.device)
    allowed[suppressed_tokens(n_vocab)] = False
    masked = logits.float().masked_fill(~allowed, float("-inf"))
    best = masked.amax(-1)
    got = masked.gather(1, served[:, None].long())[:, 0]
    return best - got


def clip_frames(samples: int) -> int:
    """The encoder frames (20 ms each, at most 1500) that hold a clip of
    ``samples`` samples."""
    return min(N_FRAMES // 2, -(-samples // (2 * HOP_LENGTH)))


def cross_keys(w: Dict[str, torch.Tensor], dims: Dict, xa: torch.Tensor, layer: int,
               prec: Precision = FP32) -> torch.Tensor:
    """Decoder layer ``layer``'s cross-attention keys of one encoder output
    xa (1500, D), head-split and scaled by Dh^-0.25: (H, 1500, Dh)."""
    H = dims["n_text_head"]
    k = prec.linear(xa[None], w[f"decoder.blocks.{layer}.cross_attn.key.weight"])
    return prec.round(_heads(k, H)[0] * (k.shape[-1] // H) ** -0.25)


def _kept_err(w, dims, feats, xa, n: int, prec: Precision):
    """(name, relative distance) of what the program kept of one clip from
    the reference's, over the first ``n`` frames."""
    def rel(a, b):
        return float(torch.linalg.vector_norm(a.float() - b) / torch.linalg.vector_norm(b))

    if torch.is_tensor(feats):
        return "encoder_rel_err", rel(feats.to(xa.device)[:n], xa[:n])
    return "cross_k_rel_err", max(
        rel(k.to(xa.device)[:, :n], cross_keys(w, dims, xa, i, prec)[:, :n])
        for i, k in feats.items())


def served_numbers(w: Dict[str, torch.Tensor], dims: Dict, items, device,
                   control: Optional[Precision] = None) -> Dict:
    """The reference's judgement of served rows.  ``items`` is a list of
    (float32 PCM of one clip, the tokens served for it, the average log
    probability served with them, what the program kept of its audio or
    None).  What was kept is its encoder output (1500, D), or a dict of
    cross-attention keys {decoder layer: (H, 1500, Dh)} as the decode cache
    holds them (scaled by Dh^-0.25).  For each row the reference computes,
    teacher-forced on the prompt and the served tokens, the logits at every
    served position (suppressed tokens masked).  Returned:

    * ``served_gap_max``: the widest gap by which a served token's logit
      lies below the reference's best at its position;
    * ``avg_logprob_gap``: the widest difference, over the rows, between
      the served average log probability and the reference's (the served
      tokens' log-softmax summed and divided by their count plus one, as
      Whisper reports it);
    * ``encoder_rel_err``, where rows carry their encoder output, and
      ``cross_k_rel_err``, where they carry cross keys: the widest relative
      distance (Frobenius) of what was kept from the reference's, over the
      frames that hold the clip's audio (:func:`clip_frames`), since the
      frames of the padding differ little from clip to clip.

    With ``control`` (a lower precision put in the program's place), the
    same numbers of the control: the gap of the token the control puts
    first at each position, the control's average log probability of the
    served tokens and its encoder output or keys, each against the float32
    reference.  One clip at a time, so it fits beside nothing else."""
    prompt = prompt_tokens(dims["n_vocab"])
    allowed = torch.ones(dims["n_vocab"], dtype=torch.bool, device=device)
    allowed[suppressed_tokens(dims["n_vocab"])] = False
    out = {"rows": 0, "tokens": 0, "flips": 0, "served_gap_max": 0.0, "avg_logprob_gap": 0.0}
    if control is not None:
        out.update(control_flips=0, control_served_gap_max=0.0, control_avg_logprob_gap=0.0)
    kept = {"encoder_rel_err" if torch.is_tensor(it[3]) else "cross_k_rel_err"
            for it in items if it[3] is not None}
    for name in kept:
        out[name] = 0.0
        if control is not None:
            out["control_" + name] = 0.0

    def avg_lp(logits, served):
        lp = torch.log_softmax(logits.masked_fill(~allowed, float("-inf")), -1)
        return float(lp.gather(1, served[:, None])[:, 0].sum()) / (len(served) + 1)

    with exact_fp32(), torch.no_grad():
        for pcm, toks, served_lp, feats in items:
            audio = torch.from_numpy(pad_to_30s(np.asarray(pcm, np.float32)[None])).to(device)
            mel = log_mel(audio, dims["n_mels"])
            seq = torch.tensor([prompt + [int(t) for t in toks]], device=device)
            served = seq[0, len(prompt):]
            pos = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
            xa = encoder(w, mel, dims)
            logits = decoder(w, seq, xa, dims)[0, pos]
            n = clip_frames(len(pcm))
            if feats is not None:
                name, err = _kept_err(w, dims, feats, xa[0], n, FP32)
                out[name] = max(out[name], err)
            gaps = served_token_gap(logits, served, dims["n_vocab"])
            ref_lp = avg_lp(logits, served)
            out["rows"] += 1
            out["tokens"] += len(toks)
            out["flips"] += int((gaps > 0).sum())
            out["served_gap_max"] = max(out["served_gap_max"], float(gaps.max()))
            out["avg_logprob_gap"] = max(out["avg_logprob_gap"], abs(served_lp - ref_lp))
            if control is not None:
                c_xa = encoder(w, mel, dims, control)
                c_logits = decoder(w, seq, c_xa, dims, control)[0, pos]
                if feats is not None:
                    c_feats = (c_xa[0] if torch.is_tensor(feats) else
                               {i: cross_keys(w, dims, c_xa[0], i, control) for i in feats})
                    name, err = _kept_err(w, dims, c_feats, xa[0], n, FP32)
                    out["control_" + name] = max(out["control_" + name], err)
                pick = c_logits.masked_fill(~allowed, float("-inf")).argmax(-1)
                c_gaps = served_token_gap(logits, pick, dims["n_vocab"])
                out["control_flips"] += int((c_gaps > 0).sum())
                out["control_served_gap_max"] = max(out["control_served_gap_max"],
                                                    float(c_gaps.max()))
                out["control_avg_logprob_gap"] = max(out["control_avg_logprob_gap"],
                                                     abs(avg_lp(c_logits, served) - ref_lp))
    return out
