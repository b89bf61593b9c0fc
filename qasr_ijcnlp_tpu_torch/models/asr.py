"""Character-level ASR heads over the (quantum) Whisper encoder.

Port of ``qasr_ijcnlp_tpu/models/asr.py``, names kept:

* the MLP head (:func:`mlp_head_apply`) over the concatenated [audio
  embeddings ++ char embeddings + learned positions] sequence, with
  :func:`mlp_head_char_logits` returning exactly the rows that predict
  characters and :func:`mlp_greedy_decode` decoding it autoregressively;
* the LSTM character decoder (2 layers, 384 wide by default) with
  dot-product attention over the encoder frames, teacher-forced
  (:func:`lstm_teacher_forced`) and greedy (:func:`lstm_greedy_decode`).

Where JAX runs a ``lax.scan``, the port runs a plain loop of steps on the
tensors' device.  The heads compute in fp32 whatever the encoder's dtype
(the JAX products promote a bf16 encoder output against fp32 weights).
Dropout draws from an explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MAX_CHAR_POSITIONS = 1000  # the reference's char position table


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


def _init_linear_(lin: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """torch nn.Linear's default distribution, U(+-1/sqrt(fan_in)) for weight
    and bias, drawn from ``generator`` (the JAX package's ``_init_linear``)."""
    bound = 1.0 / math.sqrt(lin.in_features)
    _uniform_(lin.weight, bound, generator)
    _uniform_(lin.bias, bound, generator)
    return lin


def _linear(x, lin: nn.Linear):
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _lengths(out: torch.Tensor, end_id: int, max_len: int) -> torch.Tensor:
    """Each row's index of its first ``end_id``, else ``max_len``."""
    hit = out == end_id
    first = hit.int().argmax(-1)
    return torch.where(hit.any(-1), first, torch.full_like(first, max_len))


# ---------------------------------------------------------------------------
# The MLP head
# ---------------------------------------------------------------------------


class MLPHead(nn.Module):
    """``layers`` (enc_dim -> hidden, then hidden -> hidden), ``out``
    (hidden -> num_chars), ``char_emb`` (num_chars, hidden) and ``pos``
    (MAX_CHAR_POSITIONS, hidden)."""

    def __init__(self, enc_dim: int, num_chars: int, hidden_size: int = 384,
                 num_layers: int = 2):
        super().__init__()
        dims = [enc_dim] + [hidden_size] * num_layers
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        self.out = nn.Linear(hidden_size, num_chars)
        self.char_emb = nn.Parameter(torch.empty(num_chars, hidden_size))
        self.pos = nn.Parameter(torch.empty(MAX_CHAR_POSITIONS, hidden_size))


def init_mlp_head(generator: torch.Generator, enc_dim: int, num_chars: int,
                  hidden_size: int = 384, num_layers: int = 2) -> MLPHead:
    """The head on the CPU with the JAX package's distributions: Linears
    as torch's default, char embeddings N(0, 0.02^2), positions N(0, 1)."""
    head = MLPHead(enc_dim, num_chars, hidden_size, num_layers)
    for lin in (*head.layers, head.out):
        _init_linear_(lin, generator)
    with torch.no_grad():
        head.char_emb.copy_(torch.randn(head.char_emb.shape, generator=generator) * 0.02)
        head.pos.copy_(torch.randn(head.pos.shape, generator=generator))
    return head


def _mlp(head: MLPHead, x, generator=None, dropout_rate: float = 0.1):
    for layer in head.layers:
        x = torch.relu(_linear(x, layer))
        if generator is not None and dropout_rate > 0:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - dropout_rate
            x = torch.where(keep, x / (1 - dropout_rate), torch.zeros_like(x))
    return _linear(x, head.out)


def mlp_head_apply(head: MLPHead, audio_emb, char_ids, *,
                   generator: Optional[torch.Generator] = None,
                   dropout_rate: float = 0.1):
    """Logits over the full [audio ++ chars] sequence, (B, Ta + T,
    num_chars); dropout after each hidden layer when ``generator`` is
    given."""
    T = char_ids.shape[1]
    char_emb = head.char_emb[char_ids] + head.pos[:T]
    dtype = torch.promote_types(audio_emb.dtype, char_emb.dtype)
    x = torch.cat([audio_emb.to(dtype), char_emb.to(dtype)], dim=1)
    return _mlp(head, x, generator, dropout_rate)


def mlp_head_char_logits(head: MLPHead, audio_emb, char_ids, *,
                         generator: Optional[torch.Generator] = None,
                         dropout_rate: float = 0.1):
    """Rows predicting chars 1..T-1: logits (B, T-1, C) for next-char CE.

    The head is per position, so those rows see only their own char
    embedding and position: only they are computed (the audio rows' logits
    would be dropped)."""
    T = char_ids.shape[1]
    x = head.char_emb[char_ids[:, :T - 1]] + head.pos[:T - 1]
    return _mlp(head, x.to(torch.promote_types(audio_emb.dtype, x.dtype)), generator,
                dropout_rate)


def mlp_greedy_decode(head: MLPHead, audio_emb, start_id: int, end_id: int,
                      max_len: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive greedy decode of the MLP head: each step feeds the
    previous prediction back in.  Returns (char_ids (B, max_len), lengths
    (B,)) like :func:`lstm_greedy_decode`.  ``audio_emb`` gives the batch
    size and device; the head's char rows never see it (the reference's
    design)."""
    B, dev = audio_emb.shape[0], audio_emb.device
    prev = torch.full((B,), start_id, dtype=torch.long, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out = []
    for pos in range(max_len):
        x = head.char_emb[prev] + head.pos[pos]
        nxt = _mlp(head, x).argmax(-1)
        nxt = torch.where(finished, torch.full_like(nxt, end_id), nxt)
        finished = finished | (nxt == end_id)
        out.append(nxt)
        prev = nxt
    out = torch.stack(out, dim=1)
    return out, _lengths(out, end_id, max_len)


# ---------------------------------------------------------------------------
# The LSTM character decoder with attention
# ---------------------------------------------------------------------------


class LSTMCell(nn.Module):
    def __init__(self, d_in: int, hidden_size: int):
        super().__init__()
        self.wx = nn.Linear(d_in, 4 * hidden_size)
        self.wh = nn.Linear(hidden_size, 4 * hidden_size)


class LSTMDecoder(nn.Module):
    """``cells`` (layer 0 takes [char embedding ++ context]), ``char_emb``,
    ``attn_q`` (hidden -> enc_dim), ``init`` (enc_dim -> 2 layers hidden:
    each layer's h and c) and ``out`` ([h ++ context] -> num_chars)."""

    def __init__(self, enc_dim: int, num_chars: int, hidden_size: int = 384,
                 num_layers: int = 2):
        super().__init__()
        self.cells = nn.ModuleList(
            LSTMCell(hidden_size + enc_dim if i == 0 else hidden_size, hidden_size)
            for i in range(num_layers))
        self.char_emb = nn.Parameter(torch.empty(num_chars, hidden_size))
        self.attn_q = nn.Linear(hidden_size, enc_dim)
        self.init = nn.Linear(enc_dim, 2 * num_layers * hidden_size)
        self.out = nn.Linear(hidden_size + enc_dim, num_chars)


def init_lstm_decoder(generator: torch.Generator, enc_dim: int, num_chars: int,
                      hidden_size: int = 384, num_layers: int = 2) -> LSTMDecoder:
    """The decoder on the CPU with the JAX package's distributions."""
    dec = LSTMDecoder(enc_dim, num_chars, hidden_size, num_layers)
    for cell in dec.cells:
        _init_linear_(cell.wx, generator)
        _init_linear_(cell.wh, generator)
    with torch.no_grad():
        dec.char_emb.copy_(torch.randn(dec.char_emb.shape, generator=generator) * 0.02)
    for lin in (dec.attn_q, dec.init, dec.out):
        _init_linear_(lin, generator)
    return dec


def _lstm_cell(cell: LSTMCell, x, h, c):
    gates = _linear(x, cell.wx) + _linear(h, cell.wh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _attend(dec: LSTMDecoder, h_top, enc):
    """Dot-product attention of the top layer's state over the frames,
    scaled by 1/sqrt(D)."""
    q = _linear(h_top, dec.attn_q)  # (B, D)
    scores = (enc @ q[:, :, None])[..., 0] / math.sqrt(enc.shape[-1])  # (B, Ta)
    w = torch.softmax(scores, dim=-1)
    return (w[:, None, :] @ enc)[:, 0]  # (B, D)


def _init_lstm_state(dec: LSTMDecoder, enc, num_layers: int, hidden: int):
    """Initial (h, c), each (B, L, H), from the mean-pooled frames."""
    hc = torch.tanh(_linear(enc.mean(dim=1), dec.init))
    hc = hc.reshape(enc.shape[0], num_layers, 2, hidden)
    return hc[:, :, 0], hc[:, :, 1]


def _decoder_step(dec: LSTMDecoder, enc, prev_char, h, c):
    """One step: (logits (B, C), h, c)."""
    num_layers = h.shape[1]
    ctx = _attend(dec, h[:, -1], enc)
    x = torch.cat([dec.char_emb[prev_char], ctx], dim=-1)
    hs, cs = [], []
    for layer in range(num_layers):
        hl, cl = _lstm_cell(dec.cells[layer], x, h[:, layer], c[:, layer])
        hs.append(hl)
        cs.append(cl)
        x = hl
    h = torch.stack(hs, dim=1)
    c = torch.stack(cs, dim=1)
    ctx2 = _attend(dec, h[:, -1], enc)
    logits = _linear(torch.cat([h[:, -1], ctx2], dim=-1), dec.out)
    return logits, h, c


def _start(dec: LSTMDecoder, enc):
    enc = enc.float()
    h, c = _init_lstm_state(dec, enc, len(dec.cells), dec.char_emb.shape[1])
    return enc, h, c


def lstm_teacher_forced(dec: LSTMDecoder, enc, char_ids):
    """Teacher-forced logits: position t predicts char_ids[:, t+1].

    enc (B, Ta, D), char_ids (B, T) -> (B, T-1, num_chars)."""
    enc, h, c = _start(dec, enc)
    logits = []
    for t in range(char_ids.shape[1] - 1):
        step, h, c = _decoder_step(dec, enc, char_ids[:, t], h, c)
        logits.append(step)
    return torch.stack(logits, dim=1)


def lstm_greedy_decode(dec: LSTMDecoder, enc, start_id: int, end_id: int,
                       max_len: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy char generation: (char_ids (B, max_len), lengths (B,)); a row
    that has emitted ``end_id`` emits it from then on."""
    enc, h, c = _start(dec, enc)
    B = enc.shape[0]
    prev = torch.full((B,), start_id, dtype=torch.long, device=enc.device)
    finished = torch.zeros(B, dtype=torch.bool, device=enc.device)
    out = []
    for _ in range(max_len):
        logits, h, c = _decoder_step(dec, enc, prev, h, c)
        nxt = logits.argmax(-1)
        nxt = torch.where(finished, torch.full_like(nxt, end_id), nxt)
        finished = finished | (nxt == end_id)
        out.append(nxt)
        prev = nxt
    out = torch.stack(out, dim=1)
    return out, _lengths(out, end_id, max_len)
