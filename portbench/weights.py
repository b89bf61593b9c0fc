"""Weights and inputs made from ``--seed``, on the device, in few large calls.

The same seed gives the same weights and the same inputs on every run and
on every device type: each purpose draws from a ``torch.Generator`` of its
own, seeded from (seed, purpose), on the device the tensors live on.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.whisper import SAMPLE_RATE, sinusoids

# purposes of the derived generators
WEIGHTS, AUDIO, TOKENS, ORDER = range(4)


def derived_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed (any size)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), purpose]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def generator(seed: int, purpose: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(seed, purpose))
    return g


def dims_of(config: Dict) -> Dict[str, int]:
    """The port's ModelDimensions fields from a Hugging Face Whisper
    config; the feed-forward widths must be 4 d_model, as the port builds
    them."""
    d = config["d_model"]
    for key in ("encoder_ffn_dim", "decoder_ffn_dim"):
        if config[key] != 4 * d:
            raise ValueError(f"{key} {config[key]} is not 4 x d_model {d}")
    return {
        "n_mels": config["num_mel_bins"], "n_audio_ctx": config["max_source_positions"],
        "n_audio_state": d, "n_audio_head": config["encoder_attention_heads"],
        "n_audio_layer": config["encoder_layers"], "n_vocab": config["vocab_size"],
        "n_text_ctx": config["max_target_positions"], "n_text_state": d,
        "n_text_head": config["decoder_attention_heads"],
        "n_text_layer": config["decoder_layers"],
    }


def _layout(dims: Dict[str, int]) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every tensor of the OpenAI state dict.
    kind "u": U(-scale, scale) (nn.Linear and Conv1d: 1 / sqrt(fan_in));
    "g": 1 + U(-scale, scale) (LayerNorm gains); "n": N(0, scale^2);
    "s": the sinusoidal positions."""
    out = []
    D, Dt = dims["n_audio_state"], dims["n_text_state"]

    def lin(p, d_in, d_out, bias=True):
        out.append((p + ".weight", (d_out, d_in), "u", 1 / math.sqrt(d_in)))
        if bias:
            out.append((p + ".bias", (d_out,), "u", 1 / math.sqrt(d_in)))

    def ln(p, d):
        out.append((p + ".weight", (d,), "g", 0.1))
        out.append((p + ".bias", (d,), "u", 0.05))

    def block(p, d, cross):
        for a in ("attn", "cross_attn") if cross else ("attn",):
            lin(f"{p}.{a}.query", d, d)
            lin(f"{p}.{a}.key", d, d, bias=False)
            lin(f"{p}.{a}.value", d, d)
            lin(f"{p}.{a}.out", d, d)
            ln(f"{p}.{a}_ln", d)
        lin(f"{p}.mlp.0", d, 4 * d)
        lin(f"{p}.mlp.2", 4 * d, d)
        ln(f"{p}.mlp_ln", d)

    for name, c_in in (("conv1", dims["n_mels"]), ("conv2", D)):
        out.append((f"encoder.{name}.weight", (D, c_in, 3), "u", 1 / math.sqrt(3 * c_in)))
        out.append((f"encoder.{name}.bias", (D,), "u", 1 / math.sqrt(3 * c_in)))
    out.append(("encoder.positional_embedding", (dims["n_audio_ctx"], D), "s", 0.0))
    for i in range(dims["n_audio_layer"]):
        block(f"encoder.blocks.{i}", D, False)
    ln("encoder.ln_post", D)
    out.append(("decoder.token_embedding.weight", (dims["n_vocab"], Dt), "n", 0.02))
    out.append(("decoder.positional_embedding", (dims["n_text_ctx"], Dt), "n", 0.01))
    for i in range(dims["n_text_layer"]):
        block(f"decoder.blocks.{i}", Dt, True)
    ln("decoder.ln", Dt)
    return out


@torch.no_grad()
def make_weights(dims: Dict[str, int], seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 state dict (OpenAI names) of a Whisper at ``dims``: one
    uniform and one normal draw for all tensors, cut into views and scaled
    in place."""
    layout = _layout(dims)
    g = generator(seed, WEIGHTS, device)
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in layout if kind in k) for k in ("ug", "n")}
    uni = torch.rand(sizes["ug"], generator=g, device=device).mul_(2).sub_(1)
    nor = torch.randn(sizes["n"], generator=g, device=device)
    at = {"ug": 0, "n": 0}
    sd = {}
    for name, shape, kind, scale in layout:
        if kind == "s":
            sd[name] = sinusoids(*shape).to(device)
            continue
        pool = "n" if kind == "n" else "ug"
        n = math.prod(shape)
        t = (nor if pool == "n" else uni)[at[pool]:at[pool] + n].view(shape)
        at[pool] += n
        t.mul_(scale)
        if kind == "g":
            t.add_(1.0)
        sd[name] = t
    return sd


@torch.no_grad()
def make_pcm(n: int, samples: int, seed: int, device, purpose: int = AUDIO) -> np.ndarray:
    """(n, samples) float32 host PCM at 16 kHz, speech-like and different in
    every clip, made on the device: a voiced source (24 harmonics of an f0 of
    90-240 Hz with vibrato, a random spectral tilt) and a noise source, each
    under its own on/off envelope of 50-ms steps, a random gain, and a
    background noise floor of random level."""
    g = generator(seed, purpose, device)

    def uniform(*shape):
        return torch.rand(*shape, generator=g, device=device)

    t = torch.arange(samples, device=device, dtype=torch.float32) / SAMPLE_RATE
    n_steps = samples // 800 + 2

    def envelope(off: float):
        e = ((uniform(n, n_steps) - off) / (1 - off)).clamp_min(0)
        return torch.nn.functional.interpolate(e[:, None], size=samples, mode="linear",
                                               align_corners=False)[:, 0]

    f0 = uniform(n, 1) * 150 + 90
    vibrato = 1 + 0.05 * torch.sin(2 * math.pi * (uniform(n, 1) * 4 + 1) * t)
    phase = 2 * math.pi * torch.cumsum(f0 * vibrato / SAMPLE_RATE, dim=1)
    tilt = uniform(n, 1) * 1.5 + 0.5
    voiced = torch.zeros(n, samples, device=device)
    for k in range(1, 25):
        voiced += torch.sin(k * phase) / k ** tilt
    voiced *= envelope(0.35)
    noise = torch.randn(n, samples, generator=g, device=device) * envelope(0.7) * 0.3
    gain = 10 ** (uniform(n, 1) - 1.3)
    floor = torch.randn(n, samples, generator=g, device=device) * 10 ** (uniform(n, 1) * 1.5 - 3.5)
    return ((voiced + noise) * gain + floor).clamp(-1, 1).cpu().numpy()


def permutation(n: int, seed: int, purpose: int = ORDER) -> np.ndarray:
    """A seeded order of ``n`` items (host)."""
    return np.random.default_rng(derived_seed(seed, purpose)).permutation(n)


def pick_checked(sizes, n: int, seed: int, purpose: int = 7):
    """``n`` indices of items whose sizes are ``sizes``, drawn from the seed:
    the largest first (the first of them in the seeded order), then the
    others in the seeded order."""
    order = list(np.random.default_rng(derived_seed(seed, purpose)).permutation(len(sizes)))
    first = max(order, key=lambda i: sizes[i])
    return [first] + [i for i in order if i != first][:n - 1]
