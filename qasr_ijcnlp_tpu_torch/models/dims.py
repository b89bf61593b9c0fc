"""Model dimension configs for the Whisper family.

Field names match the reference ``ModelDimensions``
(OpenAI Whisper model.py) so that official checkpoint
dicts ``{"dims": ..., "model_state_dict": ...}`` round-trip unchanged.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: int(v) for k, v in d.items()})


def tiny_dims(multilingual: bool = True) -> ModelDimensions:
    """Official Whisper Tiny dims (OpenAI Whisper tiny)."""
    return ModelDimensions(
        n_mels=80,
        n_audio_ctx=1500,
        n_audio_state=384,
        n_audio_head=6,
        n_audio_layer=4,
        n_vocab=51865 if multilingual else 51864,
        n_text_ctx=448,
        n_text_state=384,
        n_text_head=6,
        n_text_layer=4,
    )


# The official family table (layer/width/head scaling of the released models).
_FAMILY = {
    "tiny": dict(n_audio_layer=4, n_text_layer=4, n_audio_state=384, n_head=6),
    "base": dict(n_audio_layer=6, n_text_layer=6, n_audio_state=512, n_head=8),
    "small": dict(n_audio_layer=12, n_text_layer=12, n_audio_state=768, n_head=12),
    "medium": dict(n_audio_layer=24, n_text_layer=24, n_audio_state=1024, n_head=16),
    "large": dict(n_audio_layer=32, n_text_layer=32, n_audio_state=1280, n_head=20),
}


def dims_for(name: str) -> ModelDimensions:
    """Dimensions for an official model name like 'tiny', 'base.en', 'large'."""
    multilingual = not name.endswith(".en")
    base = name.split(".")[0]
    # turbo first: 'large-v3-turbo' must not collapse to plain 'large'
    # (turbo = large-v3 encoder + a 4-layer decoder, registry.py:40-41)
    if base == "turbo" or base.endswith("turbo"):
        return ModelDimensions(
            n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
            n_audio_layer=32, n_vocab=51866, n_text_ctx=448, n_text_state=1280,
            n_text_head=20, n_text_layer=4,
        )
    if base.startswith("large"):
        base = "large"
    cfg = _FAMILY[base]
    # the bare 'large' alias resolves to the large-v3 checkpoint
    # (registry.py:39), which moved to 128 mel bins and vocab 51866
    n_mels = 128 if name in ("large-v3", "large") else 80
    n_vocab = 51866 if n_mels == 128 else (51865 if multilingual else 51864)
    return ModelDimensions(
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=cfg["n_audio_state"],
        n_audio_head=cfg["n_head"],
        n_audio_layer=cfg["n_audio_layer"],
        n_vocab=n_vocab,
        n_text_ctx=448,
        n_text_state=cfg["n_audio_state"],
        n_text_head=cfg["n_head"],
        n_text_layer=cfg["n_text_layer"],
    )
