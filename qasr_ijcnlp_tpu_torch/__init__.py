"""qasr_ijcnlp_tpu_torch: the PyTorch / CUDA port of qasr_ijcnlp_tpu.

The Whisper request path (PCM -> log-mel -> encoder -> greedy decode ->
text) for every family size, tiny to large-v3, in PyTorch, with the int8
cross cache (``kv_int8``) and the opt-in fused decoder step; long-form
transcription with word timings (``model.transcribe``, the
:mod:`.transcribe` module, ``python -m qasr_ijcnlp_tpu_torch.cli.
transcribe``), audio files and local checkpoints; the decode services
(speculative decoding with ``Draft``, the continuous-batching
``decode.engine.DecodeEngine``, the HTTP server ``serving`` and online
sessions ``streaming``); the source paper's model at inference (the
quantum Whisper encoder ``models.quantum``, the character-ASR heads
``models.asr``, the classifier, ``data``, ``metrics`` and the two
evaluation CLIs); and the JAX package's TPU kernels rewritten by hand for
Hopper (``csrc/``).  The package imports
torch and numpy and never JAX or the JAX package, which stays beside it as
the reference.
"""

__version__ = "0.1.0"

from .audio import (  # noqa: F401
    CHUNK_LENGTH,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
    mel_filters,
    pad_or_trim,
)
from .decode import (  # noqa: F401
    DecodingOptions, DecodingResult, Draft, decode, detect_language,
)
from .models.registry import (  # noqa: F401
    WhisperModel,
    available_models,
    load_model,
    save_model,
)
