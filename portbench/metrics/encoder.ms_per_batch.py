"""Device ms of ``WhisperModel.embed_audio`` on one batch's mel in the
decode's dtype (stem and trunk), CUDA events, mean of 3.  Reads
``encoder.ms_per_batch`` and its splits."""


def read(run):
    return run.profile.get("encoder_ms")
