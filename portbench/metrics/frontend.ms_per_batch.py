"""Device ms of the benchmark's own ``log_mel_spectrogram`` call on one
batch (host PCM, its copy to the card and K1), CUDA events, mean of 3.  Reads
``frontend.ms_per_batch`` and its splits."""


def read(run):
    return run.profile.get("frontend_ms")
