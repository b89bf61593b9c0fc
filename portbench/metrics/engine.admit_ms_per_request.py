"""Device-stream ms of the engine's admission stage (``stage_seconds``:
K1 on the wire audio, encoder, prompt pass, scatter) per request admitted
in the window."""


def read(run):
    w = run.window
    return 1000.0 * w["admit_s"] / w["admitted"] if w["admitted"] else None
