"""Device-stream ms of the engine's step stage (``stage_seconds``) per
decoder step of the pool in the window (step calls x ``unroll``)."""


def read(run):
    w = run.window
    steps = w["step_calls"] * w["unroll"]
    return 1000.0 * w["step_s"] / steps if steps else None
