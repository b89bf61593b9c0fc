"""Device kernels launched in the traced batch per decoder token step
(``sample_len`` steps a batch, each one token for every row)."""


def read(run):
    trace = run.profile.get("trace")
    if trace is None:
        return None
    return trace["launches"] / run.profile["token_steps"]
