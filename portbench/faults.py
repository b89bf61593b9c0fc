"""Faults planted under the timed path, each of which the check must see:
``patch(obj, attr, value)`` (``setattr``, or pytest's ``monkeypatch.setattr``)
is how a fault replaces a function of the program for the rest of the run.
``portbench.calibrate --fault NAME`` plants one on the card at a cell's own
size; ``portbench/tests/test_portbench_faults.py`` plants each on the CPU at
the small size.  The benchmark's own runs never import this."""

from __future__ import annotations


def alter_decode_tokens(patch):
    """A token altered where the batch decode produces it."""
    from .drivers import batch

    real = batch.port.decode

    def decode(*a, **k):
        out = real(*a, **k)
        for r in out:
            r.tokens[0] = (r.tokens[0] + 1000) % 50000
        return out

    patch(batch.port, "decode", decode)


def half_batch_decode(patch):
    """The decode works on the first half of the rows and answers the rest
    with them."""
    from .drivers import batch

    real = batch.port.decode

    def decode(model, mel, options):
        half = real(model, mel[:mel.shape[0] // 2], options)
        return half + half

    patch(batch.port, "decode", decode)


def batch_row_swap(patch):
    """Every row of a batch answered with its neighbour's result (tokens,
    log probability and encoder output): rows mixed up after the decode."""
    from .drivers import batch

    real = batch.port.decode

    def decode(*a, **k):
        out = real(*a, **k)
        return out[1:] + out[:1]

    patch(batch.port, "decode", decode)


def self_cache_unchanged(patch):
    """Every decoder step leaves the self-attention cache as it found it."""
    from qasr_ijcnlp_tpu_torch.models import whisper

    patch(whisper, "_write_self_kv", lambda buf, new, offset: None)


def alter_engine_tokens(patch):
    """A token altered where the engine assembles a result."""
    from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine

    real = DecodeEngine._result

    def result(self, ids, *a):
        return real(self, [(ids[0] + 1000) % 50000] + list(ids[1:]), *a)

    patch(DecodeEngine, "_result", result)


def engine_slot_swap(patch):
    """Admission writes each request into the slot after the one it was
    given (off by one): a request is answered from a slot that holds
    another request's audio."""
    from qasr_ijcnlp_tpu_torch.decode import engine

    real = engine._engine_admit

    def admit(model_obj, decoder, cross_decoder, cfg, state, ids, *a, **k):
        ids = (ids + 1) % state.buf.shape[0]
        return real(model_obj, decoder, cross_decoder, cfg, state, ids, *a, **k)

    patch(engine, "_engine_admit", admit)


def engine_k1_shifted(patch):
    """Admission's K1 output displaced by one second (100 mel frames) along
    time, as a framing fault of the frontend would leave it."""
    from qasr_ijcnlp_tpu_torch.decode import engine

    real = engine.wire_log_mel

    def wire_log_mel(*a, **k):
        return real(*a, **k).roll(100, dims=-1)

    patch(engine, "wire_log_mel", wire_log_mel)


def step_unchanged(patch):
    """A train step that returns its state unchanged."""
    import torch

    from .drivers import train

    def make_train_step(loss_fn, tx, skip_nonfinite=True):
        def step(state, *batch):
            loss = loss_fn(state.params, *batch).detach()
            return state, {"loss": loss, "grad_norm": loss, "skipped": torch.zeros(())}
        return step

    patch(train, "make_train_step", make_train_step)


def train_half_batch(patch):
    """The loss over the first half of each batch, its mean over them."""
    from .drivers import train

    real = train.whisper_loss_fn

    def whisper_loss_fn(dims, dtype):
        loss = real(dims, dtype)
        return lambda params, mel, tokens: loss(params, mel[:mel.shape[0] // 2],
                                                tokens[:tokens.shape[0] // 2])

    patch(train, "whisper_loss_fn", whisper_loss_fn)


# the faults each driver's cells can have
BY_DRIVER = {
    "batch": (alter_decode_tokens, half_batch_decode, batch_row_swap, self_cache_unchanged),
    "engine": (alter_engine_tokens, self_cache_unchanged, engine_slot_swap,
               engine_k1_shifted),
    "train": (step_unchanged, train_half_batch),
}
