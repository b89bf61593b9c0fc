"""Host ms a traced batch of the program's ``request.assemble`` span (after
the tokens reach the host: cut at eot, rank, detokenize, compression ratio,
results), over its ``request`` spans.  The recorder holds the spans of the
profiled stretch (``qasr_ijcnlp_tpu_torch.profiling`` records while a
profiler runs); None where the program has no recorder or recorded no
request.  Reads ``request.assemble_ms_per_batch`` and its splits."""


def read(run):
    from qasr_ijcnlp_tpu_torch import profiling

    recorder = getattr(profiling, "RECORDER", None)
    spans = recorder.summary() if recorder is not None else {}
    if "request" not in spans or "request.assemble" not in spans:
        return None
    return spans["request.assemble"]["total_ms"] / spans["request"]["calls"]
