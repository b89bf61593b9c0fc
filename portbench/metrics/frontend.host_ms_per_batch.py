"""Host ms of the frontend a traced batch, from the program's own spans:
``frontend.pad`` (the host PCM padded or cut to 30 s) plus ``frontend``
(the log-mel call, its ``frontend.upload`` of the PCM to the card
included), over the ``frontend`` calls.  The recorder holds the spans of the
profiled stretch (``qasr_ijcnlp_tpu_torch.profiling`` records while a
profiler runs); None where the program has no recorder or recorded no
frontend.  Reads ``frontend.host_ms_per_batch`` and its splits."""


def read(run):
    from qasr_ijcnlp_tpu_torch import profiling

    recorder = getattr(profiling, "RECORDER", None)
    spans = recorder.summary() if recorder is not None else {}
    if "frontend" not in spans:
        return None
    pad = spans.get("frontend.pad", {}).get("total_ms", 0.0)
    return (pad + spans["frontend"]["total_ms"]) / spans["frontend"]["calls"]
