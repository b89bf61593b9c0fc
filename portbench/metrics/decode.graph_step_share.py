"""Share of the traced batch's decoder token steps that ran as a CUDA-graph
replay: the program's counter ``decode.graph_steps`` over
``decode.token_steps`` (``qasr_ijcnlp_tpu_torch.profiling`` counts while a
profiler runs).  None where the program counted no token step (or keeps no
recorder); 0.0 where it replayed none, as a program without the graph.
Reads ``decode.graph_step_share`` and its splits."""


def read(run):
    from qasr_ijcnlp_tpu_torch import profiling

    recorder = getattr(profiling, "RECORDER", None)
    counters = getattr(recorder, "counters", None) or {}
    steps = counters.get("decode.token_steps", 0)
    if not steps:
        return None
    return counters.get("decode.graph_steps", 0) / steps
