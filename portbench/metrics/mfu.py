"""Percent of the card's bf16 peak: the model operations of the work the
window completed (batches or requests: encoder, cross K/V, prompt pass and
token steps; training steps: three times their forward, remat's recompute
not counted; from shapes, ``portbench.roofline``) over the window's seconds.
Reads ``mfu.<split>`` in every cell that names it."""

from portbench import roofline


def read(run):
    w = run.window
    return 100.0 * w["model_flops"] / (w["seconds"] * roofline.MODEL_PEAK)
