"""Percent of its roofline bound that the fused encoder block (K4 + K6)
reaches in the traced training steps."""

from portbench import roofline


def read(run):
    return roofline.trace_share(run.profile, run.dims, ("K4+K6",))
