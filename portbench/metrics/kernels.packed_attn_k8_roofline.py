"""Percent of its roofline bound that K8, the encoder's packed attention,
reaches in the traced batch."""

from portbench import roofline


def read(run):
    return roofline.trace_share(run.profile, run.dims, ("K8",))
