"""Percent of its roofline bound that K1, the log-mel frontend, reaches in
the traced batch."""

from portbench import roofline


def read(run):
    return roofline.trace_share(run.profile, run.dims, ("K1",))
