"""Percent of its roofline bound that the conv stem kernel (K3) reaches in
the traced stretch (a batch, or training steps)."""

from portbench import roofline


def read(run):
    return roofline.trace_share(run.profile, run.dims, ("K3",))
