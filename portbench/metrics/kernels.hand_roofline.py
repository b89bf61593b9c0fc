"""Percent of the roofline bound that the port's hand kernels in the traced
stretch reach: their summed bound over their summed device time
(``portbench.roofline``; K1, the stem and K8 in a decode, the stem and
K4 + K6 in training, each call under remat counted).  Reads
``kernels.hand_roofline.<split>``."""

from portbench import roofline


def read(run):
    return roofline.trace_share(run.profile, run.dims)
