"""Kernel B1's share of its roofline in the labeling forward, by operator."""

from portbench.readers import B1_OP, roofline

OPS = (B1_OP,)


def read(run):
    return roofline(run, "label", B1_OP)
