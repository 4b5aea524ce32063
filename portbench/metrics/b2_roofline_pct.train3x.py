"""Kernel B2's share of its roofline in the 3x training step (d = 192), by operator."""

from portbench.readers import B2_OP, roofline

OPS = (B2_OP,)


def read(run):
    return roofline(run, "train", B2_OP)
