"""Kernel B1's share of its roofline in the training step, by operator."""

from portbench.readers import B1_OP, roofline

OPS = (B1_OP,)


def read(run):
    return roofline(run, "train", B1_OP)
