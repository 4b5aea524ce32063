"""Kernel B1's share of its roofline in the 3x training step (d = 192), by
operator; the blocks' recompute calls count."""

from portbench.readers import B1_OP, roofline

OPS = (B1_OP,)


def read(run):
    return roofline(run, "train", B1_OP)
