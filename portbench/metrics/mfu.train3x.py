"""The 3x train step's model FLOPs (the recompute not counted) over the tensor-core peak, in percent."""

from portbench.readers import mfu


def read(run):
    return mfu(run, "train")
