"""The whole serve step's model FLOPs over the tensor-core peak, in percent."""

from portbench.readers import mfu


def read(run):
    return mfu(run, "serve")
