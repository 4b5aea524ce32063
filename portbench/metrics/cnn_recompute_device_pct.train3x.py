"""The share of the training stretch's device busy time spent recomputing
the CNN in the backward (kernels launched inside the program's
``vpt_torch.remat.cnn`` span, which covers each remat'd frame chunk's
recompute and not its first forward), in percent."""

from portbench.spans import device_pct

OPS = ("vpt_torch.remat.cnn",)


def read(run):
    return device_pct(run, "train", OPS[0])
