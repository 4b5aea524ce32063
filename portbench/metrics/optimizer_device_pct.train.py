"""The share of the training stretch's device busy time spent in the
optimizer's kernels (the zero-fill, the clip and Adam, launched inside the
program's ``vpt_torch.bc.optimizer`` span), in percent."""

from portbench.spans import device_pct

OPS = ("vpt_torch.bc.optimizer",)


def read(run):
    return device_pct(run, "train", OPS[0])
