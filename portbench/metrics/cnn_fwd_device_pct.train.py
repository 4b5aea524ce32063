"""The share of the training stretch's device busy time spent in the CNN's
forward kernels (launched inside the program's ``vpt_torch.policy.cnn``
span), in percent.  Forward only: the backward's kernels launch on
autograd's thread, which holds no forward span."""

from portbench.spans import device_pct

OPS = ("vpt_torch.policy.cnn",)


def read(run):
    return device_pct(run, "train", OPS[0])
