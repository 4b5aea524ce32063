"""The share of the labeling stretch's device busy time spent in kernels
launched inside the program's ``vpt_torch.policy.cnn`` span (preprocessing,
the conv3d, the Impala CNN and its dense layer), in percent."""

from portbench.spans import device_pct

OPS = ("vpt_torch.policy.cnn",)


def read(run):
    return device_pct(run, "label", OPS[0])
