"""The share of the training stretch's convolution forward FLOPs that ran
on kernel C1, the port's f32 3x3 convolution on the tensor cores, in
percent: the program's ``conv_tc_flops`` over ``conv_flops``, counted at
the models' conv routing point (every conv forward of the CNN) in the
profiled stretch."""

from portbench.spans import counter_pct


def read(run):
    return counter_pct(run, "train", "conv_tc_flops", "conv_flops")
