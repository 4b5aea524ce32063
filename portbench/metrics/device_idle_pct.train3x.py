"""The share of the profiled 3x train stretch in which no operation ran on the device, in percent."""

from portbench.readers import device_idle


def read(run):
    return device_idle(run, "train")
