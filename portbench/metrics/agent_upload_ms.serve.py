"""Mean host time of a serving step's copy of the frames and episode
starts to the device (a pageable copy holds the host until it is done), in
ms: the program's ``vpt_torch.agent.upload`` span in the profiled stretch."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "serve", "vpt_torch.agent.upload")
