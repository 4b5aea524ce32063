"""Mean host time of a serving step's frame preparation (the 64 streams'
frames into one host array), in ms: the program's ``vpt_torch.agent.prep``
span in the profiled stretch."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "serve", "vpt_torch.agent.prep")
