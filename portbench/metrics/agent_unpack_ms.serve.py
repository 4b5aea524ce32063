"""Mean host time of a serving step's unpacking of the packed actions into
the streams' env actions, in ms: the program's ``vpt_torch.agent.unpack``
span in the profiled stretch."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "serve", "vpt_torch.agent.unpack")
