"""Mean host time a serving step spends inside ``MineRLAgent.dispatch_action``
(the raw frames' copy to the device and the step's launches), in ms, timed
around the call in the trace run's untraced stretch."""


def read(run):
    if run.layer.get("kind") != "serve":
        return None
    return run.layer.get("dispatch_ms")
