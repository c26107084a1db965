"""The captured train step's forward (the loss) in the traced stretch,
timed on the device by the marks ``jit`` captures into the graph around
it (``step.forward``): the mean over the replays read, in ms."""

from portbench import program


def read(run):
    return program.device_ms(run, "train", "step.forward")
