"""The captured train step's SGD update in the traced stretch, timed on
the device by the marks around it (``step.update``): the mean over the
replays read, in ms."""

from portbench import program


def read(run):
    return program.device_ms(run, "train", "step.update")
