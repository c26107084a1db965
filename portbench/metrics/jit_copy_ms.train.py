"""``jit``'s copies of the train step's arguments into its graph and of
its outputs out of it, timed on the device by events around them
(``jit.copy``): the mean a call over the traced stretch, in ms."""

from portbench import program


def read(run):
    return program.device_ms(run, "train", "jit.copy")
