"""PyTorch's own kernels in the train entry (copies, casts, adds, jit's
copies in and out, the SGD update: every kernel in no named class) over
the device's busy time, in %."""

from portbench import readers


def read(run):
    return readers.glue_share(run, "train")
