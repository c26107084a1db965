"""The 95th percentile of every forward call of the window, from its
issue to its logits being ready, in ms."""

from portbench import readers


def read(run):
    return readers.p95_ms(run, "forward")
