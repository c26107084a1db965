"""The comparison that decides ``correct``: the numbers that hold what the
timed path produced against the plain reference, and their limits.

Train cells (the first ``CHECK_STEPS`` steps of the window's own call,
from the seed's weights, each on its own batch of the pool):

- ``loss_gap``: the largest gap, in nats, between a step's loss and the
  reference's loss of the same step;
- ``grad_gap``: the worst leaf's gap between the norm of the first
  gradient as the update took it (``|p0 - p1| / lr``) and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
- ``change_gap``: the same for the norm of each leaf's change after the
  steps, ``|p3 - p0|``, leaving out leaves whose reference gradient is
  under ``ZERO_GRAD`` of the median leaf's (they move by rounding alone).

Forward cells (calls of the window, drawn from the seed, and its last):

- ``logit_max_gap``: the largest |program - reference| logit over the RMS
  of the reference's logits of the same call;
- ``logit_rms_gap``: the RMS of the difference over that RMS.

A limit file holds, for each number, its limit (``limit``); a run is
correct where every number of its limit file is finite and at most its
limit.
"""

from __future__ import annotations

import math
import statistics

import torch

ZERO_GRAD = 1e-3


def leaf_gap(program: list, reference: list, keep: list | None = None) -> float:
    """The worst leaf's |program - reference| over max(reference, the
    median leaf's reference)."""
    median = statistics.median(reference)
    keep = keep or [True] * len(reference)
    return max(abs(p - r) / max(r, median) for p, r, k in zip(program, reference, keep) if k)


def train_numbers(program: dict, reference: dict) -> dict:
    """``program`` and ``reference`` as ``sgd_steps`` returns them."""
    grads = reference["grad_norms"]
    floor = ZERO_GRAD * statistics.median(grads)
    return {
        "loss_gap": max(abs(p - r) for p, r in zip(program["losses"], reference["losses"])),
        "grad_gap": leaf_gap(program["grad_norms"], grads),
        "change_gap": leaf_gap(program["change_norms"], reference["change_norms"],
                               [g >= floor for g in grads]),
    }


class LogitGaps:
    """Running ``logit_max_gap`` and ``logit_rms_gap`` over calls, fed one
    reference row at a time."""

    def __init__(self):
        self.max_gap = 0.0
        self.rms_gap = 0.0

    def add_call(self, program: torch.Tensor, reference_rows: list) -> None:
        """``program [batch, seq, vocab]`` against the reference's rows."""
        worst, diff_sq, ref_sq, count = 0.0, 0.0, 0.0, 0
        for got, want in zip(program, reference_rows):
            diff = got.float() - want
            worst = max(worst, float(diff.abs().max()))
            diff_sq += float(diff.double().square().sum())
            ref_sq += float(want.double().square().sum())
            count += want.numel()
        rms = math.sqrt(ref_sq / count)
        self.max_gap = max(self.max_gap, worst / rms)
        self.rms_gap = max(self.rms_gap, math.sqrt(diff_sq / ref_sq))

    def numbers(self) -> dict:
        return {"logit_max_gap": self.max_gap, "logit_rms_gap": self.rms_gap}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: ``checks`` maps each number of the limit file
    to its value and limit; a number missing or not finite fails."""
    checks = {}
    correct = True
    for name, entry in limits["numbers"].items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": entry["limit"]}
        correct = correct and math.isfinite(value) and value <= entry["limit"]
    return correct, checks
