"""Hand-written Hopper kernels of the forward pass, the train step and
ring attention's block step, each beside its plain PyTorch version.

Every wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or the
wrapper raises).  Each wrapper raises its counter in ``telemetry``,
``kernels.<wrapper>`` (``kernels.causal_attention``,
``kernels.causal_attention_bwd``, ...), by one per call that launches the
kernel (a call of two launches counts once), so a run can show that the
main path went through the kernels; a replayed graph raises none.  Each
module's autograd ``Function`` ties its forward and
backward together.  Every kernel is CUDA C++ under ``csrc/``; importing
these modules needs no ``nvcc``, which is reached only at the first
launch.
"""

import math
import re

import torch


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """Elementwise spacing of bf16 values at ``|t|``, in f32: ``2**(e - 7)``
    for ``|t|`` in ``[2**e, 2**(e + 1))``.  The tolerances of the kernels'
    checks are stated in these units."""
    e = torch.floor(torch.log2(t.detach().abs().float().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


def within_ulps(got: torch.Tensor, want: torch.Tensor, n: int) -> bool:
    """Whether ``got`` lies within ``n`` bf16 ulps of ``want``'s largest
    magnitude everywhere."""
    tol = n * float(bf16_ulp(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) <= tol


def within_floored_ulps(got: torch.Tensor, want: torch.Tensor, n: int) -> bool:
    """Whether ``got`` lies within ``n`` bf16 ulps of each value of
    ``want``, its magnitude floored at 2**-8 of ``want``'s largest: the
    check of a bf16 product whose f32 sum runs in another order, which
    moves a rounding by one ulp, and which cancels near zero."""
    want = want.float()
    floor = 2.0**-8 * want.abs().max()
    return bool(((got.float() - want).abs() <= n * bf16_ulp(torch.maximum(want.abs(), floor))).all())


def row_ulps(got: torch.Tensor, want: torch.Tensor, width: int, parts: int = 1) -> tuple[float, float]:
    """The largest distance of ``got`` from ``want`` in bf16 ulps of the
    largest magnitude of its row of ``want`` (the last dim cut into rows of
    ``width`` values; a row's magnitude floored at 2**-14 of its part's),
    and in bf16 ulps of its part's largest magnitude (the last dim cut into
    ``parts`` equal parts, as dQ, dK and dV).  The floor is for a row that
    cancels to about zero (a gradient row whose two keys' dP agree), where
    f32 noise remains."""
    want = want.float().unflatten(-1, (parts, -1, width))
    err = (got.float().unflatten(-1, (parts, -1, width)) - want).abs()
    rows = want.abs().amax(-1, keepdim=True)
    largest = rows.movedim(-3, 0).reshape(parts, -1).amax(1).view(parts, 1, 1)
    return (float((err / bf16_ulp(torch.maximum(rows, 2.0**-14 * largest))).max()),
            float((err / bf16_ulp(largest)).max()))


def rows_close(got: torch.Tensor, want: torch.Tensor, width: int, parts: int = 1) -> bool:
    """The check of attention against its plain version: within 3 bf16 ulps
    of each row's magnitude and 2 of its part's (``row_ulps``).  Its rows
    (one head of one query, or of one key for dK and dV) differ in scale by
    the count of keys they see, so that the part's tolerance alone passes
    a long row that is percents off; a row of one or two keys moves by up
    to 3 ulps where a bf16 ``p`` or ``dS`` rounds the other way."""
    row, part = row_ulps(got, want, width, parts)
    return row <= 3 and part <= 2


def step_tolerance(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """How far a parameter after one SGD step ``p - lr * g`` may lie from
    the same step taken elsewhere (the CPU, the JAX reference): ``lr``
    times 4 bf16 ulps of the gradient's max |g|, since every product rounds
    to bf16 and sums in another order, plus 1 f32 ulp of |p| for the
    rounding of the update."""
    a = p.abs()
    return lr * 4 * bf16_ulp(g.abs().max()) + (torch.nextafter(a, torch.full_like(a, math.inf)) - a)


def run_twice(fn) -> tuple[tuple, bool]:
    """Call ``fn`` twice on the same inputs: the first call's tensors, and
    whether the two calls gave the same bits (no atomics, sums in a fixed
    order)."""
    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    return first, all(torch.equal(a, b) for a, b in zip(first, second))


def carry_close(got: torch.Tensor, want: torch.Tensor, tol: float = 2e-5,
                scaled: bool = False) -> bool:
    """Whether ``got`` lies within rtol and atol ``tol`` of ``want`` where
    ``want`` is finite, with infinities in the same places: the check of a
    ring step's carry, whose running max starts at ``-inf``.  With
    ``scaled`` the atol is ``tol`` times the largest finite |want|: the
    rule for blocks of more than 1024 keys, whose f32 sums over thousands
    of terms round by more than 2e-5 in the plain version itself."""
    finite = torch.isfinite(want)
    if not torch.equal(finite, torch.isfinite(got)) or not torch.equal(got[~finite], want[~finite]):
        return False
    magnitude = want.abs()[finite]
    atol = tol * float(magnitude.max()) if scaled and magnitude.numel() else tol
    return bool(((got - want).abs()[finite] <= atol + tol * magnitude).all())


def grads_close(got: torch.Tensor, want: torch.Tensor, tol: float = 2e-5) -> bool:
    """Whether ``got`` lies within rtol ``tol`` and atol ``tol`` times the
    largest |want| of ``want``: the check of f32 gradients whose sums run
    in another order over up to thousands of terms."""
    return bool(((got - want).abs() <= tol * want.abs().max() + tol * want.abs()).all())


# each wrapper by the device kernel that marks one of its calls (a call of
# two launches, attention's backward, by its first), named as the launch
# counters are, less their ``kernels.``; the MLP's two wrappers share
# ``mlp_kernel``, told apart by its last template argument
_CALL_KERNELS = {
    "causal_attention_kernel": "causal_attention", "attention_stream_kernel": "causal_attention",
    "causal_attention_bwd_dq_kernel": "causal_attention_bwd",
    "attention_stream_dq_kernel": "causal_attention_bwd",
    "rmsnorm_warp": "rmsnorm", "rmsnorm_block": "rmsnorm", "rmsnorm_bwd_kernel": "rmsnorm_bwd",
    "ce_fwd_warp": "cross_entropy", "ce_fwd_block": "cross_entropy", "ce_bwd": "cross_entropy_bwd",
    "ring_step_kernel": "ring_attention_step", "ring_step_tiled_kernel": "ring_attention_step",
    "ring_step_wide_kernel": "ring_attention_step", "ring_step_long_kernel": "ring_attention_step",
    "ring_step_bwd_kernel": "ring_attention_step_bwd",
    "ring_step_bwd_tiled_kernel": "ring_attention_step_bwd",
    "ring_step_bwd_wide_kernel": "ring_attention_step_bwd",
}


def wrapper_call(kernel: str) -> str | None:
    """The wrapper (``causal_attention``, ``matmul_gelu_bwd``, ...) one of
    whose calls a device kernel of the profiler's (demangled) name
    ``kernel`` marks, or None for a kernel that marks none (the second
    kernel of a call, a library's): how a CUDA graph's replay, which the
    wrappers' counters never see, is counted."""
    found = re.search(r"(\w+)<", kernel)
    if not found:
        return None
    if found.group(1) == "mlp_kernel":
        return "matmul_gelu_bwd" if re.search(r", true>\(", kernel) else "matmul_gelu"
    return _CALL_KERNELS.get(found.group(1))
