"""Mean next-token cross entropy over the vocab: Triton kernels, forward
and backward, and their plain versions.

Counterpart of ``operator_forge/tpu/demo.py::loss_fn`` (lines 116-118):
``log_softmax`` over the last dim, the gather at the targets, then the mean
NLL; and of its transpose under ``jax.value_and_grad`` in ``train_step``
(lines 121-127): ``dlogits = (softmax(logits) - onehot(target)) * g / N``
with N the number of rows.  Everything is f32.

Bound on an H100 SXM at DemoConfig() (logits f32 [512, 256], int64
targets): forward and backward together read the logits and the targets
once and write dlogits and the loss once, 1,052,676 B: 0.31 us at
3.35 TB/s, far below one launch.  Design: one program per row holds the
row in registers (up to 16384 logits; a longer row, Llama 2's 32000 say,
goes in chunks: a pass for the max, then one for the sum of
``exp(x - max)``, in ``log_softmax``'s order); the forward writes each
row's NLL and its log-sum-exp (kept for the backward), and a second launch
of one program takes the mean over the rows in a fixed order: no float
atomics and no ``torch.mean``, so the loss repeats bit for bit.  The
backward is one program per row again, chunk by chunk.  Row offsets are
64-bit, so the logits may hold 2**31 values or more.
The forward's two launches count as one, the backward as one.  Triton
serves as well as CUDA here: there is no tensor-core work, only row
reductions.
"""

from __future__ import annotations

import functools

import torch

# a row of up to ROW_BLOCK logits sits in registers; a longer one goes
# CHUNK logits at a time
ROW_BLOCK = 16384
CHUNK = 8192
MEAN_BLOCK = 1024

launches = 0
bwd_launches = 0


def _rows(logits: torch.Tensor, targets: torch.Tensor):
    return logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)


def cross_entropy_ref(
    logits: torch.Tensor, targets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: ``(loss, lse)``, the mean NLL
    and each row's log-sum-exp, in ``jax.nn.log_softmax``'s order:
    ``logp = (x - max) - log(sum(exp(x - max)))``."""
    x, t = _rows(logits, targets)
    top = x.amax(dim=-1, keepdim=True)
    shifted = x - top
    log_total = torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    nll = -(shifted.gather(-1, t[:, None]) - log_total)
    return nll.mean(), (top + log_total).squeeze(-1)


def cross_entropy_bwd_ref(
    logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``(exp(x - lse) - onehot) *
    (grad / N)``, in logits' shape; ``grad / N`` is a division, as JAX's
    transpose of the mean divides."""
    x, t = _rows(logits, targets)
    # a device tensor, not a Python int: CUDA turns division by a host
    # scalar into multiplication by its inverse, which rounds differently
    n = torch.tensor(x.shape[0], dtype=torch.float32, device=x.device)
    onehot = torch.nn.functional.one_hot(t, x.shape[-1]).to(x.dtype)
    dx = (torch.exp(x - lse[:, None]) - onehot) * (grad / n)
    return dx.reshape(logits.shape)


@functools.cache
def _kernel():
    # Triton resolves the names a kernel uses through its module's globals,
    # so ``tl`` is bound there, at the first launch rather than at import
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def ce_rows_kernel(x_ptr, t_ptr, nll_ptr, lse_ptr, n_cols, BLOCK: tl.constexpr,
                       ONE: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        x_row = x_ptr + row * n_cols
        cols = tl.arange(0, BLOCK)
        target = tl.load(t_ptr + row)
        if ONE:  # the row in registers
            x = tl.load(x_row + cols, mask=cols < n_cols, other=-float("inf"))
            top = tl.max(x, axis=0)
            shifted = x - top
            log_total = tl.log(tl.sum(tl.exp(shifted), axis=0))
            picked = tl.sum(tl.where(cols == target, shifted, 0.0), axis=0)
        else:  # chunk by chunk: the max, then the sum of exp(x - max)
            top_acc = tl.full([BLOCK], -float("inf"), tl.float32)
            for c0 in range(0, n_cols, BLOCK):
                x = tl.load(x_row + c0 + cols, mask=c0 + cols < n_cols, other=-float("inf"))
                top_acc = tl.maximum(top_acc, x)
            top = tl.max(top_acc, axis=0)
            total = tl.zeros([BLOCK], dtype=tl.float32)
            for c0 in range(0, n_cols, BLOCK):
                x = tl.load(x_row + c0 + cols, mask=c0 + cols < n_cols, other=-float("inf"))
                total += tl.exp(x - top)
            log_total = tl.log(tl.sum(total, axis=0))
            inside = (target >= 0) & (target < n_cols)
            picked = tl.load(x_row + target, mask=inside, other=top) - top
        tl.store(nll_ptr + row, -(picked - log_total))
        tl.store(lse_ptr + row, top + log_total)

    @triton.jit
    def mean_kernel(nll_ptr, loss_ptr, n_rows, divisor, BLOCK: tl.constexpr):
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for r0 in range(0, n_rows, BLOCK):
            rows = r0 + tl.arange(0, BLOCK)
            acc += tl.load(nll_ptr + rows, mask=rows < n_rows, other=0.0)
        tl.store(loss_ptr, tl.div_rn(tl.sum(acc, axis=0), divisor))

    @triton.jit
    def ce_bwd_kernel(x_ptr, t_ptr, lse_ptr, g_ptr, dx_ptr, divisor, n_cols,
                      BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        lse = tl.load(lse_ptr + row)
        target = tl.load(t_ptr + row)
        scale = tl.div_rn(tl.load(g_ptr), divisor)
        for c0 in range(0, n_cols, BLOCK):
            cols = c0 + tl.arange(0, BLOCK)
            inside = cols < n_cols
            x = tl.load(x_ptr + row * n_cols + cols, mask=inside, other=0.0)
            probs = tl.exp(x - lse)
            onehot = tl.where(cols == target, 1.0, 0.0)
            tl.store(dx_ptr + row * n_cols + cols, (probs - onehot) * scale, mask=inside)

    return triton, ce_rows_kernel, mean_kernel, ce_bwd_kernel


def _block(triton, n_cols: int) -> int:
    """The logits a program holds at a time: the whole row up to
    ``ROW_BLOCK``, else ``CHUNK``."""
    return triton.next_power_of_2(n_cols) if n_cols <= ROW_BLOCK else CHUNK


def _check(logits: torch.Tensor, targets: torch.Tensor, what: str) -> bool:
    """Validate f32 ``logits [..., V]`` and integer ``targets [...]``; True
    where both lie on the CPU (the plain version), False for the kernel,
    raise otherwise."""
    if (logits.dtype != torch.float32 or targets.dtype not in (torch.int32, torch.int64)
            or logits.dim() < 1 or targets.shape != logits.shape[:-1]
            or logits.shape[-1] < 1 or targets.numel() < 1):
        raise ValueError(
            f"{what} takes f32 logits [..., V] with V >= 1 and integer "
            f"targets [...], got {logits.dtype} {tuple(logits.shape)} and "
            f"{targets.dtype} {tuple(targets.shape)}"
        )
    if logits.device.type == "cpu" and targets.device.type == "cpu":
        return True
    if (logits.device.type != "cuda" or targets.device != logits.device
            or not logits.is_contiguous() or not targets.is_contiguous()):
        raise ValueError(f"{what}'s kernels take contiguous tensors on one CUDA device")
    return False


def cross_entropy_fwd(
    logits: torch.Tensor, targets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``logits [..., V]`` and targets in ``[0, V)`` -> ``(loss, lse)``:
    the plain version for CPU tensors, the Triton kernels (two launches,
    counted once) for CUDA tensors.  A target outside ``[0, V)`` is not
    checked on the card (that would wait for it) and picks no logit."""
    global launches
    if _check(logits, targets, "cross_entropy"):
        return cross_entropy_ref(logits, targets)
    triton, rows_kernel, mean_kernel, _ = _kernel()
    x, t = _rows(logits, targets)
    n_rows, n_cols = x.shape
    nll = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    block = _block(triton, n_cols)
    with torch.cuda.device(x.device):
        rows_kernel[(n_rows,)](
            x, t, nll, lse, n_cols, BLOCK=block, ONE=n_cols <= block,
            num_warps=min(max(block // 256, 1), 8),
        )
        # the row count as an f32 argument (exact below 2**24): Triton
        # would make an int argument of 1 a constant
        mean_kernel[(1,)](nll, loss, n_rows, float(n_rows), BLOCK=MEAN_BLOCK, num_warps=4)
    launches += 1
    return loss, lse


def cross_entropy_bwd(
    logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """``dlogits`` in logits' shape for the loss gradient ``grad`` (an f32
    scalar tensor) and the forward's ``lse``: the plain version for CPU
    tensors, the Triton kernel for CUDA tensors."""
    global bwd_launches
    cpu = _check(logits, targets, "cross_entropy_bwd")
    n_rows = targets.numel()
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (n_rows,)
            or grad.dtype != torch.float32 or grad.numel() != 1):
        raise ValueError(
            f"cross_entropy_bwd takes f32 lse [{n_rows}] and an f32 scalar grad, got "
            f"{lse.dtype} {tuple(lse.shape)} and {grad.dtype} {tuple(grad.shape)}"
        )
    if cpu and lse.device.type == "cpu" and grad.device.type == "cpu":
        return cross_entropy_bwd_ref(logits, targets, lse, grad)
    if lse.device != logits.device or grad.device != logits.device or not lse.is_contiguous():
        raise ValueError("cross_entropy_bwd's kernel takes tensors on one CUDA device")
    triton, _, _, kernel = _kernel()
    x, t = _rows(logits, targets)
    dx = torch.empty_like(x)
    block = _block(triton, x.shape[1])
    with torch.cuda.device(x.device):
        kernel[(n_rows,)](
            x, t, lse, grad, dx, float(n_rows), x.shape[1], BLOCK=block,
            num_warps=min(max(block // 256, 1), 8),
        )
    bwd_launches += 1
    return dx.reshape(logits.shape)


class CrossEntropy(torch.autograd.Function):
    """``cross_entropy_fwd`` with ``cross_entropy_bwd`` as its gradient;
    saves the logits, the targets and each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss, lse = cross_entropy_fwd(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        logits, targets, lse = ctx.saved_tensors
        return cross_entropy_bwd(logits, targets, lse, grad.contiguous()), None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with a gradient: f32 ``logits [..., V]`` and
    targets ``[...]`` -> f32 scalar, the forward kernels now and the
    backward kernel under ``backward()`` (the plain versions for CPU
    tensors)."""
    return CrossEntropy.apply(logits, targets)
