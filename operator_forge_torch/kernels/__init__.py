"""Hand-written Hopper kernels of the forward pass, each beside its plain
PyTorch version.

Every wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or the
wrapper raises).  Each module keeps a plain integer ``launches`` that its
wrapper raises by one per kernel launch, so a run can show that the main
path went through the kernel.  Importing these modules needs neither
``triton`` nor ``nvcc``: both are reached only at the first launch.
"""

import torch


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """Elementwise spacing of bf16 values at ``|t|``, in f32: ``2**(e - 7)``
    for ``|t|`` in ``[2**e, 2**(e + 1))``.  The tolerances of the kernels'
    checks are stated in these units."""
    e = torch.floor(torch.log2(t.detach().abs().float().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)
