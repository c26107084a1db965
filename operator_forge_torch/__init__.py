"""PyTorch/CUDA port of the SURVEY §7.5 demo payload for one NVIDIA H100.

The reference is the JAX package ``operator_forge/tpu/demo.py``; this
package computes the same functions on the same parameter layout and is
tested against it.  It imports ``torch`` (and ``triton`` only inside the
functions that launch a Triton kernel), never ``jax`` or anything under
``operator_forge``.

- ``demo``: the model (``DemoConfig``, ``init_params``, ``params_from_jax``,
  ``forward``);
- ``entry``: the driver entry point, the counterpart of
  ``__graft_entry__.entry``;
- ``kernels``: the hand-written Hopper kernels and their plain versions.
"""
