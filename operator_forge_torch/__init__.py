"""PyTorch/CUDA port of the SURVEY §7.5 demo payload for one NVIDIA H100.

The reference is the JAX package ``operator_forge/tpu/demo.py``; this
package computes the same functions on the same parameter layout and is
tested against it.  It imports ``torch``, never ``jax`` or anything under
``operator_forge``; its kernels are CUDA C++, built by ``nvcc`` at their
first launch.

- ``demo``: the model (``DemoConfig``, ``init_params``, ``params_from_jax``,
  ``forward``, ``loss_fn``, ``value_and_grad``, ``train_step``), its
  sharding (``make_mesh``, ``param_specs``, ``shard_params``,
  ``gather_params``, ``sharded_train_step``), ``run_dryrun``, and ring
  attention (``ring_attention``, ``dense_causal_attention``);
- ``entry``: the driver entry points, ``entry`` (the forward, the
  counterpart of ``__graft_entry__.entry``), ``train_entry`` (the SGD
  step) and ``dryrun_multichip`` (the counterpart of
  ``__graft_entry__.dryrun_multichip``);
- ``jit``: ``jit``, the counterpart of ``jax.jit``: a function of tensors
  captured once per signature into a CUDA graph and replayed (called as it
  is on CPU tensors); ``demo.sharded_train_step`` returns one;
- ``ranks``: ``run_ranks``, a function run in spawned ranks of one
  process group (NCCL on cards, gloo on the CPU);
- ``kernels``: the hand-written Hopper kernels and their plain versions;
- ``telemetry``: the one registry of the port's counters, spans and device
  marks (``jit``'s calls, copies and captures, the kernels' launches, the
  captured step's forward, backward and update timed on the device),
  traced while a ``torch.profiler`` session is open.
"""
