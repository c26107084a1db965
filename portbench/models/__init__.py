"""What the harness runs and counts of each architecture, one module an
architecture (``models/<name>.py``, named by a configuration's
``architecture`` key, ``demo_block`` where the key is absent), loaded by
its path (``spec.architecture``).  Each holds:

- ``SOURCES``: by entry (``train``, ``forward``), the port's CUDA sources
  that entry reaches, built before the capture;
- ``program(cfg, traffic, entry)``: the callable that ``jit`` wraps;
- ``vocab(cfg)``: the vocabulary the token ids are drawn from;
- ``make_params(cfg, seed, device)``: the weights, drawn on the device from
  generators of ``inputs.generator``;
- ``leaves(params)``: the order of the check's norms, the reference's;
- ``change_norms(params, cfg, seed, device)``: each leaf's ``|p - p0|``
  in that order, the seed's weights made again;
- ``model_flops(cfg, batch, seq, entry)`` and ``parameters(cfg)``;
- ``CALLS``: by kernel class, by the call a kernel marks, the function
  ``(cfg, batch, seq, entry, call) -> (operations, bytes)`` of one call.
"""
