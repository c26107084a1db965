"""Plain references, one module an architecture (``reference/<name>.py``,
named by a configuration's ``architecture`` key), each with
``sgd_steps(params, batches, cfg, mm)`` and ``forward_logits(params,
tokens, cfg, mm)``, computing on ``products.Products``.  They import
nothing of the program under test."""
