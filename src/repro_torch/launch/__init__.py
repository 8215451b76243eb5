"""Command-line drivers of the port (counterparts of ``repro/launch``).

  * ``fed_serve`` — the online federation loop under live traffic
    (``python -m repro_torch.launch.fed_serve``);
  * ``fed_train`` — the federated router fit over the clients mesh
    (``python -m torch.distributed.run ... -m repro_torch.launch.fed_train``);
  * ``dryrun`` / ``roofline`` — every arch × input shape counted on the
    meta device (``op_analysis``, ``specs``, ``mesh``: the card's data
    sheet) and the roofline table (``python -m repro_torch.launch.dryrun
    --all``; no GPU needed);
  * ``train`` — LM training on the synthetic Markov stream
    (``python -m repro_torch.launch.train``), over the step builders of
    ``steps``;
  * ``serve`` — prefill and greedy decode of one pool model
    (``python -m repro_torch.launch.serve``);
  * ``step_time`` — engine steps of the served pair and the kernel entry
    point's host cost (``python -m repro_torch.launch.step_time``).

Each runs on the CUDA device unless ``--device`` names another; the
dry-run needs none and ``step_time`` needs one.
"""
