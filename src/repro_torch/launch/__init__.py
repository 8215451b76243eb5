"""Command-line drivers of the port (counterparts of ``repro/launch``).

  * ``fed_serve`` — the online federation loop under live traffic
    (``python -m repro_torch.launch.fed_serve``);
  * ``fed_train`` — the in-process federated router fit
    (``python -m repro_torch.launch.fed_train``);
  * ``train`` — LM training on the synthetic Markov stream
    (``python -m repro_torch.launch.train``), over the step builders of
    ``steps``;
  * ``serve`` — prefill and greedy decode of one pool model
    (``python -m repro_torch.launch.serve``).

Each runs on the CUDA device unless ``--device`` names another.
"""
