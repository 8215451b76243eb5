"""Command-line drivers of the port (counterparts of ``repro/launch``).

  * ``fed_serve`` — the online federation loop under live traffic
    (``python -m repro_torch.launch.fed_serve``);
  * ``fed_train`` — the in-process federated router fit
    (``python -m repro_torch.launch.fed_train``).

Both run on the CUDA device unless ``--device`` names another.
"""
