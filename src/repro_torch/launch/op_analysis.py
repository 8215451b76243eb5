"""The roofline of a counted step (PyTorch counterpart of
``repro/launch/hlo_analysis.py``'s ``roofline_terms``).

The counting itself, ``OpCosts`` and the ``kernel`` regions through which
the hand kernels record their work, lives in the kernels layer
(``kernels/costs.py``), which the models and kernels import; ``OpCosts``
is re-exported here for the drivers. ``roofline_terms`` turns a count into
seconds on a card's data sheet (``launch/mesh.py``).
"""
from __future__ import annotations

from repro_torch.kernels.costs import OpCosts  # noqa: F401


def roofline_terms(costs: dict, peaks: dict, dtype: str, *,
                   n_devices: int = 1) -> dict:
    """Compute, memory and collective seconds of a count (``totals()``
    of a per-device step) on the card ``peaks`` (``mesh.device_peaks``)
    at ``dtype``'s peak rate, and the dominant term. ``collective_s`` is
    0 on one device and ``None`` on a mesh whose collectives did not
    run (``n_devices`` > 1 and no collective counted)."""
    compute_s = costs["flops"] / peaks["flops"][dtype]
    memory_s = costs["op_bytes"] / peaks["hbm_bytes_per_s"]
    coll = costs.get("collective_bytes", 0)
    if n_devices == 1:
        coll_s = 0.0
    elif not coll:
        coll_s = None
    else:
        coll_s = coll / peaks["nvlink_bytes_per_s"]
    terms = [("compute", compute_s), ("memory", memory_s)]
    if coll_s is not None:
        terms.append(("collective", coll_s))
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s,
            "dominant": max(terms, key=lambda kv: kv[1])[0],
            "device": peaks["name"], "flops": costs["flops"],
            "op_bytes": costs["op_bytes"],
            "collective_bytes": coll,
            "collectives": dict(costs.get("collectives", {}))}
