"""The data sheet of the card the port runs on (PyTorch counterpart of
``repro/launch/mesh.py``'s hardware constants).

Rows are keyed by ``torch.cuda.get_device_name()``. Each holds the
published dense peaks of that part (no sparsity), at its full power
limit: FLOP/s by input type, HBM bytes/s, NVLink bytes/s per direction
and memory bytes. A card set below its full power limit runs slower
under load, so every roofline made from these rows names the card.

``device_peaks`` raises on a name with no row: it never guesses a card.
The production meshes of the dry-run are ``{axis: size}`` shapes
(``launch/specs.py``); no device mesh is needed to account for one.
"""
from __future__ import annotations

from typing import Optional

#: NVIDIA's data sheet of each part, dense rates as the sheet rounds
#: them (the sheet prints the bf16 and TF32 rates with sparsity, twice
#: these).
DATA_SHEETS = {
    "NVIDIA H100 80GB HBM3": {           # H100 SXM5, 700 W
        "part": "H100 SXM5",
        "flops": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                  "float32": 67e12},
        "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s": 450e9,
        "memory_bytes": 80e9,
        "power_limit_w": 700.0,
    },
}


def device_peaks(name: Optional[str] = None) -> dict:
    """The data-sheet row of the card called ``name`` (default: the
    current CUDA device's name), with ``name`` added. Raises ``KeyError``
    for a card with no row and ``RuntimeError`` without a name and
    without a CUDA device."""
    if name is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("device_peaks() without a name needs a CUDA "
                               "device: pass the card's name")
        name = torch.cuda.get_device_name()
    if name not in DATA_SHEETS:
        raise KeyError(f"no data sheet for {name!r}; known: "
                       f"{sorted(DATA_SHEETS)}")
    return {"name": name, **DATA_SHEETS[name]}


H100 = "NVIDIA H100 80GB HBM3"
