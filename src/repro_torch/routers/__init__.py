"""``repro_torch.routers`` — the public routing API of the port: one
``Router`` interface and a string registry (``make``)."""
from repro_torch.routers.base import Router  # noqa: F401
from repro_torch.routers.mlp import MLPRouter  # noqa: F401
from repro_torch.routers.registry import available, get, make, register  # noqa: F401
