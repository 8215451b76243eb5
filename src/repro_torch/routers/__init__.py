"""``repro_torch.routers`` — the public routing API of the port: one
``Router`` interface, a string registry and the fit entry points.

    router = routers.make("mlp", rcfg)      # or "kmeans" / "mf" / "elo"
    router, hist = routers.fit_federated(router, split["train"], fcfg, gen=0)
    A, C = router.predict(x)
    m = router.route(x, lam=0.5)
    router.save("router.msgpack")
    router = routers.load("router.msgpack", rcfg)

Families: "mlp" and "mf" (parametric, Alg. 1 FedAvg), "kmeans" and "elo"
(nonparametric, Alg. 2 one-shot statistics).
"""
from repro_torch.routers.base import Router  # noqa: F401
from repro_torch.routers.elo import EloRouter  # noqa: F401
from repro_torch.routers.fit import fit_federated, fit_local  # noqa: F401
from repro_torch.routers.kmeans import KMeansRouter  # noqa: F401
from repro_torch.routers.mf import MFRouter  # noqa: F401
from repro_torch.routers.mlp import MLPRouter  # noqa: F401
from repro_torch.routers.registry import (  # noqa: F401
    available,
    get,
    load,
    make,
    register,
)
