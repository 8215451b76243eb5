"""String registry: router families are selected by name —
``routers.make("mlp", rcfg)`` (counterpart of ``repro/routers/registry.py``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Type

from repro_torch.config import RouterConfig
from repro_torch.routers.base import Router

_REGISTRY: Dict[str, Type[Router]] = {}


def register(name: str) -> Callable[[Type[Router]], Type[Router]]:
    """Class decorator: ``@register("mlp")`` adds a family to the zoo."""
    def deco(cls: Type[Router]) -> Type[Router]:
        if not issubclass(cls, Router):
            raise TypeError(f"{cls.__name__} must subclass Router")
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"router family {name!r} already registered "
                             f"({_REGISTRY[name].__name__})")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Type[Router]:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown router family {name!r} — registered families: "
            f"{', '.join(available())}")
    return _REGISTRY[name]


def make(name: str, rcfg: RouterConfig, *, num_models: Optional[int] = None,
         state=None) -> Router:
    """Build an (unfitted, unless ``state`` is given) router by name."""
    return get(name)(rcfg, num_models=num_models, state=state)
