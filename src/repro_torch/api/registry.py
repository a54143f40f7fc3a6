"""Algorithm registry behind ``repro_torch.api.fit``.

A driver is a callable

    driver(x_parts, k, *, backend, generator, w, alive, seed, device,
           **algo_params) -> ClusterResult

with ``x_parts`` of shape ``(m, p, d)``, ``w``/``alive`` per-point weight
and validity masks of shape ``(m, p)`` (``None`` = all ones), ``backend``
the backend's name, ``generator`` an optional ``torch.Generator`` on
``device`` (drivers default to one seeded with ``seed``). Registering
under an existing name replaces the driver (latest wins), so downstream
code can override a built-in algorithm.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, Callable] = {}


def register_algorithm(name: str) -> Callable:
    """Decorator: ``@register_algorithm("soccer")`` on a driver."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_algorithm(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def list_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
