"""The port's runner registry: the runner a composition's
``[global] runner`` names."""

from __future__ import annotations

_REGISTRY: dict[str, object] = {}


def register(name: str, runner) -> None:
    _REGISTRY[name] = runner


def get_runner(name: str):
    r = _REGISTRY.get(name)
    if r is None:
        raise ValueError(f"unknown runner: {name}; have {sorted(_REGISTRY)}")
    return r
