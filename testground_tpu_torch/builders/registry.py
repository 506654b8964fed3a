"""Builder registry (a copy of ``testground_tpu/build/registry.py``;
reference pkg/engine/engine.go:25-30)."""

from __future__ import annotations

_REGISTRY: dict[str, object] = {}


def register(name: str, builder) -> None:
    _REGISTRY[name] = builder


def get_builder(name: str):
    b = _REGISTRY.get(name)
    if b is None:
        raise KeyError(f"unknown builder: {name}; have {sorted(_REGISTRY)}")
    return b


def all_builders() -> dict[str, object]:
    return dict(_REGISTRY)
