"""Layered config merging (a copy of ``testground_tpu/config/
coalescing.py``): ``CoalescedConfig.append`` adds a layer that overrides
the earlier ones, ``coalesce`` gives the merged dict and
``coalesce_into`` a dataclass built from it, unknown keys ignored (so
``SimConfig`` takes and refuses the keys the JAX runner's does)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Type


class CoalescedConfig:
    def __init__(self) -> None:
        self._layers: list[dict[str, Any]] = []

    def append(self, layer: Optional[dict[str, Any]]) -> "CoalescedConfig":
        if layer:
            self._layers.append(layer)
        return self

    def coalesce(self) -> dict[str, Any]:
        merged: dict[str, Any] = {}
        for layer in self._layers:
            merged.update({k: v for k, v in layer.items() if v is not None})
        return merged

    def coalesce_into(self, typ: Type) -> Any:
        """Merge the layers, then build ``typ`` (a dataclass) from the
        keys it has."""
        merged = self.coalesce()
        names = {f.name for f in dataclasses.fields(typ)}
        return typ(**{k: v for k, v in merged.items() if k in names})
