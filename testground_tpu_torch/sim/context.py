"""Build-time context: everything about the composition that is static at
build time (instance counts, groups, parameters).

A numpy-only copy of ``testground_tpu/sim/context.py`` (the port imports
nothing of the JAX package). Per-group test params become either static
Python values (loop bounds, sizes) or stacked per-instance arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class GroupSpec:
    id: str
    index: int
    instances: int
    parameters: dict[str, str] = field(default_factory=dict)


class BuildContext:
    def __init__(
        self,
        groups: list[GroupSpec],
        test_case: str = "",
        test_run: str = "",
        padded_n: int = 0,
    ) -> None:
        self.groups = groups
        self.test_case = test_case
        self.test_run = test_run
        self.n_instances = sum(g.instances for g in groups)
        self.padded_n = max(padded_n, self.n_instances)

        gids = np.full(self.padded_n, -1, dtype=np.int32)
        ginst = np.zeros(self.padded_n, dtype=np.int32)  # index within group
        off = 0
        for g in groups:
            gids[off : off + g.instances] = g.index
            ginst[off : off + g.instances] = np.arange(g.instances)
            off += g.instances
        self.group_ids = gids  # [padded_n], -1 for padding rows
        self.group_instance_index = ginst
        # names read through static_param_* during the build: baked into
        # the program (loop bounds, buffer sizes, Python branches)
        self.static_param_reads: set[str] = set()

    # ------------------------------------------------------- static params

    def _param_values(self, name: str, default=None) -> list[str]:
        vals = []
        for g in self.groups:
            v = g.parameters.get(name)
            if v is None:
                if default is None:
                    raise KeyError(
                        f"group {g.id} missing test param {name!r} and no default"
                    )
                v = str(default)
            vals.append(v)
        return vals

    def static_param_int(self, name: str, default=None) -> int:
        """A param that must be uniform across groups (used for static loop
        bounds / buffer sizes)."""
        self.static_param_reads.add(name)
        vals = {int(v) for v in self._param_values(name, default)}
        if len(vals) != 1:
            raise ValueError(
                f"param {name!r} must be uniform across groups for static "
                f"use; got {sorted(vals)}"
            )
        return vals.pop()

    def static_param_str(self, name: str, default=None) -> str:
        self.static_param_reads.add(name)
        vals = set(self._param_values(name, default))
        if len(vals) != 1:
            raise ValueError(f"param {name!r} differs across groups: {vals}")
        return vals.pop()

    # ----------------------------------------------------- stacked params

    def param_array_int(self, name: str, default=None) -> np.ndarray:
        """Per-instance int32 values, stacked by group."""
        per_group = [int(v) for v in self._param_values(name, default)]
        out = np.zeros(self.padded_n, dtype=np.int32)
        off = 0
        for g, v in zip(self.groups, per_group):
            out[off : off + g.instances] = v
            off += g.instances
        return out

    def param_array_float(self, name: str, default=None) -> np.ndarray:
        per_group = [float(v) for v in self._param_values(name, default)]
        out = np.zeros(self.padded_n, dtype=np.float32)
        off = 0
        for g, v in zip(self.groups, per_group):
            out[off : off + g.instances] = v
            off += g.instances
        return out

    def group_mask(self, group_id: str) -> np.ndarray:
        idx = next(g.index for g in self.groups if g.id == group_id)
        return self.group_ids == idx
