"""The portable composition digest the federation plane routes on (a
copy of ``testground_tpu/federation/affinity.py``).

The runner's pool key (sim/runner.py ``_executor_cache_key``) hashes the
plan module's source and the prepared config: it cannot be computed
without building the plan. The coordinator needs to answer "which worker
already holds a warm executor for THIS submission?" from nothing but the
composition dict it just received, so routing keys on a cheaper digest
of the compile-relevant composition surface: plan, case, runner, group
shapes and params, run_config (minus the runtime-only tick knobs) and
every program-shaping table (sweep/faults/trace/telemetry/search).

Both ends compute it at the same normalization stage — the coordinator
from the submitted payload, the worker's engine at ``queue_run`` time on
the identical forwarded dict — so the digests agree by construction. For
the same dict it is the JAX package's digest, byte for byte. Build
artifacts and prepare-time defaults are deliberately excluded: they
differ per host and per stage. Two compositions with equal digests MAY
still build differently (the digest doesn't see edited plan sources);
affinity is a routing heuristic, and a mis-route degrades to a fresh
build and capture, never a wrong result.
"""

from __future__ import annotations

import hashlib
import json

# the runtime-only config fields the runner's pool key also strips
# (sim/runner.py _RUNTIME_CFG_FIELDS): host-side dispatch tuning, not
# program shape
_RUNTIME_KEYS = ("chunk_ticks", "max_ticks")


def affinity_key(comp_dict: dict) -> str:
    """Digest of a composition's compile-relevant surface (32 hex
    chars). ``comp_dict`` is ``Composition.to_dict()`` form (the same
    shape POST /run carries)."""
    g = comp_dict.get("global", {}) or {}
    run_config = {
        k: v
        for k, v in sorted((g.get("run_config") or {}).items())
        if k not in _RUNTIME_KEYS
    }
    groups = []
    for grp in comp_dict.get("groups", []) or []:
        inst = grp.get("instances", {}) or {}
        run = grp.get("run", {}) or {}
        groups.append(
            [
                grp.get("id", ""),
                inst.get("count", 0),
                inst.get("percentage", 0.0),
                sorted((run.get("test_params") or {}).items()),
            ]
        )
    material = {
        "plan": g.get("plan", ""),
        "case": g.get("case", ""),
        "runner": g.get("runner", ""),
        "total_instances": g.get("total_instances", 0),
        "run_config": run_config,
        "groups": groups,
        # every program-shaping table keys the executor, so it keys
        # affinity too ([live]/[checkpoint] are host-only and skipped —
        # toggling them must not re-route a warm composition)
        "sweep": comp_dict.get("sweep"),
        "faults": comp_dict.get("faults"),
        "trace": comp_dict.get("trace"),
        "telemetry": comp_dict.get("telemetry"),
        "search": comp_dict.get("search"),
    }
    raw = json.dumps(material, sort_keys=True, default=str)
    return hashlib.sha256(raw.encode()).hexdigest()[:32]
