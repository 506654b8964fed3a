"""Closed-loop breaking-point search: adaptive severity sweeps on ONE
batched program (counterpart of ``testground_tpu/sim/search.py``; numpy
only, like it).

The sweep plane (sim/sweep.py) enumerates a declared cross-product; this
module *searches*. A ``[search]`` table (sim/tables.py ``Search``) names a
severity axis — a test param consumed through ``env.params`` or
referenced as ``"$param"`` from ``[faults]`` magnitudes/timings — and a
strategy, and the driver runs ROUNDS of fixed-width scenario batches:
each round is padded to the same sweep shape, so the batched tick is
built ONCE (and on the card captured once in a CUDA graph) and every
later round replays it with fresh per-scenario tensors
(``SweepExecutable.rebind``). After each round the driver reads the
per-scenario outcomes (or telemetry roll-ups) and chooses the next
batch:

- ``bisect``: W-section search on a sorted candidate grid for the FIRST
  failing value, assuming the objective is monotone in severity — the
  "this plan survives loss <= 7.8%, first fails at 8.1%" verdict in
  O(log grid) rounds instead of O(grid) scenarios.
- ``halving``: successive halving (Hyperband's allocation rule) over a
  candidate grid — each rung doubles the per-survivor seed budget and
  keeps the better half by objective; deterministic under a fixed seed
  (ties break toward the lower value).
- ``coverage``: coverage-directed sampling — a seed-deterministic
  permutation of the grid consumed width-wise per round until the
  budget (or the grid) is exhausted; replayable bit-for-bit.

Determinism contract (tested): a probed scenario is dispatched through
the sweep plane with an explicit (value, seed) pair, so its outcome is
bit-identical to a serial single run with the same seed/params — and the
whole search, being a pure function of (spec, outcomes), replays
identically.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


class SearchError(ValueError):
    """A search that cannot run against this composition/plan."""


# --------------------------------------------------------------- probes


@dataclass
class Probe:
    """One probed point: a (value, seed) pair dispatched as one scenario
    row of a round batch. The evaluator fills outcome/objective/failed
    after the round runs; ``pad`` rows exist only to keep the batch at
    the compiled width and are never read."""

    value: object  # int | float — stringified into the scenario params
    seed: int
    index: int  # grid index of value
    pad: bool = False
    # filled by the evaluator
    scenario: int = -1  # batch row this probe ran in
    outcome: str = ""
    objective: float = 0.0
    failed: bool = False

    def record(self) -> dict:
        return {
            "scenario": self.scenario,
            "value": self.value,
            "seed": self.seed,
            "outcome": self.outcome,
            "objective": round(float(self.objective), 6),
            "failed": bool(self.failed),
        }


def probe_scenarios(probes: list[Probe], param: str) -> list[dict]:
    """Sweep-plane scenarios for one round batch. Values stringify
    exactly like ``Sweep.expand`` / ``test_params`` (str(v)), so a
    probed scenario is bit-identical to a serial run handed the same
    string."""
    return [
        {
            "seed": int(p.seed),
            "params": {
                param: p.value if isinstance(p.value, str) else str(p.value)
            },
        }
        for p in probes
    ]


# -------------------------------------------------------------- drivers


class SearchDriver:
    """Base closed-loop driver: yields fixed-width probe batches, digests
    each round's outcomes, and renders the verdict. Subclasses implement
    ``next_probes`` (the unpadded batch), ``digest`` (state update),
    ``resolved`` and ``verdict``."""

    def __init__(self, spec) -> None:
        self.spec = spec
        self.grid = spec.grid_values()
        self.width = int(spec.width)
        self.seeds = int(spec.seeds)
        # whole values per round: every probed value gets ALL its seeds
        # in the same round
        self.values_per_round = max(1, self.width // self.seeds)
        self.rounds: list[dict] = []
        self.probed: dict[tuple, Probe] = {}  # (index, seed) -> Probe
        self.scenarios_probed = 0
        self.stopped = ""  # budget | max_rounds | "" (still running/done)

    # ---- per-strategy hooks

    def next_probes(self, room: int) -> list[Probe]:
        """At most ``room`` unpadded probes for the next round (room <
        width only when the scenario budget is nearly spent)."""
        raise NotImplementedError

    def digest(self, probes: list[Probe]) -> None:
        raise NotImplementedError

    def resolved(self) -> bool:
        raise NotImplementedError

    def verdict(self) -> dict:
        raise NotImplementedError

    def default_max_rounds(self) -> int:
        raise NotImplementedError

    def state_record(self) -> dict:
        """Strategy state appended to each round record (bracket,
        survivors, coverage...)."""
        return {}

    # ---- the loop surface

    def seed_list(self, index: int) -> list[int]:
        """Seeds probed for one value (bisect/coverage: the same block
        for every value, so seed effects compare paired)."""
        return [int(self.spec.seed_base) + j for j in range(self.seeds)]

    def hard_round_cap(self) -> int:
        return int(self.spec.max_rounds) or self.default_max_rounds()

    def next_batch(self) -> Optional[list[Probe]]:
        """The next round's batch, padded to exactly ``width`` rows —
        or None when the search is over (resolved, budget- or
        round-capped, or out of candidates)."""
        if self.stopped or self.resolved():
            return None
        if len(self.rounds) >= self.hard_round_cap():
            self.stopped = "max_rounds"
            return None
        budget = int(self.spec.budget)
        room = self.width
        if budget:
            room = min(room, budget - self.scenarios_probed)
            if room < 1:
                self.stopped = "budget"
                return None
        probes = self.next_probes(room)
        if not probes:
            return None
        self.scenarios_probed += len(probes)
        # pad to the built batch shape: ONE build serves every round
        while len(probes) < self.width:
            p0 = probes[0]
            probes.append(
                Probe(value=p0.value, seed=p0.seed, index=p0.index, pad=True)
            )
        for s, p in enumerate(probes):
            p.scenario = s
        return probes

    def observe(self, probes: list[Probe]) -> None:
        real = [p for p in probes if not p.pad]
        for p in real:
            self.probed[(p.index, p.seed)] = p
        self.digest(real)
        self.rounds.append(
            {
                "round": len(self.rounds),
                "probes": [p.record() for p in real],
                **self.state_record(),
            }
        )

    def frontier(self) -> list[dict]:
        """Probed points sorted by value — the pass/fail frontier the
        dashboard charts. Seed repeats of one value fold into one row
        (any-seed-failed, mean objective)."""
        by_idx: dict[int, list[Probe]] = {}
        for (i, _s), p in self.probed.items():
            by_idx.setdefault(i, []).append(p)
        out = []
        for i in sorted(by_idx):
            ps = by_idx[i]
            out.append(
                {
                    "value": self.grid[i],
                    "seeds": len(ps),
                    "failed": any(p.failed for p in ps),
                    "objective": round(
                        sum(float(p.objective) for p in ps) / len(ps), 6
                    ),
                }
            )
        return out

    def _value_fails(self, probes_of_value: list[Probe]) -> bool:
        """A value fails when ANY of its seeds failed (worst case — the
        breaking point is where the plan *can* break)."""
        return any(p.failed for p in probes_of_value)


class BisectDriver(SearchDriver):
    """W-section search for the first failing grid value.

    Bracket invariant: ``lo`` is the greatest index known to pass (-1:
    none yet), ``hi`` the least index known to fail (len(grid): none
    yet). Each round probes ``values_per_round`` evenly spaced interior
    indices (the first round spans the whole grid, endpoints included),
    shrinking the bracket by a factor of probes+1 per round — at most
    ``ceil(log2(grid)) + 1`` rounds even at width 1."""

    def __init__(self, spec) -> None:
        super().__init__(spec)
        self.lo = -1
        self.hi = len(self.grid)
        self.non_monotone = False

    def default_max_rounds(self) -> int:
        # the +2 is a safety net over the analytic bound; the acceptance
        # bound (<= ceil(log2 G) + 1 rounds USED) holds by construction
        return max(2, math.ceil(math.log2(len(self.grid)))) + 2

    def _within_tolerance(self) -> bool:
        tol = float(self.spec.tolerance)
        if not tol or not (0 <= self.lo and self.hi < len(self.grid)):
            return False
        return (
            float(self.grid[self.hi]) - float(self.grid[self.lo]) <= tol
        )

    def resolved(self) -> bool:
        return self.hi - self.lo <= 1 or self._within_tolerance()

    def next_probes(self, room: int) -> list[Probe]:
        interior = [
            i
            for i in range(self.lo + 1, self.hi)
            if (i, self.seed_list(i)[0]) not in self.probed
        ]
        if not interior:
            # every candidate in the bracket probed yet the bracket is
            # still open — only possible under non-monotone outcomes
            self.non_monotone = True
            self.stopped = self.stopped or "exhausted"
            return []
        k = min(self.values_per_round, len(interior))
        if not self.rounds:
            # round 0 spans the WHOLE grid including endpoints, so the
            # bracket (pass at lo, fail at hi) is established up front
            span = np.linspace(0, len(self.grid) - 1, num=max(2, k))
        else:
            span = np.linspace(self.lo, self.hi, num=k + 2)[1:-1]
        idxs = sorted({int(round(x)) for x in span} & set(interior))
        if not idxs:
            idxs = interior[:k]
        idxs = idxs[: self.values_per_round]
        return [
            Probe(value=self.grid[i], seed=s, index=i)
            for i in idxs
            for s in self.seed_list(i)
        ][:room]

    def digest(self, probes: list[Probe]) -> None:
        by_idx: dict[int, list[Probe]] = {}
        for p in probes:
            by_idx.setdefault(p.index, []).append(p)
        fails = sorted(
            i for i, ps in by_idx.items() if self._value_fails(ps)
        )
        passes = sorted(
            i for i, ps in by_idx.items() if not self._value_fails(ps)
        )
        if fails:
            if fails[0] <= self.lo:
                self.non_monotone = True
            self.hi = min(self.hi, fails[0])
        for i in passes:
            if i < self.hi:
                self.lo = max(self.lo, i)
            else:
                # a pass ABOVE a known fail: the axis is not monotone;
                # keep first-fail semantics but flag the verdict
                self.non_monotone = True
        if self.lo >= self.hi:
            self.lo = self.hi - 1

    def state_record(self) -> dict:
        rec = {
            "bracket": [
                self.grid[self.lo] if self.lo >= 0 else None,
                self.grid[self.hi] if self.hi < len(self.grid) else None,
            ]
        }
        if self.non_monotone:
            rec["non_monotone"] = True
        return rec

    def verdict(self) -> dict:
        out: dict = {
            "strategy": "bisect",
            "param": self.spec.param,
            "resolved": self.resolved(),
            "first_failing": (
                self.grid[self.hi] if self.hi < len(self.grid) else None
            ),
            "last_passing": self.grid[self.lo] if self.lo >= 0 else None,
        }
        if self.hi >= len(self.grid):
            out["survives"] = True  # no failure anywhere on the grid
        if self.spec.tolerance:
            out["tolerance"] = self.spec.tolerance
        if self.non_monotone:
            out["non_monotone"] = True
        if self.stopped:
            out["stopped"] = self.stopped
        return out


class HalvingDriver(SearchDriver):
    """Successive halving over the candidate grid.

    Rung r evaluates every survivor on ``seeds * 2^r`` FRESH seeds
    (cumulative objective = mean over all its seeds so far) and keeps
    the better half by ``goal`` — the per-survivor budget doubles as the
    field halves, Hyperband's allocation rule. One rung may span several
    fixed-width batches; the survivor cut happens only once the whole
    rung is observed. Deterministic: seeds enumerate from ``seed_base``
    per candidate, ties break toward the lower value."""

    def __init__(self, spec) -> None:
        super().__init__(spec)
        self.survivors = list(range(len(self.grid)))
        self.rung = 0
        self.scores: dict[int, list[float]] = {
            i: [] for i in self.survivors
        }
        self.seeds_used: dict[int, int] = {i: 0 for i in self.survivors}
        self._queue: list[Probe] = []
        self._outstanding = 0  # rung probes dispatched but not digested

    def default_max_rounds(self) -> int:
        rungs = max(1, math.ceil(math.log2(len(self.grid)))) + 1
        per_rung = len(self.grid) * self.seeds
        return rungs * (math.ceil(per_rung / self.width) + 1)

    def resolved(self) -> bool:
        return (
            len(self.survivors) == 1
            and not self._queue
            and not self._outstanding
        )

    def _fill_rung(self) -> None:
        for i in self.survivors:
            budget = self.seeds * (2 ** self.rung)
            start = int(self.spec.seed_base) + self.seeds_used[i]
            self.seeds_used[i] += budget
            self._queue.extend(
                Probe(value=self.grid[i], seed=start + j, index=i)
                for j in range(budget)
            )

    def next_probes(self, room: int) -> list[Probe]:
        if not self._queue:
            if self._outstanding or len(self.survivors) == 1:
                return []
            self._fill_rung()
        batch = self._queue[: min(self.width, room)]
        self._queue = self._queue[len(batch):]
        self._outstanding += len(batch)
        return batch

    def digest(self, probes: list[Probe]) -> None:
        for p in probes:
            self.scores[p.index].append(float(p.objective))
        self._outstanding -= len(probes)
        if self._queue or self._outstanding:
            return  # the rung is still in flight
        # rung complete: keep the better half (stable — ties toward the
        # LOWER value, so a fixed seed reproduces the survivor set)
        sign = 1.0 if self.spec.goal == "min" else -1.0

        def score(i: int) -> float:
            vals = self.scores[i]
            return sum(vals) / len(vals) if vals else 0.0

        keep = max(1, math.ceil(len(self.survivors) / 2))
        ranked = sorted(self.survivors, key=lambda i: (sign * score(i), i))
        self.survivors = sorted(ranked[:keep])
        self.rung += 1

    def state_record(self) -> dict:
        return {
            "rung": self.rung,
            "survivors": [self.grid[i] for i in self.survivors],
        }

    def verdict(self) -> dict:
        win = self.survivors[0]
        vals = self.scores[win]
        out = {
            "strategy": "halving",
            "param": self.spec.param,
            "resolved": self.resolved(),
            "winner": self.grid[win],
            "objective": round(
                sum(vals) / len(vals), 6
            ) if vals else None,
            "goal": self.spec.goal,
            "survivors": [self.grid[i] for i in self.survivors],
        }
        if self.stopped:
            out["stopped"] = self.stopped
        return out


class CoverageDriver(SearchDriver):
    """Coverage-directed sampling of the severity grid: one
    seed-deterministic permutation of the candidate indices, consumed
    ``values_per_round`` at a time — every round widens coverage, the
    frontier accumulates, and the whole sequence replays bit-for-bit
    from (spec.seed_base, grid)."""

    def __init__(self, spec) -> None:
        super().__init__(spec)
        rng = np.random.default_rng(
            (int(spec.seed_base), 0xC0FE, len(self.grid))
        )
        self.order = [int(i) for i in rng.permutation(len(self.grid))]
        self.ptr = 0

    def default_max_rounds(self) -> int:
        return math.ceil(len(self.grid) / self.values_per_round)

    def resolved(self) -> bool:
        return self.ptr >= len(self.order)

    def next_probes(self, room: int) -> list[Probe]:
        take = min(self.values_per_round, max(1, room // self.seeds))
        idxs = self.order[self.ptr : self.ptr + take]
        self.ptr += len(idxs)
        return [
            Probe(value=self.grid[i], seed=s, index=i)
            for i in idxs
            for s in self.seed_list(i)
        ][:room]

    def digest(self, probes: list[Probe]) -> None:
        pass  # coverage has no adaptive state beyond the frontier

    def state_record(self) -> dict:
        return {"covered": self.ptr, "grid": len(self.grid)}

    def verdict(self) -> dict:
        # one pass over the probed set: fold seeds per value, like
        # frontier() (the grid can be 64k values — no nested rescans)
        failed_idx: set[int] = set()
        covered: set[int] = set()
        for (i, _s), p in self.probed.items():
            covered.add(i)
            if p.failed:
                failed_idx.add(i)
        failing = [self.grid[i] for i in sorted(failed_idx)]
        out = {
            "strategy": "coverage",
            "param": self.spec.param,
            # a budget-capped coverage pass still resolves: partial
            # coverage is its deliverable
            "resolved": True,
            "coverage": round(len(covered) / max(1, len(self.grid)), 4),
            "first_failing_observed": failing[0] if failing else None,
            "failing_observed": len(failing),
        }
        if self.stopped:
            out["stopped"] = self.stopped
        return out


_DRIVERS = {
    "bisect": BisectDriver,
    "halving": HalvingDriver,
    "coverage": CoverageDriver,
}


def make_driver(spec) -> SearchDriver:
    """A validated driver for a [search] spec (sim/tables.py ``Search``
    or its dict form)."""
    from .tables import Search

    if isinstance(spec, dict):
        spec = Search.from_dict(spec)
    spec.validate()
    return _DRIVERS[spec.strategy](spec)


def run_search_loop(
    driver: SearchDriver,
    evaluate: Callable[[int, list[Probe]], None],
    first_batch: Optional[list[Probe]] = None,
    start_round: int = 0,
    on_round: Optional[Callable[[int, SearchDriver], None]] = None,
) -> dict:
    """The closed loop: ``evaluate(round_index, probes)`` dispatches ONE
    batch (filling each non-pad probe's outcome/objective/failed), the
    driver digests it and proposes the next. Returns the verdict.
    ``first_batch`` lets the caller compile the executor from round 0's
    batch before entering the loop.

    ``start_round`` continues a resumed search's round numbering, and
    ``on_round(r, driver)`` fires after each round is digested (where a
    runner would checkpoint the driver)."""
    r = start_round
    batch = first_batch if first_batch is not None else driver.next_batch()
    while batch is not None:
        evaluate(r, batch)
        driver.observe(batch)
        if on_round is not None:
            on_round(r, driver)
        r += 1
        batch = driver.next_batch()
    return driver.verdict()


# ------------------------------------------------------------ objectives


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted list
    (numpy's default method)."""
    if not sorted_vals:
        return 0.0
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def _stats(vals: list[float]) -> dict[str, float]:
    """The summary statistics of a series (the metrics viewer's)."""
    s = sorted(vals)
    return {
        "count": len(vals),
        "mean": sum(vals) / len(vals),
        "min": s[0],
        "max": s[-1],
        "p50": _percentile(s, 50),
        "p95": _percentile(s, 95),
        "p99": _percentile(s, 99),
    }


def objective_value(name: str, row: dict, telemetry_records=()) -> float:
    """One probed scenario's objective, drawn from its journal row (the
    per-scenario summary dict) or its demuxed telemetry records
    (``telemetry:<probe>:<stat>``)."""
    if name == "outcome":
        return 0.0 if row.get("outcome") == "success" else 1.0
    if name.startswith("telemetry:"):
        _t, probe, stat = name.split(":", 2)
        want = f"telemetry.{probe}"
        vals = [
            float(r["value"])
            for r in telemetry_records
            if r.get("name") == want
        ]
        if not vals:
            return 0.0
        return float(_stats(vals)[stat])
    v = row.get(name, 0)
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    try:
        return float(v or 0)
    except (TypeError, ValueError):
        return 0.0


# -------------------------------------------------------------- rebinder


class SearchRebinder:
    """Per-round host-leaf factory for the ONE built sweep executable:
    given a round's scenarios, compiles their fault plans (host-side
    numpy: the ``$param`` severities and seed-keyed victims resolve per
    probe) and, when the search axis rides ``env.params``, the per-combo
    param arrays (a Python plan build per NEW grid value, memoized:
    never a new build of the batched tick), then swaps them in via
    :meth:`SweepExecutable.rebind`."""

    def __init__(
        self, ex, faults, build_fn, groups, cfg,
        test_case: str = "", test_run: str = "", replay=None,
    ) -> None:
        from .tables import Faults, Replay

        if isinstance(faults, dict):
            faults = Faults.from_dict(faults)
        if faults is not None and (
            not faults.events or getattr(faults, "disabled", False)
        ):
            faults = None
        if isinstance(replay, dict):
            replay = Replay.from_dict(replay)
        if replay is not None and not replay.enabled:
            replay = None
        self.ex = ex
        self.faults = faults
        # [replay] table: per-probe schedule tensors recompile like the
        # fault plans do, so the search axis may ride a $scale/$time_scale
        # reference (the breaking point of a RECORDED workload)
        self.replay = replay
        self.build_fn = build_fn
        self.groups = groups
        self.cfg = cfg
        self.test_case = test_case
        self.test_run = test_run
        self._ctxs: dict = {}
        self._params: dict = {}
        self._ref_fp = None
        # the structural anchor is round 0's first combo — captured NOW,
        # because ex.scenarios mutates on every rebind
        self._anchor = (
            dict(ex.scenarios[0]["params"] or {}),
            int(ex.scenarios[0]["seed"]),
        )
        if ex._scen_params is not None:
            # pre-seed the memo with round 0's already-built combo rows:
            # re-probing a round-0 value costs no plan rebuild
            for i, sc in enumerate(ex.scenarios):
                self._params.setdefault(
                    self._combo_key(sc["params"]), ex._scen_params[i]
                )

    @staticmethod
    def _combo_key(params: dict) -> tuple:
        # the SAME keying compile_sweep used to build ex._scen_params —
        # the memo pre-seed below depends on them agreeing
        from .sweep import _combo_key

        return _combo_key(params)

    def _combo_ctx(self, key, params: dict):
        from .context import BuildContext, GroupSpec

        ctx = self._ctxs.get(key)
        if ctx is None:
            groups_c = [
                GroupSpec(
                    id=g.id,
                    index=g.index,
                    instances=g.instances,
                    parameters={**g.parameters, **(params or {})},
                )
                for g in self.groups
            ]
            ctx = self._ctxs[key] = BuildContext(
                groups_c, test_case=self.test_case, test_run=self.test_run
            )
        return ctx

    def _fingerprint(self, key, params: dict, seed: int):
        from .core import compile_program
        from .sweep import _program_fingerprint

        ex_c = compile_program(
            self.build_fn,
            self._combo_ctx(key, params),
            dataclasses.replace(self.cfg, seed=int(seed)),
            device=self.ex.device,
        )
        return ex_c, _program_fingerprint(ex_c)

    def _combo_env_params(self, sc: dict) -> dict:
        key = self._combo_key(sc["params"])
        row = self._params.get(key)
        if row is None:
            if self._ref_fp is None:
                # lazily build the reference fingerprint from the anchor
                # combo, compiled the same observer-free way as probes
                a_params, a_seed = self._anchor
                self._ref_fp = self._fingerprint(
                    self._combo_key(a_params), a_params, a_seed
                )
            names = list(self.ex._scen_params[0])
            ex_c, fp = self._fingerprint(key, sc["params"], sc["seed"])
            if fp != self._ref_fp[1]:
                raise SearchError(
                    f"search probe {dict(key)} changes the compiled "
                    "program's structure; every grid value must share "
                    "the plan statics (the sweep-plane combo contract)"
                )
            missing = [k for k in names if k not in ex_c.params]
            if missing:
                raise SearchError(
                    f"search probe {dict(key)} no longer exposes "
                    f"{missing} through env.params"
                )
            row = self._params[key] = {
                k: ex_c.params[k] for k in names
            }
        return row

    def leaves(self, scenarios: list[dict]):
        from .faults import compile_faults
        from .replay import compile_replay, merge_into_faults

        n = self.ex.base_ex.n
        rplans = None
        if getattr(self.ex, "_replay_plans", None) is not None:
            if self.replay is None:
                raise SearchError(
                    "the executable was compiled with replay plans but "
                    "the [replay] table is gone"
                )
            rplans = [
                compile_replay(
                    self.replay,
                    self._combo_ctx(
                        self._combo_key(sc["params"]), sc["params"]
                    ),
                    dataclasses.replace(self.cfg, seed=int(sc["seed"])),
                ).padded_to(n)
                for sc in scenarios
            ]
        fplans = None
        if self.ex._fault_plans is not None:
            if self.faults is None and (
                rplans is None or not rplans[0].has_churn
            ):
                raise SearchError(
                    "the executable was compiled with fault plans but "
                    "the schedule is gone"
                )
            fplans = [
                compile_faults(
                    self.faults,
                    self._combo_ctx(
                        self._combo_key(sc["params"]), sc["params"]
                    ),
                    dataclasses.replace(self.cfg, seed=int(sc["seed"])),
                )
                if self.faults is not None
                else None
                for sc in scenarios
            ]
            if rplans is not None:
                # recorded churn folds into each probe's fault plan —
                # the same merge compile_sweep applied at compile time
                fplans = [
                    merge_into_faults(rp, fp)
                    for rp, fp in zip(rplans, fplans)
                ]
            fplans = [p.padded_to(n) for p in fplans]
        params = None
        if self.ex._scen_params is not None:
            params = [self._combo_env_params(sc) for sc in scenarios]
        return params, fplans, rplans

    def rebind(self, scenarios: list[dict]) -> None:
        params, fplans, rplans = self.leaves(scenarios)
        self.ex.rebind(
            scenarios, per_scenario_params=params, fault_plans=fplans,
            replay_plans=rplans,
        )
