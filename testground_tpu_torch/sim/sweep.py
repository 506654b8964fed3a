"""Scenario-batched execution: one batched program sweeps many scenarios.

Counterpart of ``testground_tpu/sim/sweep.py``. A sweep turns S
near-identical runs (a 64-seed churn study, a parameter grid) into ONE
program with a leading ``scenario`` axis on every state leaf: the loop
iteration ``SimExecutable.guarded_tick`` batched over that axis with
``torch.func.vmap``. The per-scenario degrees of freedom ride in the
state: ``rng_key`` (the scenario's PRNG root, uint32 ``[S, 2]`` as in
JAX), ``kill_tick`` (its churn schedule), ``params`` (the param arrays
that vary across the grid), the fault plan's and the replay plan's
tensors. So one build of the batched tick serves every scenario, and on
the card one CUDA-graph capture of it serves the whole sweep: every
chunk of scenarios, and every round of a search (``rebind``), loads its
fresh state into the captured tensors and replays the same graph.

Exactness contract (tested): scenario *s* of a batched run is
bit-identical to a serial run with the same seed and params, and to the
JAX sweep's scenario *s*. The guard freezes a finished scenario (its
``go`` is its own, an ``[S]`` mask under vmap), every reduction of the
tick runs over one scenario's lanes, and the two hand-written kernels on
the path (the count scatter and the ring merge) carry a vmap rule that
folds the scenarios into one launch whose rows are each scenario's own,
in its serial lane order (sim/count_scatter.py, sim/ring_merge.py). The
batched tick runs with functorch's per-scenario loop fallback off, so an
op with no batching rule raises instead of running once per scenario
(:func:`_batched_only`). The fused deliver front (``pallas_front=True``) stays serial-only, as in
JAX.

One card: the ``[sweep] mesh`` may only be ``[1, 1]`` (the 2-D mesh is
item 12 of ROADMAP.md). When the x-chunk state does not fit the card,
:func:`sweep_preflight` halves the scenario chunk; the chunks run one
after another through the same capture.

Swept test-params must reach phases through ``env.params``. Params read
through ``ctx.static_param_*`` are baked into the program and cannot
vary across the scenarios of one build; :func:`compile_sweep` refuses
such grids.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .context import BuildContext, GroupSpec
from .core import (
    SimConfig,
    SimExecutable,
    SimResult,
    _leaves,
    capture_step,
    churn_kill_tick,
    compile_program,
    live_lanes,
    merge_kill_ticks,
)
from .faults import compile_faults
from .program import PAD, _not_ported
from .replay import compile_replay, merge_into_faults
from .tables import Faults, Replay

# builds of the batched tick (one per sweep executable; a rebound
# executable keeps its build, so a whole search moves this by one)
_CHUNK_COMPILES = 0

# the share of the card's free memory the x-chunk state may take: the
# captured tick makes about one more state's worth of temporaries (the
# guard's select), and a finished chunk is cloned out
SWEEP_MEMORY_FRACTION = 0.4


def chunk_compiles() -> int:
    """How many batched ticks have been BUILT in this process. A rebound
    executable (``SweepExecutable.rebind``) keeps its build, so a whole
    breaking-point search moves this counter by exactly one."""
    return _CHUNK_COMPILES


def _combo_key(params: dict) -> tuple:
    return tuple(sorted((params or {}).items()))


def _program_fingerprint(ex: SimExecutable) -> tuple:
    """Structural identity of a built program: scenarios batched into
    one program must agree on everything that shapes the tick."""

    def _init_digest(init):
        # a content hash: differing mem inits must not fingerprint equal
        a = np.asarray(init)
        return (a.shape, str(a.dtype), hashlib.sha256(a.tobytes()).hexdigest())

    prog = ex.program
    return (
        tuple(p.name for p in prog.phases),
        tuple(
            (name, tuple(shape), str(dtype), _init_digest(init))
            for name, (shape, dtype, init) in sorted(prog.mem_spec.items())
        ),
        prog.states.count,
        tuple(prog.topics.specs()),
        repr(prog.net_spec),
        prog.churn_sids,
        prog.churn_tids,
        tuple(
            (k, np.shape(v), str(np.asarray(v).dtype))
            for k, v in sorted(ex.params.items())
        ),
        ex.faults.structure() if ex.faults is not None else None,
        ex.trace.structure() if ex.trace is not None else None,
        ex.telemetry.structure() if ex.telemetry is not None else None,
        ex.replay.structure() if ex.replay is not None else None,
    )


def _check_mesh(mesh_shape) -> None:
    if mesh_shape is not None and [int(v) for v in mesh_shape] != [1, 1]:
        raise _not_ported(
            f"[sweep] mesh = {list(mesh_shape)} (a 2-D scenario x instance "
            "mesh beyond [1, 1])", 12, "multi-GPU")


def compile_sweep(
    build_fn: Callable,
    groups: list[GroupSpec],
    cfg: SimConfig,
    scenarios: list[dict],
    test_case: str = "",
    test_run: str = "",
    chunk: int = 0,
    faults=None,
    trace=None,
    telemetry=None,
    mesh_shape=None,
    replay=None,
    device="cuda",
) -> "SweepExecutable":
    """Build ONE scenario-batched executable for ``scenarios`` on
    ``device``.

    Each scenario is ``{"seed": int, "params": {name: str-value}}``
    (sim/tables.py ``Sweep.expand``). The plan is built once per
    DISTINCT param combo (to collect that combo's ``env.params`` arrays
    and to check that the program structure is combo-invariant); the
    batched tick is combo 0's. ``chunk`` bounds the scenarios a dispatch
    runs (0 = all at once).

    ``faults`` (sim/tables.py ``Faults`` or its dict form) compiles to
    one FaultPlan PER SCENARIO (kill victims are seed-keyed, and
    ``$param`` references resolve against each scenario's params),
    whose tensors ride the scenario axis. ``trace`` and ``telemetry``
    turn their planes on for every scenario: their rings and sample
    buffers are state leaves, so each scenario demuxes its own. ``replay``
    compiles to one ReplayPlan per scenario, whose churn merges into the
    scenario's fault plan; its table shape must be scenario-invariant
    (a ``$scale`` grid needs an explicit ``replay.capacity``).
    ``mesh_shape`` may be None or ``[1, 1]``: one card."""
    if not scenarios:
        raise ValueError("sweep has no scenarios")
    if cfg.slices > 1:
        raise ValueError("scenario sweeps do not support slices > 1")
    if cfg.pallas_front is True:
        raise ValueError(
            "scenario sweeps do not support pallas_front=True (pallas_call "
            "has no batching rule for the sweep vmap)"
        )
    _check_mesh(mesh_shape)
    resolve_device(device)

    if isinstance(faults, dict):
        faults = Faults.from_dict(faults)
    if faults is not None and not faults.events:
        faults = None
    fault_refs = faults.param_refs() if faults is not None else set()
    if faults is not None and getattr(faults, "disabled", False):
        # the --no-faults leg: nothing compiles, but its $param
        # references keep counting as consumed
        faults = None

    if isinstance(replay, dict):
        replay = Replay.from_dict(replay)
    replay_refs = replay.param_refs() if replay is not None else set()
    if replay is not None and not replay.enabled:
        replay = None

    swept_names = sorted({k for sc in scenarios for k in (sc["params"] or {})})
    exes: dict[tuple, SimExecutable] = {}
    ctxs: dict[tuple, BuildContext] = {}
    combo_of: list[tuple] = []
    fault_plans: list = []
    replay_plans: list = []
    for sc in scenarios:
        key = _combo_key(sc["params"])
        is_new_combo = key not in exes
        cfg_s = dataclasses.replace(cfg, seed=int(sc["seed"]))
        if is_new_combo:
            groups_c = [
                GroupSpec(
                    id=g.id,
                    index=g.index,
                    instances=g.instances,
                    parameters={**g.parameters, **(sc["params"] or {})},
                )
                for g in groups
            ]
            ctxs[key] = BuildContext(
                groups_c, test_case=test_case, test_run=test_run
            )
        # one fault-plan compile a scenario (victims are seed-keyed)
        fp = (compile_faults(faults, ctxs[key], cfg_s)
              if faults is not None else None)
        # one replay-plan compile a scenario; its churn rows merge into
        # the scenario's fault plan (minting one when there is none)
        rp = (compile_replay(replay, ctxs[key], cfg_s)
              if replay is not None else None)
        fp = merge_into_faults(rp, fp)
        if is_new_combo:
            ctx_c = ctxs[key]
            exes[key] = compile_program(
                build_fn, ctx_c, cfg_s, device=device, faults=fp,
                trace=trace, telemetry=telemetry, replay=rp,
            )
            baked = set(swept_names) & ctx_c.static_param_reads
            if baked:
                raise ValueError(
                    f"sweep grid over {sorted(baked)} is impossible: the "
                    "plan consumes these via ctx.static_param_* so they "
                    "are baked into the compiled program as constants. "
                    "Only params exposed through env.params (the dict the "
                    "build function returns) can vary per scenario."
                )
            # names the fault schedule or the replay scalings reference
            # ($param) count as consumed: they vary through the tensors
            missing = [
                k for k in swept_names
                if k not in exes[key].params
                and k not in fault_refs
                and k not in replay_refs
            ]
            if missing:
                raise ValueError(
                    f"sweep grid over {missing} is impossible: the plan "
                    "does not expose these through env.params, so a "
                    "batched run could not vary them per scenario. Expose "
                    "them from the build function (return "
                    "{'name': ctx.param_array_*(...)}) or drop the grid."
                )
        combo_of.append(key)
        if fp is not None:
            fault_plans.append(fp)
        if rp is not None:
            replay_plans.append(rp)
    if fault_plans:
        base_struct = fault_plans[0].structure()
        for s, p in enumerate(fault_plans):
            if p.structure() != base_struct:
                raise ValueError(
                    f"fault schedule changes structure across scenarios "
                    f"(scenario {s} differs from scenario 0): window "
                    "pairing, shaping capabilities and kill/restart "
                    "presence must be scenario-invariant — only "
                    "magnitudes and timings may vary via $param grids"
                )
    if replay_plans:
        base_rp = replay_plans[0].structure()
        for s, p in enumerate(replay_plans):
            if p.structure() != base_rp:
                raise ValueError(
                    f"replay schedule changes structure across scenarios "
                    f"(scenario {s} differs from scenario 0): the "
                    "compiled [N, capacity, 3] arrival table and churn "
                    "presence must be scenario-invariant — declare an "
                    "explicit replay.capacity sized for the largest "
                    "$scale in the grid (docs/replay.md 'Sizing')"
                )

    fps = {k: _program_fingerprint(ex) for k, ex in exes.items()}
    base_key = _combo_key(scenarios[0]["params"])
    for k, fp in fps.items():
        if fp != fps[base_key]:
            raise ValueError(
                "sweep param grid changes the compiled program's structure "
                f"(combo {dict(k)} differs from combo {dict(base_key)}); "
                "scenarios of one sweep must share plan statics"
            )
    # only the env.params arrays that DIFFER across combos ride the
    # scenario axis, checked by value (a plan may derive a returned
    # array from a swept param under another name)
    base_params = exes[base_key].params
    varying = [
        name for name in base_params
        if any(
            not np.array_equal(np.asarray(exes[k].params[name]),
                               np.asarray(base_params[name]))
            for k in exes
        )
    ]
    per_scenario_params = (
        [{name: exes[k].params[name] for name in varying} for k in combo_of]
        if varying else None
    )
    base_n = exes[base_key].n
    fault_plans = [p.padded_to(base_n) for p in fault_plans]
    replay_plans = [p.padded_to(base_n) for p in replay_plans]
    return SweepExecutable(
        exes[base_key],
        scenarios,
        per_scenario_params,
        chunk=chunk,
        fault_plans=fault_plans if fault_plans else None,
        replay_plans=replay_plans if replay_plans else None,
    )


def _batched_only(fn):
    """``fn`` run with functorch's vmap fallback off: an op with no
    batching rule raises rather than looping over the scenarios (on the
    card the capture runs it, so a loop can never be captured)."""
    functorch = torch._C._functorch

    def step(st):
        prev = functorch._is_vmap_fallback_enabled()
        functorch._set_vmap_fallback_enabled(False)
        try:
            return fn(st)
        finally:
            functorch._set_vmap_fallback_enabled(prev)

    return step


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tree_copy_(dst: dict, src: dict) -> None:
    """Copy every leaf of ``src`` into ``dst``'s tensor in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _tree_copy_(dst[k], v)
        else:
            dst[k].copy_(v)


def state_bytes(ex: SimExecutable) -> int:
    """The bytes of ``ex``'s initial state, from shapes alone (built on
    the meta device: nothing is allocated)."""
    dev = ex.device
    ex.device = torch.device("meta")
    try:
        st = ex.init_state()
    finally:
        ex.device = dev
    return sum(v.numel() * v.element_size() for v in _leaves(st))


class SweepExecutable:
    """A built scenario batch, ready to run: the surface of
    :class:`SimExecutable` (``config``, ``run``, ``ctx``, ``program``,
    ``init_state``) over S scenarios a dispatch."""

    def __init__(
        self,
        base_ex: SimExecutable,
        scenarios: list[dict],
        per_scenario_params: Optional[list[dict]],
        chunk: int = 0,
        fault_plans: Optional[list] = None,
        replay_plans: Optional[list] = None,
    ) -> None:
        self.base_ex = base_ex
        self.scenarios = scenarios
        self.n_scenarios = len(scenarios)
        self._scen_params = per_scenario_params
        # per-scenario compiled schedules, aligned with ``scenarios``;
        # their tensors stack onto the scenario axis (_scenario_leaves)
        self._fault_plans = fault_plans
        self._replay_plans = replay_plans
        self.chunk_size = (min(int(chunk), self.n_scenarios) if chunk
                           else self.n_scenarios)
        self.n_chunks = math.ceil(self.n_scenarios / self.chunk_size)
        self._step_fn = None
        self._leaves_cache: dict = {}
        # the captured stepper and the state tensors it advances (on the
        # card): every chunk and every rebound round loads into them
        self._stepper = None
        self._captured = None
        # CUDA-graph captures of the batched loop iteration (one a sweep)
        # and the seconds the capture took
        self.captures = 0
        self.capture_seconds = 0.0

    @property
    def config(self) -> SimConfig:
        return self.base_ex.config

    @property
    def device(self) -> torch.device:
        return self.base_ex.device

    @property
    def ctx(self) -> BuildContext:
        return self.base_ex.ctx

    @property
    def program(self):
        return self.base_ex.program

    @property
    def event_skip(self) -> bool:
        return self.base_ex.event_skip

    @property
    def trace(self):
        """The TraceSpec (scenario-invariant), or None untraced."""
        return self.base_ex.trace

    @property
    def telemetry(self):
        """The TelemetrySpec (scenario-invariant), or None unsampled."""
        return self.base_ex.telemetry

    @property
    def replay(self):
        """The base scenario's ReplayPlan (its structure is
        scenario-invariant), or None without a [replay] table."""
        return self.base_ex.replay

    @property
    def n(self) -> int:
        return self.base_ex.n

    # ------------------------------------------------------------- rebind

    def rebind(
        self,
        scenarios: list[dict],
        per_scenario_params: Optional[list[dict]] = None,
        fault_plans: Optional[list] = None,
        replay_plans: Optional[list] = None,
    ) -> None:
        """Swap the per-scenario leaves (seeds, params, fault and replay
        tensors) under the already-built batched tick, so the next
        :meth:`run` replays the SAME capture with fresh scenario state:
        a closed-loop search (sim/search.py) costs one build and one
        capture for all its rounds. The new batch must match the built
        shape exactly; a mismatch raises."""
        if len(scenarios) != self.n_scenarios:
            raise ValueError(
                f"rebind needs exactly {self.n_scenarios} scenarios "
                f"(the compiled batch shape), got {len(scenarios)}"
            )
        if (per_scenario_params is None) != (self._scen_params is None):
            raise ValueError(
                "rebind param structure mismatch: the executable was "
                "compiled "
                + (
                    "with varying per-scenario params"
                    if self._scen_params is not None
                    else "without per-scenario params"
                )
            )
        if per_scenario_params is not None:
            if len(per_scenario_params) != len(scenarios):
                raise ValueError("rebind needs one params row per scenario")
            base = self._scen_params[0]
            for row in per_scenario_params:
                if set(row) != set(base):
                    raise ValueError(
                        f"rebind param keys {sorted(row)} differ from "
                        f"the compiled batch's {sorted(base)}"
                    )
                for k, v in row.items():
                    a, b = np.asarray(v), np.asarray(base[k])
                    if a.shape != b.shape or a.dtype != b.dtype:
                        raise ValueError(
                            f"rebind param {k!r} shape/dtype "
                            f"{a.shape}/{a.dtype} differs from the "
                            f"compiled {b.shape}/{b.dtype}"
                        )
        if (fault_plans is None) != (self._fault_plans is None):
            raise ValueError(
                "rebind fault-plan structure mismatch: the executable "
                "was compiled "
                + (
                    "with a fault schedule"
                    if self._fault_plans is not None
                    else "without one"
                )
            )
        if fault_plans is not None:
            if len(fault_plans) != len(scenarios):
                raise ValueError("rebind needs one fault plan per scenario")
            base_struct = self._fault_plans[0].structure()
            for i, p in enumerate(fault_plans):
                if p.structure() != base_struct:
                    raise ValueError(
                        f"rebind fault plan {i} changes structure — "
                        "only magnitudes and timings may vary per probe"
                    )
        if (replay_plans is None) != (self._replay_plans is None):
            raise ValueError(
                "rebind replay-plan structure mismatch: the executable "
                "was compiled "
                + (
                    "with a replay schedule"
                    if self._replay_plans is not None
                    else "without one"
                )
            )
        if replay_plans is not None:
            if len(replay_plans) != len(scenarios):
                raise ValueError("rebind needs one replay plan per scenario")
            base_rp = self._replay_plans[0].structure()
            for i, p in enumerate(replay_plans):
                if p.structure() != base_rp:
                    raise ValueError(
                        f"rebind replay plan {i} changes structure — "
                        "the compiled arrival-table shape is fixed; "
                        "declare an explicit replay.capacity sized for "
                        "every probed $scale (docs/replay.md 'Sizing')"
                    )
        self.scenarios = scenarios
        self._scen_params = per_scenario_params
        self._fault_plans = fault_plans
        self._replay_plans = replay_plans
        self._leaves_cache.clear()

    # ------------------------------------------------------ initial state

    def _chunk_scenarios(self, ci: int) -> list[dict]:
        """Scenarios of chunk ``ci``, padded to chunk_size by repeating
        scenario 0 (padding results are dropped at demux)."""
        lo = ci * self.chunk_size
        chunk = self.scenarios[lo: lo + self.chunk_size]
        return chunk + [self.scenarios[0]] * (self.chunk_size - len(chunk))

    def _scenario_leaves(self, ci: int):
        """Host-side per-scenario leaves of chunk ``ci``: stacked kill
        ticks, seeds, the live-scenario mask (the padding rows of the
        last chunk are dead on arrival), the varying param arrays, and
        the fault and replay tensors. Chunk 0's are memoized."""
        if ci in self._leaves_cache:
            return self._leaves_cache[ci]
        chunk = self._chunk_scenarios(ci)
        cfg, gids = self.config, self.base_ex.ctx.group_ids
        lo = ci * self.chunk_size

        def rows_of(plans):
            return [plans[lo + i] if lo + i < self.n_scenarios else plans[0]
                    for i in range(self.chunk_size)]

        fplans = (rows_of(self._fault_plans)
                  if self._fault_plans is not None else None)
        kill = np.stack([
            churn_kill_tick(dataclasses.replace(cfg, seed=int(sc["seed"])),
                            gids)
            for sc in chunk
        ])
        if fplans is not None:
            # fault-plane kills merge per scenario (earliest wins), as
            # the serial init_state does for that seed
            kill = np.stack([merge_kill_ticks(kill[i], fplans[i].kill_tick)
                             for i in range(len(fplans))])
        seeds = np.asarray([int(sc["seed"]) for sc in chunk], np.uint32)
        live = np.asarray([lo + i < self.n_scenarios
                           for i in range(self.chunk_size)])
        params = None
        if self._scen_params is not None:
            rows = rows_of(self._scen_params)
            params = {k: np.stack([np.asarray(r[k]) for r in rows])
                      for k in rows[0]}
        fleaves = None
        if fplans is not None:
            rows_f = [p.dynamic_leaves() for p in fplans]
            if rows_f[0]:
                fleaves = {k: np.stack([r[k] for r in rows_f])
                           for k in rows_f[0]}
        rleaves = None
        if self._replay_plans is not None:
            rows_r = [p.dynamic_leaves()
                      for p in rows_of(self._replay_plans)]
            rleaves = {k: np.stack([r[k] for r in rows_r])
                       for k in rows_r[0]}
        out = (kill, seeds, live, params, fleaves, rleaves)
        if ci == 0:
            # only chunk 0 is read again (the pre-flight, the run start)
            self._leaves_cache[ci] = out
        return out

    def init_state(self, ci: int = 0) -> dict:
        """Chunk ``ci``'s stacked initial state, ``[C, ...]`` on every
        leaf, on the executable's device."""
        kill, seeds, live, params, fleaves, rleaves = \
            self._scenario_leaves(ci)
        dev, C = self.device, self.chunk_size
        base = self.base_ex.init_state()
        # the scenario-invariant state, broadcast; the per-scenario
        # leaves overwrite their slots
        st = _tree_map(
            lambda x: x.unsqueeze(0).expand(C, *x.shape).contiguous(), base)

        def dev_t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        st["kill_tick"] = dev_t(kill)
        st["rng_key"] = dev_t(np.stack(
            [np.zeros_like(seeds), seeds], axis=1))
        # padding scenarios are frozen from tick 0
        st["status"] = torch.where(dev_t(live)[:, None], st["status"], PAD)
        if params is not None:
            st["params"] = {k: dev_t(v) for k, v in params.items()}
        if fleaves is not None:
            st["faults"] = {k: dev_t(v) for k, v in fleaves.items()}
        if rleaves is not None:
            st["replay"] = {**st["replay"],
                            **{k: dev_t(v) for k, v in rleaves.items()}}
        return st

    def state_model_bytes(self) -> int:
        """The scenario-batched state's bytes, from shapes: chunk x the
        base state, plus the sweep's own leaves (``rng_key`` and the
        varying params)."""
        total = self.chunk_size * state_bytes(self.base_ex)
        total += self.chunk_size * 2 * 4  # rng_key [C, 2] uint32
        if self._scen_params is not None:
            row = self._scen_params[0]
            total += self.chunk_size * sum(
                int(np.prod(np.shape(v))) * np.asarray(v).dtype.itemsize
                for v in row.values()
            )
        return total

    # ------------------------------------------------------------ running

    def _compile_chunk(self):
        """The batched loop iteration: ``guarded_tick`` vmapped over the
        scenario axis with no loop fallback (built once; counted in
        ``chunk_compiles``)."""
        if self._step_fn is not None:
            return self._step_fn
        global _CHUNK_COMPILES
        _CHUNK_COMPILES += 1
        self.base_ex.tick_fn()
        self._step_fn = _batched_only(
            torch.func.vmap(self.base_ex.guarded_tick))
        return self._step_fn

    def chunk_stepper(self, ci: int = 0):
        """(state, step) for chunk ``ci``: ``step(state)`` advances the
        batched state by one loop iteration and returns it. On the card
        the chunk's state is loaded into the captured tensors (captured on
        first use) and ``step`` replays the graph; on the CPU the state is
        fresh and ``step`` is the batched iteration itself."""
        step = self._compile_chunk()
        st = self.init_state(ci)
        if self.device.type != "cuda":
            return st, step
        if self._stepper is None:
            t0 = time.monotonic()
            self._stepper = capture_step(step, st, self.device)
            self._captured = st
            self.captures += 1
            torch.cuda.synchronize(self.device)
            self.capture_seconds = time.monotonic() - t0
            return st, self._stepper
        _tree_copy_(self._captured, st)
        return self._captured, self._stepper

    def run(
        self, on_chunk=None, drain=None, should_stop=None,
        watchdog=None, checkpoint=None, resume=None,
    ) -> "SweepResult":
        """Run every scenario chunk to completion: ``chunk_ticks`` batched
        loop iterations between two host reads of the termination
        condition. ``drain`` / ``on_chunk`` / ``should_stop`` follow the
        :meth:`SimExecutable.run` contract at every boundary, with the
        batched state (a drain streams each row to its own scenario
        directory) and, in ``info``, the ``[C, N]`` live-lane mask and
        the chunk's position; a should_stop() ends the run with the
        drained prefix kept (never-run chunks stay None in
        ``SweepResult.chunk_states``). ``watchdog``, ``checkpoint`` and
        ``resume`` belong to the durability plane, not ported yet."""
        for what, v in (("watchdog", watchdog), ("checkpoint", checkpoint),
                        ("resume", resume)):
            if v is not None:
                raise _not_ported(f"SweepExecutable.run({what}=...)", 11,
                                  "runner and serving integration")
        cfg = self.config
        has_restarts = self.base_ex.has_restarts
        skip = self.base_ex.event_skip
        cuda = self.device.type == "cuda"
        terminated = False
        finals: list = []
        wall = 0.0
        captures = self.captures
        for ci in range(self.n_chunks):
            if terminated:
                break
            st, step = self.chunk_stepper(ci)
            if cuda:
                torch.cuda.synchronize(self.device)
            # the capture is set-up, as in SimExecutable.run: each
            # chunk's clock starts after its state is loaded
            wall0 = time.monotonic()
            while True:
                for _ in range(max(1, cfg.chunk_ticks)):
                    st = step(st)
                ticks_h = st["tick"].cpu().numpy()
                lv = live_lanes(st, has_restarts)  # [C, N]
                live_scen = lv.any(dim=-1).cpu().numpy()
                running = int(torch.sum(lv))
                tick = int(ticks_h.max())
                if drain is not None:
                    # each batched row streams to its own scenario
                    # directory before the cursors reset in place
                    st = drain.drain(st, chunk=ci)
                if on_chunk is not None:
                    info = {
                        "state": st,
                        "live_lanes": lv,
                        "chunk": ci,
                        "n_chunks": self.n_chunks,
                        "n_scenarios": self.n_scenarios,
                    }
                    if drain is not None:
                        info["observer"] = drain.stats()
                    on_chunk(tick, running, info)
                if skip:
                    # each scenario's executed budget decouples its tick:
                    # exit once every LIVE scenario reached the horizon
                    done = running == 0 or bool(
                        (ticks_h[live_scen] >= cfg.max_ticks).all())
                else:
                    done = running == 0 or tick >= cfg.max_ticks
                stopping = should_stop is not None and should_stop()
                if done:
                    break
                if stopping:
                    terminated = True
                    break
            if cuda:
                torch.cuda.synchronize(self.device)
            wall += time.monotonic() - wall0
            # the captured tensors are reused by the next chunk or run
            finals.append(_tree_map(torch.clone, st) if cuda else st)
        finals.extend([None] * (self.n_chunks - len(finals)))
        return SweepResult(
            self, finals, wall_seconds=wall, terminated=terminated,
            capture_seconds=(self.capture_seconds
                             if self.captures > captures else 0.0))


@dataclass
class SweepResult:
    """The final states of every scenario chunk; each scenario demuxes
    into an ordinary :class:`SimResult`."""

    executable: SweepExecutable
    chunk_states: list
    wall_seconds: float = 0.0
    # a should_stop() hook ended the run early: the trailing
    # chunk_states are None (never dispatched)
    terminated: bool = False
    # the capture of the batched iteration this run made (on the card,
    # at the executable's first run; 0 after), not in wall_seconds
    capture_seconds: float = 0.0

    def has_scenario(self, s: int) -> bool:
        """Whether scenario ``s``'s chunk was dispatched (False for the
        never-run tail of a terminated sweep or a released chunk)."""
        if not 0 <= s < self.executable.n_scenarios:
            return False
        return self.chunk_states[s // self.executable.chunk_size] is not None

    def scenario(self, s: int) -> SimResult:
        if not 0 <= s < self.executable.n_scenarios:
            raise IndexError(f"scenario {s} out of range")
        C = self.executable.chunk_size
        st = self.chunk_states[s // C]
        if st is None:
            raise ValueError(f"scenario {s}: chunk already released")
        off = s % C
        return SimResult(
            self.executable.base_ex,
            _tree_map(lambda x: x[off], st),
            wall_seconds=self.wall_seconds / self.executable.n_scenarios,
        )

    def release_chunk(self, ci: int) -> None:
        """Drop chunk ``ci``'s state once its scenarios are demuxed. Read
        aggregate properties (``ticks``) before releasing."""
        self.chunk_states[ci] = None

    def __iter__(self):
        for s in range(self.executable.n_scenarios):
            yield self.scenario(s)

    @property
    def ticks(self) -> int:
        return max(int(st["tick"].max())
                   for st in self.chunk_states if st is not None)


def sweep_preflight(
    make_sweep: Callable[[SimConfig, int], SweepExecutable],
    cfg: SimConfig,
    n_scenarios: int,
    explicit_chunk: int = 0,
    budget: Optional[int] = None,
    allow_shrink: bool = True,
    log=lambda msg: None,
    trace_tiers=None,
    telemetry_tiers=None,
):
    """The memory pre-flight of a sweep: the state scales x chunk, so
    walk scenario-chunk sizes largest first (the full batch, then
    halvings) and take the first whose state model
    (``SweepExecutable.state_model_bytes``) fits ``budget`` bytes (by
    default ``SWEEP_MEMORY_FRACTION`` of the card's free memory, from
    ``torch.cuda.mem_get_info``; no bound on the CPU). ``make_sweep(cfg,
    chunk)`` builds an executable; returns ``(executable, report)``.

    The metrics-ring shrink (``allow_shrink``, tried only when even
    chunk 1 does not fit) and the trace and telemetry tier ladders go
    through the runner's pre-flight, item 11 of ROADMAP.md: they raise
    naming it."""
    if trace_tiers is not None or telemetry_tiers is not None:
        raise _not_ported("sweep_preflight's trace and telemetry tiers", 11,
                          "runner and serving integration")
    if explicit_chunk:
        ladder = [min(explicit_chunk, n_scenarios)]
    else:
        ladder = []
        c = n_scenarios
        while c >= 1:
            ladder.append(c)
            if c == 1:
                break
            c = math.ceil(c / 2)
    built = None
    for chunk in ladder:
        if built is None:
            ex = built = make_sweep(cfg, chunk)
        else:
            ex = SweepExecutable(
                built.base_ex, built.scenarios, built._scen_params,
                chunk=chunk, fault_plans=built._fault_plans,
                replay_plans=built._replay_plans,
            )
        if budget is None and ex.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(ex.device)
            budget = int(free * SWEEP_MEMORY_FRACTION)
        total = ex.state_model_bytes()
        if budget is not None and total > budget:
            log(f"pre-flight: chunk {chunk} needs {total} bytes, over the "
                f"{budget}-byte budget")
            continue
        report = {
            "scenarios": n_scenarios,
            "scenario_chunk": chunk,
            "mesh_shape": {"scenario": 1, "instance": 1},
            "scenario_chunk_padded": ex.chunk_size,
            "instances_padded": ex.base_ex.n,
            "state_model_bytes": total,
            "state_model_bytes_per_axis": {
                "scenario_row": total, "instance_shard": total,
            },
            "budget_bytes": budget,
        }
        rp = ex.base_ex.replay
        if rp is not None:
            report["replay_bytes"] = ex.chunk_size * rp.model_bytes()
        if chunk < n_scenarios and not explicit_chunk:
            log(f"pre-flight: sweep chunked to {chunk} scenarios per "
                f"dispatch ({math.ceil(n_scenarios / chunk)} chunks)")
        return ex, report
    if allow_shrink:
        raise _not_ported("sweep_preflight's metrics-ring shrink", 11,
                          "runner and serving integration")
    raise RuntimeError(
        f"sweep pre-flight: even one scenario's state does not fit the "
        f"{budget}-byte budget"
    )
