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
:func:`sweep_preflight` halves the scenario chunk (and, only when even
one scenario does not fit, shrinks the metrics ring); the chunks run one
after another through the same capture. ``SweepExecutable.run`` carries
the durability plane: a watchdog around every chunk, a checkpoint at
every boundary with the completed chunks' finals, and a resume into a
checkpointed chunk that copies the saved state into the captured
tensors.

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
    POLL_TICKS,
    SimConfig,
    SimExecutable,
    SimResult,
    _copy_into,
    _leaves,
    capture_step,
    churn_kill_tick,
    compile_program,
    live_lanes,
    merge_kill_ticks,
)
from .faults import compile_faults
from .program import PAD, _not_ported
from .state_io import state_from_numpy
from .replay import compile_replay, merge_into_faults
from .tables import Faults, Replay

# builds of the batched tick (one per sweep executable; a rebound
# executable keeps its build, so a whole search moves this by one)
_CHUNK_COMPILES = 0

# the share of the card's free memory the x-chunk state may take: the
# captured tick makes about one more state's worth of temporaries (the
# guard's select), and the last chunk's final state is cloned out
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
        # warmup's build and capture seconds (None when it did neither)
        self.compile_breakdown = None

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

    def chunk_stepper(self, ci: int = 0, start=None):
        """(state, step) for chunk ``ci``: ``step(state)`` advances the
        batched state by one loop iteration and returns it. The state is
        the chunk's initial one, or ``start`` (a checkpoint's host
        leaves). On the card it is loaded into the captured tensors
        (captured on first use) and ``step`` replays the graph; on the
        CPU the state is fresh and ``step`` is the batched iteration
        itself."""
        step = self._compile_chunk()
        cuda = self.device.type == "cuda"
        if cuda and self._stepper is not None:
            _copy_into(self._captured,
                       self.init_state(ci) if start is None else start)
            return self._captured, self._stepper
        st = (self.init_state(ci) if start is None
              else state_from_numpy(start, self.device))
        if not cuda:
            return st, step
        t0 = time.monotonic()
        self._stepper = capture_step(step, st, self.device)
        self._captured = st
        self.captures += 1
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.monotonic() - t0
        return st, self._stepper

    def release_capture(self) -> None:
        """Drop the capture (and the memory it holds): the next chunk
        captures again (the captured guard bakes ``max_ticks`` in)."""
        self._stepper = None
        self._captured = None

    def warmup(self) -> float:
        """Build the batched iteration and, on the card, capture it on
        chunk 0's initial state: every later chunk, run and rebound round
        copies its start state into the captured tensors. The JAX
        package's ``warmup`` compiles its dispatcher in the same place.
        Returns its seconds."""
        t0 = time.monotonic()
        built = self._step_fn is None
        self._compile_chunk()
        t1 = time.monotonic()
        captured = self.device.type == "cuda" and self._stepper is None
        if captured:
            self.chunk_stepper(0)
        t2 = time.monotonic()
        self.compile_breakdown = (
            {"build_seconds": round(t1 - t0, 6),
             "capture_seconds": round(t2 - t1, 6)}
            if built or captured else None)
        return t2 - t0

    def _done(self, st, has_restarts):
        """(tick, running, live-lane mask, done) of a batched state."""
        cfg = self.config
        ticks_h = st["tick"].cpu().numpy()
        lv = live_lanes(st, has_restarts)  # [C, N]
        running = int(torch.sum(lv))
        if self.base_ex.event_skip:
            # each scenario's executed budget decouples its tick: done
            # once every LIVE scenario reached the horizon
            live_scen = lv.any(dim=-1).cpu().numpy()
            done = running == 0 or bool(
                (ticks_h[live_scen] >= cfg.max_ticks).all())
        else:
            done = running == 0 or int(ticks_h.max()) >= cfg.max_ticks
        return int(ticks_h.max()), running, lv, done

    def run(
        self, on_chunk=None, drain=None, should_stop=None,
        watchdog=None, checkpoint=None, resume=None,
    ) -> "SweepResult":
        """Run every scenario chunk to completion: ``chunk_ticks`` batched
        loop iterations between two boundaries (the termination condition
        is read every ``POLL_TICKS`` iterations inside, and a chunk ends with
        the sweep). ``drain`` / ``on_chunk`` / ``should_stop`` follow the
        :meth:`SimExecutable.run` contract at every boundary, with the
        batched state (a drain streams each row to its own scenario
        directory) and, in ``info``, the ``[C, N]`` live-lane mask and
        the chunk's position; a should_stop() ends the run with the
        drained prefix kept (never-run chunks stay None in
        ``SweepResult.chunk_states``).

        The durability plane (sim/checkpoint.py): before the last
        boundary of a chunk ``checkpoint`` snapshots the batched state
        with the completed chunks' finals (forced when stopping), and
        ``watchdog`` judges the chunk's wall time, armed around it;
        ``resume = {"chunk": c, "state": host leaves}`` re-enters
        scenario chunk ``c`` at a checkpointed boundary (on the card by
        copying into the captured tensors: no second capture). The
        chunks before ``c`` stay None in ``chunk_states`` for the caller
        to fill from the checkpoint's chunk finals. The last chunk's
        final state stays on the device; earlier ones move to the host,
        so the card holds one chunk."""
        cfg = self.config
        has_restarts = self.base_ex.has_restarts
        cuda = self.device.type == "cuda"
        chunk = max(1, cfg.chunk_ticks)
        poll = min(POLL_TICKS, chunk)
        terminated = False
        start_chunk = int(resume["chunk"]) if resume is not None else 0
        finals: list = [None] * start_chunk
        wall = 0.0
        captures = self.captures
        for ci in range(start_chunk, self.n_chunks):
            if terminated:
                break
            st, step = self.chunk_stepper(
                ci, resume["state"] if resume is not None
                and ci == start_chunk else None)
            if cuda:
                torch.cuda.synchronize(self.device)
            # the capture is set-up, as in SimExecutable.run: each
            # chunk's clock starts after its state is loaded
            wall0 = time.monotonic()
            while True:
                d0 = time.monotonic()
                if watchdog is not None:
                    watchdog.begin()
                left = chunk
                while left:
                    k = min(poll, left)
                    for _ in range(k):
                        st = step(st)
                    left -= k
                    tick, running, lv, done = self._done(st, has_restarts)
                    if done:
                        break
                # the watchdog's unit is the chunk (device work and the
                # host reads), before the boundary's host work below
                dispatch_s = time.monotonic() - d0
                if watchdog is not None:
                    watchdog.end()
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
                stopping = should_stop is not None and should_stop()
                if checkpoint is not None and not done:
                    checkpoint.boundary(st, chunk=ci, finals=finals,
                                        force=stopping)
                if watchdog is not None and not done:
                    watchdog.observe(dispatch_s)
                if done:
                    break
                if stopping:
                    terminated = True
                    break
            if cuda:
                torch.cuda.synchronize(self.device)
            wall += time.monotonic() - wall0
            # the captured tensors are reused by the next chunk or run
            if not cuda:
                finals.append(st)
            elif ci == self.n_chunks - 1:
                finals.append(_tree_map(torch.clone, st))
            else:
                finals.append(_tree_map(lambda x: x.cpu(), st))
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
    make_sweep: Callable[..., SweepExecutable],
    cfg: SimConfig,
    n_scenarios: int,
    explicit_chunk: int = 0,
    budget: Optional[int] = None,
    allow_shrink: bool = True,
    log=lambda msg: None,
    trace_tiers=None,
    telemetry_tiers=None,
):
    """The memory pre-flight of a sweep, as the JAX package's: the state
    scales x chunk, so walk scenario-chunk sizes largest first (the full
    batch, then halvings) and take the first whose state model
    (``SweepExecutable.state_model_bytes``) fits; only when even chunk 1
    does not fit at the requested metrics capacity, walk the ladder again
    with the metrics ring (and the trace and telemetry tiers) allowed to
    shrink: chunking costs wall time, a shrink loses data.
    ``make_sweep(cfg, chunk)`` builds an executable (with ``trace_cap``
    / ``telem_interval`` keywords when the trace / telemetry ladders are
    given: the runner's preflight_autosize walks them). The bound is
    ``budget`` bytes when given, else ``SWEEP_MEMORY_FRACTION`` of the
    card's free memory as if the runner's executor pool were empty
    (``runner.device_hbm_bytes(free=True)``), so a sweep's chunk and
    tiers never depend on what the pool holds. Returns ``(executable,
    report)`` with the runner's pre-flight keys and the sweep's."""
    from .runner import device_hbm_bytes, preflight_autosize

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
    # only the config and the observer tiers change the built program;
    # another chunk is a wrapper around the same builds
    built: dict = {}

    def cached_make(cfg2, chunk, trace_cap=None, telem_interval=None):
        key = (tuple(sorted(dataclasses.asdict(cfg2).items())), trace_cap,
               telem_interval)
        kw = {}
        if trace_cap is not None:
            kw["trace_cap"] = trace_cap
        if telem_interval is not None:
            kw["telem_interval"] = telem_interval
        sw = built.get(key)
        if sw is None:
            sw = built[key] = make_sweep(cfg2, chunk, **kw)
        if sw.chunk_size == min(chunk, sw.n_scenarios):
            return sw
        return SweepExecutable(
            sw.base_ex, sw.scenarios, sw._scen_params, chunk=chunk,
            fault_plans=sw._fault_plans, replay_plans=sw._replay_plans,
        )

    if budget is not None:
        memory, fraction = int(budget), 1.0
    else:
        first = cached_make(cfg, ladder[0],
                            trace_tiers[0] if trace_tiers else None,
                            telemetry_tiers[0] if telemetry_tiers else None)
        memory = device_hbm_bytes(first.device, free=True)
        fraction = SWEEP_MEMORY_FRACTION
    last_err: Optional[RuntimeError] = None
    for shrink in (False, True) if allow_shrink else (False,):
        for chunk in ladder:
            try:
                ex, report = preflight_autosize(
                    lambda extra, cfg2, c=chunk: cached_make(
                        cfg2, c, (extra or {}).get("trace_capacity"),
                        (extra or {}).get("telemetry_interval")),
                    cfg, budget=memory, fraction=fraction,
                    allow_shrink=shrink, log=log,
                    trace_tiers=trace_tiers,
                    telemetry_tiers=telemetry_tiers,
                )
            except RuntimeError as err:
                last_err = err
                continue
            total = ex.state_model_bytes()
            report["scenarios"] = n_scenarios
            report["scenario_chunk"] = chunk
            # one card: the JAX package's 2-D mesh accounting at 1 x 1
            report["mesh_shape"] = {"scenario": 1, "instance": 1}
            report["scenario_chunk_padded"] = ex.chunk_size
            report["instances_padded"] = ex.base_ex.n
            report["state_model_bytes_per_axis"] = {
                "scenario_row": total, "instance_shard": total,
            }
            rp = ex.base_ex.replay
            if rp is not None:
                report["replay_bytes"] = ex.chunk_size * rp.model_bytes()
            if chunk < n_scenarios and not explicit_chunk:
                log(f"pre-flight HBM: sweep chunked to {chunk} scenarios "
                    f"per dispatch ({math.ceil(n_scenarios / chunk)} "
                    "chunks) on a 1x1 mesh")
            return ex, report
    raise last_err if last_err is not None else RuntimeError(
        "sweep pre-flight found no admissible configuration")
