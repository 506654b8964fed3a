"""The sweep plane of the port (testground_tpu_torch/sim/sweep.py) against
the JAX package's (testground_tpu/sim/sweep.py) on the CPU: scenario s of
a port sweep equals the port's serial run of that scenario and the JAX
sweep's scenario s on every state leaf, bit for bit (storm at 32,
unshaped, dense and event-skipped; shaped with churn and a chunk smaller
than the batch are tests/test_torch_sweep_shaped.py); every refusal of compile_sweep and every rebind mismatch raises
the JAX package's message; the count scatter's and the ring merge's vmap
rules equal S serial calls of their plain versions, dropped lanes
included; the [sweep] table, the structure() of the fault, trace and
telemetry specs, the result surface and the memory pre-flight's chunk
ladder. The planes' sweeps are tests/test_torch_sweep_planes.py."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import dataclasses

import numpy as np
import pytest
import torch
from _plane_parity import j_tables, t_tables
from _storm_parity import (
    assert_leaves_equal, jax_plan, leg_config, leg_params, torch_plan,
)

from testground_tpu.api import composition as jcomp
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_sweep as j_compile_sweep
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import compile_program as t_compile
from testground_tpu_torch.sim import count_scatter as csc
from testground_tpu_torch.sim import ring_merge as rm
from testground_tpu_torch.sim import sweep as tsweep
from testground_tpu_torch.sim import tables
from testground_tpu_torch.sim.state_io import flatten, state_to_numpy


def scenarios(seeds, params=None):
    return [{"seed": s, "params": dict(params or {})} for s in seeds]


def j_sweep(plan, groups, scen, case="t", chunk=0, tabs=None, **cfg):
    """The JAX package's sweep on one CPU device."""
    cfg.setdefault("chunk_ticks", 64)
    return j_compile_sweep(
        plan, [JGroup(*g) for g in groups], JConfig(**cfg), scen,
        test_case=case, test_run="r", chunk=chunk, mesh_shape=[1, 1],
        **j_tables(**(tabs or {})))


def t_sweep(plan, groups, scen, case="t", chunk=0, tabs=None, **cfg):
    """The port's sweep on the CPU."""
    cfg.setdefault("chunk_ticks", 64)
    return tsweep.compile_sweep(
        plan, [TGroup(*g) for g in groups], TConfig(**cfg), scen,
        test_case=case, test_run="r", chunk=chunk, device="cpu",
        **t_tables(**(tabs or {})))


def t_serial(plan, groups, sc, case="t", tabs=None, **cfg):
    """The port's serial run of one scenario (its seed and params)."""
    cfg.setdefault("chunk_ticks", 64)
    grp = [TGroup(g[0], g[1], g[2], {**g[3], **sc["params"]})
           for g in groups]
    ctx = TCtx(grp, test_case=case, test_run="r")
    ex = t_compile(plan, ctx, TConfig(seed=sc["seed"], **cfg), device="cpu",
                   **t_tables(**(tabs or {})))
    return ex.run()


def sweep_only(state):
    """A sweep scenario's state without the sweep's own leaves (the key
    and the varying params), as a serial run's."""
    flat = flatten(state_to_numpy(state))
    return {k: v for k, v in flat.items()
            if k != "rng_key" and not k.startswith("params/")}


def assert_scenario(jres, tres, s, serial=None):
    """Port sweep scenario ``s`` == JAX sweep scenario ``s`` (every leaf,
    the sweep's own too) and == the port's serial run."""
    tr = tres.scenario(s)
    assert tr.ticks == jres.scenario(s).ticks
    n = assert_leaves_equal(jres.scenario(s).state, tr.state)
    if serial is not None:
        a, b = sweep_only(tr.state), flatten(state_to_numpy(serial.state))
        assert set(a) == set(b), set(a) ^ set(b)
        for k in a:
            x, y = a[k], b[k]
            if x.dtype.kind == "f":
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(x, y, err_msg=f"serial {s}: {k}")
    return n


# ------------------------------------------------------- storm, batched

STORM_N = 32


def storm_case(shaped, event_skip=True):
    """storm at ``STORM_N`` with ``__graft_entry__``'s compressed params,
    the dial window and the data cut further (600 ms, 8 KiB) so that a
    CPU run is short; shaped: its links, churn-tolerant rendezvous and 5%
    churn over 200-800 ms. Returns (groups, SimConfig fields)."""
    params = dict(leg_params(shaped), conn_delay_ms="600", data_size_kb="8")
    cfg = leg_config(shaped, event_skip=event_skip)
    if shaped:
        cfg.update(churn_start_ms=200.0, churn_end_ms=800.0)
    return [("single", 0, STORM_N, params)], cfg


def check_storm_sweep(shaped, event_skip, seeds=2):
    """Port sweep scenario s == port serial run s == JAX sweep scenario s
    for storm over ``seeds`` seeds."""
    groups, cfg = storm_case(shaped, event_skip)
    scen = scenarios(range(seeds))
    jres = j_sweep(jax_plan(), groups, scen, "storm", **cfg).run()
    tex = t_sweep(torch_plan(), groups, scen, "storm", **cfg)
    tres = tex.run()
    for s in range(seeds):
        serial = t_serial(torch_plan(), groups, scen[s], "storm", **cfg)
        assert assert_scenario(jres, tres, s, serial) > 30
    assert tres.scenario(0).state["rng_key"].dtype == torch.uint32
    assert tex.captures == 0  # no capture on the CPU
    return tex, tres


@pytest.mark.parametrize("event_skip", [False, True])
def test_storm_sweep_matches_serial_and_jax(event_skip):
    _, tres = check_storm_sweep(False, event_skip)
    for s in range(2):
        assert (tres.scenario(s).statuses()[:STORM_N] == 1).all()


def test_batched_tick_refuses_a_per_scenario_loop():
    """The sweep's step runs with vmap's loop fallback off: an op with no
    batching rule (histc) raises rather than running once per scenario,
    and the flag is back on after the step."""
    step = tsweep._batched_only(torch.func.vmap(lambda x: torch.histc(x, 4)))
    with pytest.raises(RuntimeError, match="vmap fallback which is currently disabled"):
        step(torch.rand(3, 5))
    assert torch._C._functorch._is_vmap_fallback_enabled()
    with pytest.warns(UserWarning, match="batching rule for aten::histc"):
        hist = torch.func.vmap(lambda x: torch.histc(x, 4))(
            torch.rand(2, 3))
    assert torch.equal(hist.sum(dim=1), torch.full((2,), 3.0))


# ------------------------------------------------------- the kernels' rules


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (0, 0, None), (None, 0, 0),
                                     (1, 0, 0)])
def test_count_scatter_vmap_rule_equals_serial_calls(in_dims):
    rng = np.random.default_rng(3)
    S, R, L = 5, 7, 40
    shapes = {0: (R, 2), 1: (L,), 2: (L, 2)}

    def arr(i):
        shape = shapes[i]
        if in_dims[i] is not None:
            shape = shape[:in_dims[i]] + (S,) + shape[in_dims[i]:]
        if i == 1:
            # ~a third dropped (idx >= R), a few exactly R: none may land
            # in the next scenario's row 0
            return torch.as_tensor(rng.integers(0, R + 4, shape)
                                   .astype(np.int32))
        return torch.as_tensor((rng.standard_normal(shape) * 1e3)
                               .astype(np.float32))

    buf, idx, upd = (arr(i) for i in range(3))
    got = torch.func.vmap(csc.scatter_add, in_dims=in_dims)(buf, idx, upd)

    def at(x, d, s):
        return x if d is None else x.select(d, s)

    want = torch.stack([
        csc.scatter_add_plain(*(at(x, d, s) for x, d in
                                zip((buf, idx, upd), in_dims)))
        for s in range(S)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # every lane dropped in one scenario leaves its rows as they were
    idx_all = torch.full((S, L), R, dtype=torch.int32)
    b3 = torch.randn(S, R, 2)
    out = torch.func.vmap(csc.scatter_add)(b3, idx_all, torch.randn(S, L, 2))
    assert torch.equal(out, b3)


def test_ring_merge_vmap_rule_equals_serial_calls():
    rng = np.random.default_rng(4)
    S, N, cap, W, A = 3, 6, 4, 5, 3
    ring = torch.as_tensor(rng.standard_normal((S, N, cap, W))
                           .astype(np.float32))
    w = torch.as_tensor(rng.integers(0, 1 << 20, (S, N)).astype(np.int32))
    k = torch.as_tensor(rng.integers(0, A + 1, (S, N)).astype(np.int32))
    arr = torch.as_tensor(rng.standard_normal((S, A * N, W))
                          .astype(np.float32))
    got = torch.func.vmap(rm.merge)(ring, w, k, arr)
    want = torch.stack([rm.merge_plain(ring[s], w[s], k[s], arr[s])
                        for s in range(S)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------------------- refusals


def _static_case(b):
    b.ctx.static_param_int("k", 1)
    b.end_ok()


def _end_ok(b):
    b.end_ok()


def _shape_case(b):
    """A program whose phase count follows a param read around the
    static accessors: its structure changes across the grid."""
    k = int(b.ctx.groups[0].parameters.get("k", "1"))
    for _ in range(k):
        b.sleep_ms(1)
    b.end_ok()
    return {"k": b.ctx.param_array_int("k", 1)}


def _both_raise(jfn, tfn, exc=ValueError):
    with pytest.raises(exc) as je:
        jfn()
    with pytest.raises(exc) as te:
        tfn()
    assert str(te.value) == str(je.value)
    return str(te.value)


G2 = [("single", 0, 2, {})]


@pytest.mark.parametrize("name", [
    "empty", "slices", "pallas_front", "static_param", "unexposed",
    "program_structure", "replay_structure",
])
def test_refusals_match_jax(name, tmp_path):
    plan, scen, cfg, tabs = _end_ok, scenarios([0]), {}, None
    if name == "empty":
        scen = []
    elif name == "slices":
        cfg = {"slices": 2}
    elif name == "pallas_front":
        cfg = {"pallas_front": True}
    elif name == "static_param":
        plan, scen = _static_case, scenarios([0], {"k": "2"})
    elif name == "unexposed":
        scen = scenarios([0], {"y": "2"})
    elif name == "program_structure":
        plan = _shape_case
        scen = scenarios([0], {"k": "1"}) + scenarios([0], {"k": "2"})
    elif name == "replay_structure":
        tf = tmp_path / "w.jsonl"
        tf.write_text('{"replay_version": 1}\n{"lane": 0, "tick": 10}\n')
        tabs = {"replay": {"trace": str(tf), "scale": "$load"}}
        scen = scenarios([0], {"load": "1"}) + scenarios([0], {"load": "3"})
    msg = _both_raise(
        lambda: j_sweep(plan, G2, scen, tabs=tabs, **cfg),
        lambda: t_sweep(plan, G2, scen, tabs=tabs, **cfg))
    assert msg


def test_one_card_mesh_and_the_durability_hooks_name_their_items(tmp_path):
    from testground_tpu_torch.sim.checkpoint import (
        Checkpointer, DispatchWatchdog, load_checkpoint,
    )
    from testground_tpu_torch.sim.state_io import state_from_numpy

    scen = scenarios([0, 1])
    for mesh in (None, [1, 1]):
        tsweep.compile_sweep(_end_ok, [TGroup(*G2[0])], TConfig(), scen,
                             mesh_shape=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tsweep.compile_sweep(_end_ok, [TGroup(*G2[0])], TConfig(), scen,
                             mesh_shape=[2, 1], device="cpu")
    # the durability hooks, once refused as not ported: the watchdog
    # judges and the checkpoint snapshots every boundary but a chunk's
    # last, with the completed chunks' finals; a resume from the newest
    # snapshot re-enters its chunk and ends where the whole run ends
    ex = t_sweep(_param_plan, G2, scenarios(range(3)), chunk=2,
                 chunk_ticks=1, max_ticks=50)
    ck = Checkpointer(tmp_path, key_hash="k", kind="sweep", interval_s=0.0)
    wd = DispatchWatchdog(floor_s=60.0)
    full = ex.run(watchdog=wd, checkpoint=ck)
    assert wd.boundaries == ck.snapshots >= 2
    rp = load_checkpoint(tmp_path)
    assert (rp.kind, rp.chunk, rp.meta["finals"]) == ("sweep", 1, [0])
    res = ex.run(resume={"chunk": rp.chunk, "state": rp.state})
    assert res.chunk_states[0] is None and res.has_scenario(2)
    res.chunk_states[0] = state_from_numpy(rp.load_final(0), "cpu")
    for s in range(3):
        assert_leaves_equal(full.scenario(s).state, res.scenario(s).state)


def _fault_grid():
    return {"events": [
        {"kind": "degrade", "at_ms": 5, "until_ms": 30, "a": "single",
         "b": "single", "loss_pct": "$loss"},
        {"kind": "kill", "at_ms": 10, "group": "single", "count": 1},
    ]}


def _param_plan(b):
    b.sleep_ms(2)
    b.end_ok()
    return {"p": b.ctx.param_array_int("p", 0)}


def test_rebind_mismatches_match_jax():
    G4 = [("single", 0, 4, {})]
    kw = dict(tabs={"faults": _fault_grid()}, max_ticks=200)
    scen = scenarios([0, 1], {"p": "1", "loss": "5"})
    scen[1]["params"]["p"] = "2"
    jex = j_sweep(_param_plan_net, G4, scen, **kw)
    tex = t_sweep(_param_plan_net, G4, scen, **kw)
    jrow, trow = jex._scen_params, tex._scen_params
    jf, tf = jex._fault_plans, tex._fault_plans
    cases = [
        ((scen[:1],), {}),
        ((scen,), {"per_scenario_params": None}),
        ((scen,), {"per_scenario_params": "ROWS1"}),
        ((scen,), {"per_scenario_params": "KEYS"}),
        ((scen,), {"per_scenario_params": "DTYPE"}),
        ((scen,), {"per_scenario_params": "ROWS", "fault_plans": None}),
        ((scen,), {"per_scenario_params": "ROWS", "fault_plans": "FP1"}),
        ((scen,), {"per_scenario_params": "ROWS", "fault_plans": "FPX"}),
        ((scen,), {"per_scenario_params": "ROWS", "fault_plans": "FP",
                   "replay_plans": "RP"}),
    ]

    def resolve(v, rows, fps, pkg):
        if v == "ROWS":
            return rows
        if v == "ROWS1":
            return rows[:1]
        if v == "KEYS":
            return [{"q": r["p"]} for r in rows]
        if v == "DTYPE":
            return [{"p": np.asarray(r["p"], np.float32)} for r in rows]
        if v == "FP":
            return fps
        if v == "FP1":
            return fps[:1]
        if v == "FPX":
            # a plan without the degrade window: another structure
            return [dataclasses.replace(
                fps[0], win_kind=(), win_src=(), win_dst=())] + fps[1:]
        if v == "RP":
            return [object()] * len(fps)
        return v

    for args, kw2 in cases:
        _both_raise(
            lambda: jex.rebind(*args, **{k: resolve(v, jrow, jf, "jax")
                                         for k, v in kw2.items()}),
            lambda: tex.rebind(*args, **{k: resolve(v, trow, tf, "port")
                                         for k, v in kw2.items()}))
    # a matching rebind goes through and reruns the same build
    builds = tsweep.chunk_compiles()
    tex.rebind(scen, per_scenario_params=trow, fault_plans=tf)
    tex.run()
    assert tsweep.chunk_compiles() == builds + 1 or builds >= 1


def _param_plan_net(b):
    """A plan with a data plane (the fault grid's degrade window shapes
    it) and a per-instance param."""
    b.enable_net(count_only=True, payload_len=1)
    b.sleep_ms(2)
    b.end_ok()
    return {"p": b.ctx.param_array_int("p", 0)}


# ---------------------------------------------- surface, ladder, tables


def test_result_surface_and_preflight_ladder():
    scen = scenarios(range(5))
    ex = t_sweep(_param_plan, G2, scen, max_ticks=50)
    res = ex.run()
    assert [r.outcomes() for r in res] == [{"single": (2, 2)}] * 5
    assert res.has_scenario(4) and not res.has_scenario(5)
    assert res.ticks == max(res.scenario(s).ticks for s in range(5))
    with pytest.raises(IndexError):
        res.scenario(5)
    res.release_chunk(0)
    assert not res.has_scenario(0)
    with pytest.raises(ValueError, match="released"):
        res.scenario(0)

    def mk(cfg, chunk):
        return tsweep.compile_sweep(_param_plan, [TGroup(*G2[0])], cfg, scen,
                                    chunk=chunk, device="cpu")

    cfg = TConfig(max_ticks=50)
    one = mk(cfg, 1).state_model_bytes()
    ex2, report = tsweep.sweep_preflight(mk, cfg, 5, budget=int(one * 2.5))
    assert report["scenario_chunk"] == ex2.chunk_size == 2
    assert report["state_model_bytes_per_device"] <= int(one * 2.5)
    assert [r.outcomes() for r in ex2.run()] == [{"single": (2, 2)}] * 5
    ex3, report = tsweep.sweep_preflight(mk, cfg, 5)
    assert report["scenario_chunk"] == 5  # no bound on the CPU
    # a [sweep] chunk is the ladder's only rung
    ex4, report = tsweep.sweep_preflight(mk, cfg, 5, explicit_chunk=3)
    assert (report["scenario_chunk"], ex4.n_chunks) == (3, 2)
    # a budget under one scenario: the metrics ring shrinks (down to its
    # last tier) before the pre-flight gives up
    half = mk(dataclasses.replace(cfg, metrics_capacity=8),
              1).state_model_bytes()
    ex5, report = tsweep.sweep_preflight(mk, cfg, 5, budget=half)
    assert (report["scenario_chunk"], report["metrics_capacity"]) == (1, 8)
    assert report["metrics_capacity_requested"] == cfg.metrics_capacity
    with pytest.raises(RuntimeError, match="cannot fit"):
        tsweep.sweep_preflight(mk, cfg, 5, budget=1)
    with pytest.raises(RuntimeError, match="cannot fit"):
        tsweep.sweep_preflight(mk, cfg, 5, budget=1, allow_shrink=False)


@pytest.mark.parametrize("d", [
    {"seeds": 3, "params": {"a": [1, 2], "b": ["x"]}},
    {"seeds": 2, "seed_base": 7, "chunk": 2, "mesh": [1, 1]},
    {"seeds": 0},
    {"seeds": 1, "seed_base": -1},
    {"seeds": 1, "chunk": -1},
    {"seeds": 1, "mesh": [1]},
    {"seeds": 1, "mesh": [1, 0.5]},
    {"seeds": 1, "params": {"a": []}},
    {"seeds": 1, "params": {"a": "fast"}},
    {"seeds": 5000},
    {"seeds": 1, "params": "x"},
    {"seeds": 1, "sedes": 2},
])
def test_sweep_table_matches_jax(d):
    def run(mod):
        s = mod.Sweep.from_dict(d)
        s.validate()
        return s.expand(), s.total_scenarios(), s.to_dict()

    try:
        want = run(jcomp)
    except jcomp.CompositionError as e:
        with pytest.raises(tables.CompositionError) as te:
            run(tables)
        assert str(te.value) == str(e)
        return
    assert run(tables) == want
    assert tables.MAX_SWEEP_SCENARIOS == jcomp.MAX_SWEEP_SCENARIOS


def test_structure_of_the_specs_matches_jax():
    from _plane_parity import j_build, t_build
    from test_torch_trace import CHAOS_GROUPS, CHAOS_TIMELINE, faultsdemo

    jplan, tplan = faultsdemo()
    kw = dict(faults=CHAOS_TIMELINE, trace={"capacity": 16},
              telemetry={"interval": 10}, quantum_ms=1.0, max_ticks=400)
    jex = j_build(jplan, CHAOS_GROUPS, "chaos", **kw)
    tex = t_build(tplan, CHAOS_GROUPS, "chaos", **kw)
    for attr in ("faults", "trace", "telemetry"):
        assert getattr(tex, attr).structure() == \
            getattr(jex, attr).structure(), attr


def test_boundary_hooks_and_state_io_match_jax():
    """``on_chunk`` sees JAX's boundary ticks, running counts, info keys
    and chunk positions; a should_stop() after the second boundary ends
    both packages' sweeps there with the never-run chunk None; and the
    batched ``[S, ...]`` state crosses between the packages through
    sim/state_io.py leaf for leaf (the uint32 keys included)."""
    from testground_tpu_torch.sim.state_io import (
        state_from_numpy, state_to_numpy,
    )

    groups, cfg = storm_case(False, event_skip=True)
    cfg["chunk_ticks"] = 20
    scen = scenarios(range(3))
    out = {}
    for pkg, build in (("jax", j_sweep), ("port", t_sweep)):
        seen, polls = [], []

        def on_chunk(tick, running, info, seen=seen):
            seen.append((tick, running, sorted(info), info["chunk"],
                         info["n_chunks"], info["n_scenarios"],
                         tuple(info["live_lanes"].shape)))

        def should_stop(polls=polls):
            polls.append(1)
            return len(polls) >= 2

        ex = build(torch_plan() if pkg == "port" else jax_plan(), groups,
                   scen, "storm", chunk=2, **cfg)
        res = ex.run(on_chunk=on_chunk, should_stop=should_stop)
        out[pkg] = (seen, res)
    (jseen, jres), (tseen, tres) = out["jax"], out["port"]
    assert tseen == jseen and len(tseen) == 2
    assert tres.terminated and jres.terminated
    assert tres.chunk_states[1] is None and jres.chunk_states[1] is None
    assert not tres.has_scenario(2) and tres.has_scenario(1)
    # the whole [2, ...] chunk state, leaf for leaf, and across
    assert_leaves_equal(jres.chunk_states[0], tres.chunk_states[0])
    import jax

    carried = state_from_numpy(jax.device_get(jres.chunk_states[0]), "cpu")
    assert carried["rng_key"].dtype == torch.uint32
    assert_leaves_equal(state_to_numpy(carried), tres.chunk_states[0])
