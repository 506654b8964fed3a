"""Fault-schedule demo plan — the port's torch transcription of
``plans/faultsdemo``'s sim plan, in the JAX plan's op order.

Two groups ping each other under a declarative chaos timeline (the
composition's ``[faults]`` table: partition, heal, degrade, kill,
restart; none of it is plan code). Every instance pings its cross-group
peer once a tick for ``pump_ms``, counting arrivals; the barriers are
churn-tolerant, and a restarted instance re-runs from the top and joins
the final rendezvous. ``min_pings`` (default 0) fails an instance that
received fewer pings.

``COMPOSITION`` is the port's copy of ``plans/faultsdemo/
composition.toml``'s groups, params and ``[faults]``, ``[trace]`` and
``[telemetry]`` tables; ``chaos_executable`` builds the case from it at
any even instance count."""

import torch

from ..sim import BuildContext, GroupSpec, PhaseCtrl, SimConfig
from ..sim import compile_program

COMPOSITION = {
    "total_instances": 4,
    "groups": ("left", "right"),
    "test_params": {"pump_ms": "200", "chaos_loss": "20"},
    # 20..60 ms partition, 60..120 ms degrade (+5 ms, $chaos_loss % loss),
    # a left instance killed at 140 ms and restarted at 170 ms
    "faults": {"events": [
        {"kind": "partition", "at_ms": 20, "a": "left", "b": "right"},
        {"kind": "heal", "at_ms": 60, "a": "left", "b": "right"},
        {"kind": "degrade", "at_ms": 60, "until_ms": 120, "a": "left",
         "b": "right", "latency_ms": 5, "loss_pct": "$chaos_loss"},
        {"kind": "kill", "at_ms": 140, "group": "left", "count": 1},
        {"kind": "restart", "at_ms": 170, "group": "left"},
    ]},
    "trace": {"capacity": 256},
    "telemetry": {"interval": 10, "probes": [
        "net_sends", "net_delivers", "net_drops", "net_drops_partition",
        "net_drops_loss", "net_drops_churn", "live_lanes", "blocked_frac",
    ]},
}


def chaos(b):
    ctx = b.ctx
    pump_ms = ctx.static_param_int("pump_ms", 200)
    left_n = ctx.groups[0].instances

    b.enable_net(count_only=True)
    b.wait_network_initialized(churn_weight=1)

    got = b.declare("pings_received", (), torch.int32, 0)

    def pump(env, mem):
        mem = dict(mem)
        mem[got] = mem[got] + env.inbox_avail
        # cross-group peer: left i <-> right i (groups are equal-sized)
        peer = torch.where(
            env.group == 0,
            left_n + env.group_instance,
            env.group_instance,
        )
        done = env.tick >= env.ticks_for_ms(pump_ms)
        return mem, PhaseCtrl(
            advance=done.to(torch.int32),
            send_dest=torch.where(done, -1, peer),
            send_size=1.0,
            recv_count=env.inbox_avail,
        )

    b.phase(pump, "pump")
    b.record_point("pings_received", lambda env, mem: mem[got])
    b.signal_and_wait("done", churn_weight=1)
    # the graded liveness floor
    b.fail_if(
        lambda env, mem: mem[got] < env.params["min_pings"],
        "starved below min_pings",
    )
    b.end_ok()
    return {"min_pings": ctx.param_array_int("min_pings", 0)}


testcases = {"chaos": chaos}


def chaos_executable(n=COMPOSITION["total_instances"], device="cuda",
                     **config):
    """The composition's chaos case at ``n`` instances (two equal groups)
    with its params and its three tables; ``config`` sets SimConfig
    fields."""
    params = dict(COMPOSITION["test_params"])
    ctx = BuildContext(
        [GroupSpec(g, i, n // 2, params)
         for i, g in enumerate(COMPOSITION["groups"])],
        test_case="chaos", test_run="faultsdemo",
    )
    return compile_program(
        chaos, ctx, SimConfig(**config), device=device,
        faults=COMPOSITION["faults"], trace=COMPOSITION["trace"],
        telemetry=COMPOSITION["telemetry"],
    )
