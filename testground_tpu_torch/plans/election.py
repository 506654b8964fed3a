"""Quorum leader election driven by a replayed workload: the port's
torch transcription of ``plans/election``'s sim plan, in the JAX plan's
op order.

Each node heartbeats one peer a tick, round-robin, and tracks whom it
heard within a per-node staggered timeout. A node that sees a quorum of
the cluster elects the lowest-id live member; a node cut off in a
minority sees no quorum and serves nothing. The plan holds no fault or
churn logic: the composition's ``[faults]`` table partitions and heals
the groups, and its ``[replay]`` trace's churn rows kill and restart the
initial leader (lane 0). The replayed arrivals are the client requests:
a node consumes its due requests only while it knows a quorum leader.

Graded: every node ends with a quorum leader, and every first-life node
saw at least ``min_leader_changes`` leader adoptions (a restarted node's
fresh memory counts from zero, so it is exempt).

``COMPOSITION`` is the port's copy of ``plans/election/
composition.toml``'s groups, params, ``[replay]`` and ``[faults]``
tables; ``REPLAY_TRACE`` is its copy of the trace the composition names
(``plans/election/replay.jsonl``, byte for byte). ``election_executable``
builds the quorum case from them at any instance count, with the
timeout and run length of ``SIZED_PARAMS`` where the composition's own
cannot reach a quorum."""

from pathlib import Path

import torch

from ..sim import BuildContext, GroupSpec, PhaseCtrl, SimConfig
from ..sim import compile_program
from ..sim.net import F_SRC
from ..sim.program import onehot_set

REPLAY_TRACE = str(Path(__file__).with_name("election_replay.jsonl"))

COMPOSITION = {
    "total_instances": 5,
    "groups": (("majority", 3), ("minority", 2)),
    "test_params": {"hb_timeout_ms": "30", "run_ms": "700",
                    "min_leader_changes": "2"},
    # the recorded workload: a request every 30 ms round-robin over the
    # five nodes, and lane 0 killed at 300 ms and restarted at 440 ms
    "replay": {"trace": "replay.jsonl"},
    # 60..160 ms: the minority is partitioned away
    "faults": {"events": [
        {"kind": "partition", "at_ms": 60, "a": "majority",
         "b": "minority"},
        {"kind": "heal", "at_ms": 160, "a": "majority", "b": "minority"},
    ]},
}


def quorum(b):
    ctx = b.ctx
    n = ctx.n_instances
    np_ = ctx.padded_n
    quorum_n = n // 2 + 1
    timeout_ms = ctx.static_param_int("hb_timeout_ms", 30)
    spread_ms = ctx.static_param_int("timeout_spread_ms", 8)
    run_ms = ctx.static_param_int("run_ms", 700)
    K = 4  # heartbeats ingested a tick (one peer sends to me a tick)

    b.enable_net(head_k=K)
    b.wait_network_initialized(churn_weight=1)

    last_seen = b.declare("last_seen", (np_,), torch.int32, -(10**6))
    leader = b.declare("leader", (), torch.int32, -1)
    prev = b.declare("prev_leader", (), torch.int32, -1)
    changes = b.declare("leader_changes", (), torch.int32, 0)
    served = b.declare("requests_served", (), torch.int32, 0)

    def pump(env, mem):
        mem = dict(mem)
        # ingest heartbeats: stamp each visible sender's last-seen tick
        ls = mem[last_seen]
        for k in range(K):
            e = env.inbox_entry(k)
            ok = k < env.inbox_avail
            src = torch.clamp(e[F_SRC].to(torch.int32), 0, np_ - 1)
            ls = torch.where(ok, onehot_set(ls, src, env.tick), ls)
        mem[last_seen] = ls
        # membership: peers heard within my staggered election timeout
        tmo = env.ticks_for_ms(timeout_ms) + torch.remainder(
            env.instance * 13, max(env.ticks_for_ms(spread_ms), 1))
        ids = torch.arange(np_, dtype=torch.int32, device=ls.device)
        alive = (ls > env.tick - tmo) | (ids == env.instance)
        alive = alive & (ids < n)  # padding never votes
        heard = torch.sum(alive, dtype=torch.int32)
        # the lowest live id leads iff I see a majority (argmax takes
        # the first maximum, as jnp.argmax does)
        lowest = torch.argmax(alive.to(torch.int32)).to(torch.int32)
        have_q = heard >= quorum_n
        new_leader = torch.where(have_q, lowest, -1)
        changed = (new_leader >= 0) & (new_leader != mem[prev])
        mem[changes] = mem[changes] + changed.to(torch.int32)
        mem[prev] = torch.where(new_leader >= 0, new_leader, mem[prev])
        mem[leader] = new_leader
        # serve the replayed requests only while a quorum leader is
        # known; otherwise they queue on my schedule
        take = torch.where(have_q, env.arrivals_pending(), 0)
        mem[served] = mem[served] + take
        # heartbeat one peer a tick, round-robin (never myself)
        dest = torch.remainder(
            env.instance + 1 + torch.remainder(env.tick, n - 1), n)
        done = env.tick >= env.ticks_for_ms(run_ms)
        return mem, PhaseCtrl(
            advance=done.to(torch.int32),
            send_dest=torch.where(done, -1, dest),
            send_size=1.0,
            recv_count=env.inbox_avail,
            replay_consume=take,
        )

    b.phase(pump, "pump")
    b.record_point("leader_changes", lambda env, mem: mem[changes])
    b.record_point("requests_served", lambda env, mem: mem[served])
    b.record_point("final_leader", lambda env, mem: mem[leader])
    # the healed, rejoined cluster must agree on a leader...
    b.fail_if(lambda env, mem: mem[leader] < 0, "no quorum leader at end")
    # ...and must have re-elected under the induced faults (a restarted
    # node's fresh memory counts from 0: exempt)
    b.fail_if(
        lambda env, mem: (mem[changes] < env.params["min_leader_changes"])
        & (env.restarts == 0),
        "fewer leader changes than min_leader_changes",
    )
    b.signal_and_wait("done", churn_weight=1)
    b.end_ok()
    return {
        "min_leader_changes": ctx.param_array_int("min_leader_changes", 0)
    }


testcases = {"quorum": quorum}


def group_sizes(n: int) -> tuple[int, int]:
    """The composition's 3 : 2 majority/minority split at ``n``
    instances: the minority is ``2n // 5`` (2 of 5), the rest the
    majority, which keeps a quorum through the partition."""
    minority = 2 * n // 5
    return n - minority, minority


# the timeout and run length at which the case grades PASS at n = 1,024
# (plans/election/manifest.toml's largest count), found with the JAX
# package on the CPU: at the composition's 30 ms a node hears one peer a
# tick and never sees the 513 a quorum needs
SIZED_PARAMS = {1024: {"hb_timeout_ms": "600", "run_ms": "1500"}}

# the JAX package's outcomes of election_executable(n) (dense and
# skipped alike): the final tick, the fewest leader adoptions of a
# first-life node, the requests served and the arrivals consumed, and
# the restarts; every instance ends ok (PASS). The CPU tests hold both
# packages to them (tests/test_torch_plans_election.py), the card runs
# to them (chip_smoke.py [31])
JAX_OUTCOMES = {
    5: {"ticks": 709, "min_changes": 4, "served": 20, "consumed": 22,
        "restarts": 1},
    1024: {"ticks": 1509, "min_changes": 2, "served": 22, "consumed": 22,
           "restarts": 1},
}


def grade(res, n) -> dict:
    """The case's grade read back from a run: PASS when every instance
    ended ok (each fail_if held), with the figures of ``JAX_OUTCOMES``
    and the final leaders."""
    st = res.statuses()[:n]
    mem = {k: v.cpu().numpy()[:n] for k, v in res.state["mem"].items()
           if k in ("leader_changes", "leader", "requests_served")}
    first = res.state["restarts"].cpu().numpy()[:n] == 0
    return {
        "pass": bool((st == 1).all()),
        "ticks": res.ticks,
        "min_changes": int(mem["leader_changes"][first].min()),
        "served": int(mem["requests_served"].sum()),
        "consumed": res.replay_consumed(),
        "restarts": res.restarts_total(),
        "leaders": sorted(set(mem["leader"].tolist())),
    }


def election_executable(n=COMPOSITION["total_instances"], device="cuda",
                        event_skip=None):
    """The composition's quorum case at ``n`` instances (its 3 : 2 split,
    ``group_sizes``) with its params (updated by ``SIZED_PARAMS[n]``),
    its ``[faults]`` table and its ``[replay]`` trace: 1 ms quantum, max
    5,000 ticks, metrics capacity 8, ``event_skip`` as SimConfig's."""
    p = dict(COMPOSITION["test_params"])
    p.update(SIZED_PARAMS.get(n, {}))
    sizes = group_sizes(n)
    ctx = BuildContext(
        [GroupSpec(g, i, c, p)
         for i, ((g, _), c) in enumerate(zip(COMPOSITION["groups"], sizes))],
        test_case="quorum", test_run="election",
    )
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=250, max_ticks=5_000,
                    metrics_capacity=8, event_skip=event_skip)
    return compile_program(
        quorum, ctx, cfg, device=device,
        faults=COMPOSITION["faults"],
        replay=dict(COMPOSITION["replay"], trace=REPLAY_TRACE),
    )
