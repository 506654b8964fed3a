"""Splitbrain plan — the port's torch transcription of
``plans/splitbrain``'s sim plan, in the same op order.

The reference's partition-policy matrix: nodes land in three regions by
racing ``signal_entry("region-select")`` (region = seq % 3); region A
installs filter rules (Drop / Reject / Accept) against every region-B
node; then every node probes connectivity to every other node by a dial
and asserts errors appear exactly where expected: errors iff case !=
accept and the pair is {A, B}. Regions are the filter classes (class
rules with 3 classes).

The ``*-sampled`` cases are the same oracle at scale: regions are
``instance % 3``, and each node probes ``probe_k`` random targets
(param, default 8); above 50,000 nodes the dials go through the egress
queue (``send_slots = max(128, n // 8)``) and the bounded append.
"""

import torch

from ..sim import PhaseCtrl
from ..sim import prng
from ..sim.net import ACTION_ACCEPT, ACTION_DROP, ACTION_REJECT
from ..sim.program import onehot_get

PORT = 8765
REGION_A, REGION_B, REGION_C = 0, 1, 2
DIAL_TIMEOUT_MS = 300.0


def _class_rules(action):
    """Region A's [3] action row keyed by the target's region: ``action``
    toward region B, -1 (unchanged) elsewhere; region B and C write
    nothing."""

    def fn(env, mem):
        i_am_a = mem["region"] == REGION_A
        ar = torch.arange(3, dtype=torch.int32, device=mem["region"].device)
        return torch.where(i_am_a & (ar == REGION_B), action, -1).to(
            torch.int32)

    return fn


def _build(b, action: int, expect_errors_ab: bool):
    ctx = b.ctx
    n = ctx.n_instances
    pad_n = ctx.padded_n
    # class rules: regions are the filter classes
    b.enable_net(class_rules=True, n_classes=3, payload_len=2)
    b.wait_network_initialized()

    # race to signal; seq determines region
    b.signal_and_wait("region-select", save_seq="seq")
    b.declare("region", (), torch.int32, -1)

    def set_region(env, mem):
        return {**mem, "region": mem["seq"] % 3}, PhaseCtrl(advance=1)

    b.phase(set_region, name="set_region")
    b.set_net_class(lambda env, mem: mem["region"])

    # publish (instance, region) so everyone learns the node table
    nodes_tid = b.topics.topic("nodes", capacity=pad_n, payload_len=2)
    b.publish(
        "nodes",
        capacity=pad_n,
        payload_fn=lambda env, mem: torch.stack(
            [env.instance.to(torch.float32), mem["region"].to(torch.float32)]
        ),
        payload_len=2,
    )
    b.wait_topic("nodes", capacity=pad_n, count=n)

    def region_row(env, mem):
        """[pad_n] region id per instance, built from the nodes topic
        (row ``pad_n`` is the drop slot of the unfilled topic rows)."""
        buf = env.topic_buf[nodes_tid]  # [CAP, PAY]
        insts = buf[:, 0].to(torch.int32)
        regs = buf[:, 1].to(torch.int32)
        valid = (torch.arange(buf.shape[0], device=buf.device)
                 < env.topic_len[nodes_tid])
        row = torch.full((pad_n + 1,), -1, dtype=torch.int32,
                         device=buf.device)
        row = row.index_put(
            (torch.where(valid, insts, pad_n).to(torch.int64),),
            torch.where(valid, regs, -1))
        return row[:pad_n]

    # region A installs rules against every region-B node
    b.configure_network(
        latency_ms=5.0,
        class_rules_fn=_class_rules(action),
        callback_state="reconfigured",
    )

    # wait until all nodes have the table and the rules
    b.signal_and_wait("nodeRoundup")

    # probe every other node; count errors and unexpected outcomes
    b.declare("errs", (), torch.int32, 0)
    b.declare("unexpected", (), torch.int32, 0)
    lp = b.loop_begin(pad_n)

    def dial_dest(env, mem):
        j = mem[lp.slot]
        regs_j = onehot_get(region_row(env, mem), j)
        skip = (j == env.instance) | (regs_j < 0)  # self or padding
        return torch.where(skip, -1, j)

    b.dial(dial_dest, PORT, result_slot="dial_r", timeout_ms=DIAL_TIMEOUT_MS)

    def check(env, mem):
        j = mem[lp.slot]
        regs = region_row(env, mem)
        me, them = mem["region"], onehot_get(regs, j)
        probed = (j != env.instance) & (them >= 0)
        got_err = probed & (mem["dial_r"] != 1)
        expect = probed & expect_errors_ab & (
            ((me == REGION_A) & (them == REGION_B))
            | ((me == REGION_B) & (them == REGION_A))
        )
        mem = dict(mem)
        mem["errs"] = mem["errs"] + got_err.to(torch.int32)
        mem["unexpected"] = mem["unexpected"] | (got_err != expect).to(
            torch.int32)
        mem["dial_r"] = torch.zeros_like(mem["dial_r"])
        return mem, PhaseCtrl(advance=1)

    b.phase(check, name="check_dial")
    b.loop_end(lp)

    b.record_point("errors", lambda env, mem: mem["errs"])
    b.fail_if(
        lambda env, mem: mem["unexpected"] > 0,
        "connectivity did not match the partition policy",
    )
    b.signal_and_wait("testcomplete")
    b.end_ok()


def drop(b):
    _build(b, ACTION_DROP, expect_errors_ab=True)


def reject(b):
    _build(b, ACTION_REJECT, expect_errors_ab=True)


def accept(b):
    _build(b, ACTION_ACCEPT, expect_errors_ab=False)


def _build_sampled(b, action: int, expect_errors_ab: bool):
    """The partition-policy oracle at scale: regions are ``instance % 3``
    (so a target's region is arithmetic, not a table), and each node
    probes ``probe_k`` random targets."""
    ctx = b.ctx
    n = ctx.n_instances
    probe_k = ctx.static_param_int("probe_k", 8)

    b.enable_net(
        class_rules=True, n_classes=3, payload_len=2, head_k=1,
        send_slots=max(128, n // 8) if n > 50_000 else None,
    )
    b.wait_network_initialized()

    b.declare("region", (), torch.int32, -1)

    def set_region(env, mem):
        return {**mem, "region": env.instance % 3}, PhaseCtrl(advance=1)

    b.phase(set_region, name="set_region")
    b.set_net_class(lambda env, mem: mem["region"])

    b.configure_network(
        latency_ms=5.0,
        class_rules_fn=_class_rules(action),
        callback_state="reconfigured",
    )
    b.signal_and_wait("nodeRoundup")

    b.declare("errs", (), torch.int32, 0)
    b.declare("unexpected", (), torch.int32, 0)
    b.declare("probe", (), torch.int32, -1)
    lp = b.loop_begin(probe_k)

    def pick(env, mem):
        r = prng.randint(env.rng, (), 0, max(n - 1, 1))
        j = torch.where(r >= env.instance, r + 1, r) % max(n, 1)
        return {**mem, "probe": j.to(torch.int32)}, PhaseCtrl(advance=1)

    b.phase(pick, name="pick_probe")
    b.dial(
        lambda env, mem: mem["probe"], PORT, result_slot="dial_r",
        timeout_ms=DIAL_TIMEOUT_MS,
    )

    def check(env, mem):
        them = mem["probe"] % 3
        me = mem["region"]
        got_err = mem["dial_r"] != 1
        expect = expect_errors_ab & (
            ((me == REGION_A) & (them == REGION_B))
            | ((me == REGION_B) & (them == REGION_A))
        )
        mem = dict(mem)
        mem["errs"] = mem["errs"] + got_err.to(torch.int32)
        mem["unexpected"] = mem["unexpected"] | (got_err != expect).to(
            torch.int32)
        mem["dial_r"] = torch.zeros_like(mem["dial_r"])
        return mem, PhaseCtrl(advance=1)

    b.phase(check, name="check_dial")
    b.loop_end(lp)

    b.record_point("errors", lambda env, mem: mem["errs"])
    b.fail_if(
        lambda env, mem: mem["unexpected"] > 0,
        "connectivity did not match the partition policy",
    )
    b.signal_and_wait("testcomplete")
    b.end_ok()


def drop_sampled(b):
    _build_sampled(b, ACTION_DROP, expect_errors_ab=True)


def reject_sampled(b):
    _build_sampled(b, ACTION_REJECT, expect_errors_ab=True)


def accept_sampled(b):
    _build_sampled(b, ACTION_ACCEPT, expect_errors_ab=False)


testcases = {
    "drop": drop,
    "reject": reject,
    "accept": accept,
    "drop-sampled": drop_sampled,
    "reject-sampled": reject_sampled,
    "accept-sampled": accept_sampled,
}
