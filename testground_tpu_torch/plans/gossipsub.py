"""Gossipsub mesh-propagation — the port's torch transcription of the
``plans/gossipsub`` sim plan ("libp2p gossipsub mesh-propagation, 4,096
simulated peers").

Line for line, and in the same op order, the JAX plan
(``plans/gossipsub/sim.py``): every peer keeps a static mesh of D random
neighbors; the publisher (instance 0) holds the message; on first
receipt a peer forwards it to one mesh neighbor per tick, then gossips
to a random peer each tick until every peer holds it (the lazy
IHAVE/IWANT layer that covers peers the random mesh left unreached).

Metrics per instance: ``propagation_ms`` (time to first receipt) and
``hops`` (mesh distance travelled). The case asserts full coverage: the
pump's barrier on "have-msg" targets all n peers.
"""

import torch

from ..sim import prng
from ..sim.net import F_PORT, F_TAG, NET_HDR
from ..sim.program import TAG_DATA, PhaseCtrl, onehot_get, onehot_set

PORT = 4001  # libp2p default port, for flavor
MSG_BYTES = 1024.0


def mesh_propagation(b):
    ctx = b.ctx
    n = ctx.n_instances
    D = ctx.static_param_int("degree", 8)
    latency_ms = float(ctx.static_param_int("link_latency_ms", 50))
    loss = float(ctx.static_param_int("link_loss_pct", 0))

    # head_k=1: the pump reads only inbox_entry(0); the egress queue
    # (send_slots) only above 100k peers, as in the JAX plan
    cap = ctx.static_param_int("inbox_capacity", max(64, 2 * D))
    b.enable_net(
        inbox_capacity=cap, payload_len=1, head_k=1,
        send_slots=(n // 4) if n > 100_000 else None,
    )
    b.wait_network_initialized()
    if latency_ms > 0 or loss > 0:
        b.configure_network(
            latency_ms=latency_ms,
            loss=loss,
            callback_state="net-shaped",
            callback_target=n,
        )

    b.declare("mesh", (D,), torch.int32, 0)
    b.declare("have", (), torch.int32, 0)
    b.declare("hops", (), torch.float32, 0.0)
    b.declare("fwd_i", (), torch.int32, 0)
    b.declare("signaled", (), torch.int32, 0)

    have_state = b.states.state("have-msg")
    m_prop = b.metrics.metric("propagation_ms")
    b.metrics.metric("hops")
    P = b._net_spec.payload_len

    def setup(env, mem):
        r = prng.randint(env.rng, (D,), 0, max(n - 1, 1))
        neigh = torch.remainder(
            torch.where(r >= env.instance, r + 1, r), max(n, 1)
        )
        mem = dict(mem)
        mem["mesh"] = neigh.to(torch.int32)
        # the publisher (instance 0) starts holding the message
        mem["have"] = (env.instance == 0).to(torch.int32)
        return mem, PhaseCtrl(advance=1)

    b.phase(setup, "gossip:setup")
    b.signal_and_wait("mesh-ready")
    b.mark_tick("t0")

    def pump(env, mem):
        mem = dict(mem)
        # ---- receive: consume one visible entry per tick
        head = env.inbox_entry(0)
        got = (
            (env.inbox_avail > 0)
            & (head[F_TAG] == TAG_DATA)
            & (head[F_PORT] == PORT)
        )
        first = got & (mem["have"] == 0)
        mem["have"] = torch.maximum(mem["have"], got.to(torch.int32))
        mem["hops"] = torch.where(first, head[NET_HDR] + 1.0, mem["hops"])
        t_ms = env.ms(env.tick - mem["t0"])

        # ---- forward: one mesh neighbor per tick, then gossip to a
        # random peer each tick until global coverage; hold while the
        # egress queue still carries a deferred forward
        can_send = env.egress_ready()
        mesh_fwd = (mem["have"] > 0) & (mem["fwd_i"] < D) & can_send
        covered = env.barrier_done(have_state, n)
        gossip = (mem["have"] > 0) & ~mesh_fwd & ~covered & can_send
        r = prng.randint(env.rng, (), 0, max(n - 1, 1))
        rnd_peer = torch.remainder(
            torch.where(r >= env.instance, r + 1, r), n
        ).to(torch.int32)
        can_fwd = mesh_fwd | gossip
        dest = torch.where(
            mesh_fwd,
            onehot_get(mem["mesh"], torch.clamp(mem["fwd_i"], max=D - 1)
                       ).to(torch.int32),
            rnd_peer,
        )
        mem["fwd_i"] = mem["fwd_i"] + mesh_fwd.to(torch.int32)

        # ---- coverage signal (once per instance)
        do_signal = (mem["have"] > 0) & (mem["signaled"] == 0)
        mem["signaled"] = torch.maximum(
            mem["signaled"], do_signal.to(torch.int32)
        )

        pay = onehot_set(mem["hops"].new_zeros((P,)), 0, mem["hops"])

        # completion waits for the egress to drain: finishing with a
        # deferred forward queued would abandon it (counted)
        done = (env.barrier_done(have_state, n) & (mem["fwd_i"] >= D)
                & can_send)
        return mem, PhaseCtrl(
            advance=done.to(torch.int32),
            signal=torch.where(do_signal, have_state, -1),
            send_dest=torch.where(can_fwd, dest, -1),
            send_tag=TAG_DATA,
            send_port=PORT,
            send_size=MSG_BYTES,
            send_payload=pay,
            recv_count=got.to(torch.int32),
            metric_id=torch.where(first, m_prop, -1),
            metric_value=t_ms,
        )

    b.phase(pump, "gossip:pump")
    b.record_point("hops", lambda env, mem: mem["hops"])
    b.end_ok()


testcases = {"mesh-propagation": mesh_propagation}
