"""Kademlia DHT find-providers — the port's torch transcription of the
``plans/dht`` sim plan ("Kademlia DHT find-providers, 10k peers, churn +
5% loss").

Line for line, and in the same op order, the JAX plan
(``plans/dht/sim.py``): peer ids are instance indices; routing tables are
the hypercube buckets ``self XOR 2^j``; a lookup for ``target`` is
iterative and querier-driven: the querier round-trips a QUERY to its
best-known peer, which replies with the neighbor one bit closer to the
target. Lost messages and churned-dead peers surface as timeouts,
handled by bounded retries.

Metrics: ``lookup.ok`` / ``lookup.fail`` (value = hops), ``lookup_ms``
(wall of the whole lookup), ``retries``.
"""

import torch

from ..sim import prng
from ..sim.net import F_PORT, F_SRC, F_TAG, NET_HDR
from ..sim.program import TAG_DATA, PhaseCtrl, onehot_set

PORT_Q = 4240  # query
PORT_R = 4241  # reply
MSG_BYTES = 64.0


def _next_hop(cur, target, n, bits):
    """The neighbor of ``cur`` one differing-bit closer to ``target``:
    highest differing bit whose flip stays inside the id space [0, n)."""
    d = cur ^ target
    best = cur  # fallback (d == 0)
    # scan bits low → high so the HIGHEST valid bit wins the final where
    for j in range(bits):
        cand = cur ^ (1 << j)
        ok = (((d >> j) & 1) == 1) & (cand < n)
        best = torch.where(ok, cand, best)
    return best


def _payload(val, width):
    """[width] f32 with ``val`` in slot 0 (the plan's zeros().at[0].set)."""
    return onehot_set(val.new_zeros((width,)), 0, val)


def find_providers(b):
    ctx = b.ctx
    n = ctx.n_instances
    bits = max(1, (n - 1).bit_length())
    latency_ms = float(ctx.static_param_int("link_latency_ms", 50))
    loss = float(ctx.static_param_int("link_loss_pct", 0))
    timeout_ms = float(ctx.static_param_int("query_timeout_ms", 1000))
    max_retries = ctx.static_param_int("max_retries", 3)

    cap = ctx.static_param_int("inbox_capacity", 32)
    b.enable_net(
        inbox_capacity=cap, payload_len=2, head_k=1,
        send_slots=max(128, n // 8),
    )
    b.wait_network_initialized()
    if latency_ms > 0 or loss > 0:
        b.configure_network(
            latency_ms=latency_ms,
            loss=loss,
            callback_state="net-shaped",
            callback_target=n,
        )

    b.declare("target", (), torch.int32, 0)
    b.declare("cur", (), torch.int32, 0)
    b.declare("hops", (), torch.int32, 0)
    b.declare("retries", (), torch.int32, 0)
    b.declare("t_sent", (), torch.int32, -1)  # tick of in-flight query
    b.declare("done", (), torch.int32, 0)  # 0 running, 1 ok, 2 fail
    b.declare("r_dest", (), torch.int32, -1)  # stashed reply dest
    b.declare("r_pay", (), torch.float32, 0.0)  # stashed reply payload

    m_ok = b.metrics.metric("lookup.ok")
    m_fail = b.metrics.metric("lookup.fail")
    b.metrics.metric("lookup_ms")
    b.metrics.metric("retries")
    P = b._net_spec.payload_len

    def setup(env, mem):
        mem = dict(mem)
        t = prng.randint(env.rng, (), 0, max(n, 1))
        mem["target"] = t.to(torch.int32)
        mem["cur"] = env.instance.to(torch.int32)
        return mem, PhaseCtrl(advance=1)

    b.phase(setup, "dht:setup")
    b.signal_and_wait("tables-ready")
    b.mark_tick("t0")

    def pump(env, mem):
        mem = dict(mem)
        tmo = env.ticks_for_ms(timeout_ms)

        can_send = env.egress_ready()
        stash_free = mem["r_dest"] < 0

        # ---- consume one inbox entry; the inbox IS the service queue
        head = env.inbox_entry(0)
        have = env.inbox_avail > 0
        is_q = (
            have & (head[F_TAG] == TAG_DATA) & (head[F_PORT] == PORT_Q)
            & stash_free
        )
        is_r = have & (head[F_TAG] == TAG_DATA) & (head[F_PORT] == PORT_R)
        consume = is_q | is_r

        # ---- respond to a query: compute the hop toward ITS target
        q_target = head[NET_HDR].to(torch.int32)
        nxt = _next_hop(env.instance, q_target, n, bits)

        # ---- my lookup: a reply advances it
        running = mem["done"] == 0
        got_reply = running & is_r & (mem["t_sent"] >= 0)
        reply_next = head[NET_HDR].to(torch.int32)
        new_cur = torch.where(got_reply, reply_next, mem["cur"])
        mem["hops"] = mem["hops"] + got_reply.to(torch.int32)
        arrived = running & (new_cur == mem["target"])
        mem["cur"] = new_cur
        mem["t_sent"] = torch.where(got_reply, -1, mem["t_sent"])

        # ---- timeout / retry
        timed_out = (
            running
            & (mem["t_sent"] >= 0)
            & (env.tick - mem["t_sent"] > tmo)
        )
        mem["retries"] = mem["retries"] + timed_out.to(torch.int32)
        gave_up = timed_out & (mem["retries"] > max_retries) & ~arrived
        just_finished = arrived | gave_up
        mem["done"] = torch.where(
            arrived, 1, torch.where(gave_up, 2, mem["done"])
        )
        mem["t_sent"] = torch.where(timed_out, -1, mem["t_sent"])

        # ---- sends: a stashed or just-computed reply takes the lane
        from_stash = can_send & ~stash_free
        fresh_reply = can_send & stash_free & is_q
        send_reply = from_stash | fresh_reply
        stash_now = is_q & ~can_send
        mem["r_dest"] = torch.where(
            stash_now, head[F_SRC].to(torch.int32),
            torch.where(from_stash, -1, mem["r_dest"]),
        )
        mem["r_pay"] = torch.where(
            stash_now, nxt.to(torch.float32), mem["r_pay"]
        )
        need_query = (
            (mem["done"] == 0) & (mem["t_sent"] < 0) & ~send_reply & can_send
        )
        dest = torch.where(
            from_stash,
            mem["r_dest"],
            torch.where(
                fresh_reply, head[F_SRC].to(torch.int32), mem["cur"]
            ),
        )
        port = torch.where(send_reply, PORT_R, PORT_Q)
        payload_val = torch.where(
            from_stash,
            mem["r_pay"],
            torch.where(
                fresh_reply,
                nxt.to(torch.float32),
                mem["target"].to(torch.float32),
            ),
        )
        sending = send_reply | need_query
        mem["t_sent"] = torch.where(need_query, env.tick, mem["t_sent"])

        pay = _payload(payload_val, P)

        # advance only once the egress queue AND the reply stash drained
        finished = (mem["done"] > 0) & can_send & (mem["r_dest"] < 0)
        return mem, PhaseCtrl(
            advance=finished.to(torch.int32),
            send_dest=torch.where(sending, dest, -1),
            send_tag=TAG_DATA,
            send_port=port,
            send_size=MSG_BYTES,
            send_payload=pay,
            recv_count=consume.to(torch.int32),
            metric_id=torch.where(
                just_finished,
                torch.where(arrived, m_ok, m_fail),
                -1,
            ),
            metric_value=mem["hops"].to(torch.float32),
        )

    b.phase(pump, "dht:pump")
    b.record_point("lookup_ms", lambda env, mem: env.ms(env.tick - mem["t0"]))
    b.record_point("retries",
                   lambda env, mem: mem["retries"].to(torch.float32))

    # keep answering other peers' queries for a bounded linger window
    done_state = b.states.state("lookups-done")
    b.signal("lookups-done")
    b.mark_tick("t_tail")
    linger_ms = (max_retries + 1) * timeout_ms + bits * 4 * latency_ms

    def serve_tail(env, mem):
        mem = dict(mem)
        can_send = env.egress_ready()
        head = env.inbox_entry(0)
        have = (env.inbox_avail > 0) & can_send
        is_q = have & (head[F_TAG] == TAG_DATA) & (head[F_PORT] == PORT_Q)
        q_target = head[NET_HDR].to(torch.int32)
        nxt = _next_hop(env.instance, q_target, n, bits)
        all_done = env.barrier_done(done_state, n)
        lingered = env.tick - mem["t_tail"] > env.ticks_for_ms(linger_ms)
        pay = _payload(nxt.to(torch.float32), P)
        return mem, PhaseCtrl(
            advance=((all_done | lingered) & can_send).to(torch.int32),
            send_dest=torch.where(is_q, head[F_SRC].to(torch.int32), -1),
            send_tag=TAG_DATA,
            send_port=PORT_R,
            send_size=MSG_BYTES,
            send_payload=pay,
            recv_count=have.to(torch.int32),
        )

    b.phase(serve_tail, "dht:serve-tail")
    b.end_ok()


testcases = {"find-providers": find_providers}
