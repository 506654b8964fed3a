"""The benchmarks plan's ``storm`` case: the port's torch transcription
of ``plans/benchmarks/sim.py`` ``storm`` (the reference's
plans/benchmarks/storm.go), line for line and in the same op order.

Wait for network init → (shaped: ConfigureNetwork) → SignalAndWait
"listening" → share addresses over the "peers" topic → SignalAndWait
"got-other-addrs" → ``conn_outgoing`` dials to random peers after random
delays in [0, conn_delay_ms), recording dial.ok / dial.fail → rendezvous
on "outgoing-dials-done" → write ``data_size_kb`` KiB per connection in
4 KiB chunks while draining the count-only inbox → SignalAndWait "done
writing" → drain until quiet. ``link_latency_ms`` / ``link_loss_pct``
route deliveries through the count-mode delay wheel and give dials SYN
retries; ``churn_tolerant`` makes the rendezvous churn-tolerant.

The other cases of the JAX plan (barrier, subtree, sparsetimer, cliff)
are still to port (ROADMAP.md).
"""

import torch

from ..sim import prng
from ..sim.net import recip
from ..sim.program import TAG_DATA, PhaseCtrl, onehot_get, onehot_set


def storm(b):
    ctx = b.ctx
    n = ctx.n_instances
    conn_count = ctx.static_param_int("conn_count", 5)
    outgoing = ctx.static_param_int("conn_outgoing", 5)
    delay_ms = ctx.static_param_int("conn_delay_ms", 30_000)
    size_bytes = ctx.static_param_int("data_size_kb", 128) * 1024
    quiet_ms = ctx.static_param_int("storm_quiet_ms", 500)
    dial_timeout_ms = ctx.static_param_int("dial_timeout_ms", 30_000)
    chunk_b = 4096  # storm.go buffersize
    chunks = max(1, -(-size_bytes // chunk_b))
    last_b = size_bytes - (chunks - 1) * chunk_b
    drain_k = 8  # inbox entries consumed per tick (accept-handler rate)
    port = 9000

    link_loss = float(ctx.static_param_int("link_loss_pct", 0))
    link_loss_corr = float(ctx.static_param_int("link_loss_corr_pct", 0))
    link_latency = float(ctx.static_param_int("link_latency_ms", 0))
    churn_tol = ctx.static_param_int("churn_tolerant", 0) > 0
    dial_retries = ctx.static_param_int(
        "dial_retries", 3 if (link_loss > 0 or churn_tol) else 0
    )
    cw = 1 if churn_tol else 0  # barrier churn weight

    b.enable_net(
        count_only=True,
        payload_len=1,
        send_slots=(n // 16) if n > 200_000 else None,
    )
    b.log(f"running with data_size_kb: {size_bytes // 1024}")
    b.log(f"running with conn_outgoing: {outgoing}")
    b.log(f"running with conn_count: {conn_count}")
    b.log(f"running with conn_delay_ms: {delay_ms}")
    b.wait_network_initialized(churn_weight=cw)
    if link_loss > 0 or link_latency > 0:
        b.configure_network(
            latency_ms=link_latency,
            loss=link_loss,
            loss_corr=link_loss_corr,
            callback_state="storm-shaped",
            callback_target=n,
            churn_weight=cw,
        )

    b.record_point("listens.ok", lambda env, mem: float(conn_count))
    b.signal_and_wait("listening", churn_weight=cw)

    # shareAddresses: publish my id, collect everyone's
    b.publish(
        "peers",
        capacity=ctx.padded_n,
        payload_fn=lambda env, mem: env.instance.to(torch.float32),
    )
    b.wait_topic("peers", capacity=ctx.padded_n, count=n, churn_weight=cw)
    b.signal_and_wait("got-other-addrs", churn_weight=cw)
    b.record_point("other.addrs", lambda env, mem: float(n - 1))
    b.record_point("got.info", lambda env, mem: float(n))

    b.declare("conns", (outgoing,), torch.int32, -1)
    b.declare("conn_ok", (outgoing,), torch.int32, 0)
    b.declare("bytes_sent", (), torch.float32, 0.0)
    b.declare("dial_fail_n", (), torch.int32, 0)

    m_dial_ok = b.metrics.metric("dial.ok")
    m_dial_fail = b.metrics.metric("dial.fail")

    def drain(env, k=drain_k):
        """Consume up to k visible arrivals (the accept-handler rate)."""
        return torch.clamp(env.inbox_avail, max=k)

    # ---- dial loop: all delays drawn up front, slept to in sorted order
    b.declare("dial_at", (outgoing,), torch.int32, 0)

    def schedule(env, mem):
        d = prng.randint(env.rng, (outgoing,), 0, max(delay_ms, 1))
        # d / quantum_ms as XLA lowers a division by a constant
        q = d.to(torch.float32) * recip(env.quantum_ms)
        ticks = torch.clamp(q, min=1.0).to(torch.int32)
        mem = dict(mem)
        mem["dial_at"] = env.tick + torch.sort(ticks).values
        return mem, PhaseCtrl(advance=1)

    b.phase(schedule, "storm:schedule")
    lp = b.loop_begin(outgoing)

    def pick(env, mem):
        r = prng.randint(env.rng, (), 0, max(n - 1, 1))
        dest = torch.remainder(torch.where(r >= env.instance, r + 1, r), n)
        mem = dict(mem)
        mem["conns"] = onehot_set(mem["conns"], mem[lp.slot], dest)
        return mem, PhaseCtrl(advance=1)

    b.phase(pick, "storm:pick")

    def delay(env, mem):
        target = onehot_get(mem["dial_at"], mem[lp.slot])
        return mem, PhaseCtrl(
            advance=1, sleep=torch.clamp(target - env.tick - 1, min=0)
        )

    b.phase(delay, "storm:delay")
    b.dial(
        lambda env, mem: onehot_get(mem["conns"], mem[lp.slot]),
        port=port,
        result_slot="dial_res",
        timeout_ms=float(dial_timeout_ms),
        elapsed_slot="dial_t",
        retries=dial_retries,
    )

    def record_dial(env, mem):
        ok = mem["dial_res"] == 1
        mem = dict(mem)
        mem["conn_ok"] = onehot_set(
            mem["conn_ok"], mem[lp.slot], ok.to(torch.int32)
        )
        mem["dial_fail_n"] = mem["dial_fail_n"] + (~ok).to(torch.int32)
        return mem, PhaseCtrl(
            advance=1,
            metric_id=torch.where(ok, m_dial_ok, m_dial_fail),
            metric_value=env.ms(mem["dial_t"]),
        )

    b.phase(record_dial, "storm:record_dial")
    b.signal("outgoing-dials-done")
    b.loop_end(lp)
    b.barrier("outgoing-dials-done", n * outgoing, churn_weight=cw * outgoing)

    # ---- write loop (send one chunk/tick, drain concurrently) -------
    wl = b.loop_begin(outgoing * chunks)

    def write_chunk(env, mem):
        i = mem[wl.slot]
        conn = i // chunks
        k = i % chunks
        sz = torch.where(k == chunks - 1, float(last_b), float(chunk_b))
        ok = onehot_get(mem["conn_ok"], conn) > 0
        mem = dict(mem)
        mem["bytes_sent"] = mem["bytes_sent"] + torch.where(ok, sz, 0.0)
        return mem, PhaseCtrl(
            advance=1,
            send_dest=torch.where(ok, onehot_get(mem["conns"], conn), -1),
            send_tag=TAG_DATA,
            send_port=port,
            send_size=sz,
            recv_count=drain(env),
        )

    b.phase(write_chunk, "storm:write")
    b.loop_end(wl)

    b.signal_and_wait("done writing", churn_weight=cw)

    # ---- drain until quiet
    b.declare("quiet", (), torch.int32, 0)

    def drain_rest(env, mem):
        take = drain(env)
        mem = dict(mem)
        mem["quiet"] = torch.where(take > 0, 0, mem["quiet"] + 1)
        done = mem["quiet"] >= env.ticks_for_ms(float(quiet_ms))
        return mem, PhaseCtrl(advance=done.to(torch.int32), recv_count=take)

    b.phase(drain_rest, "storm:drain")
    b.record_point("bytes.sent", lambda env, mem: mem["bytes_sent"])
    b.record_point("bytes.read", lambda env, mem: env.inbox_bytes)
    if link_loss <= 0 and not churn_tol:
        # strict mode: any dial failure fails the instance
        b.fail_if(lambda env, mem: mem["dial_fail_n"] > 0, "dial failed")
    b.log("done writing after barrier")
    b.end_ok()


testcases = {"storm": storm}
