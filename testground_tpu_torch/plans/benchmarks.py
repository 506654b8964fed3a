"""The benchmarks plan: the port's torch transcription of
``plans/benchmarks/sim.py`` (the reference's plans/benchmarks), case for
case, line for line and in the same op order.

- ``startup``: time to start (0 virtual seconds in the sim).
- ``netinit``: time to network initialization.
- ``netlinkshape``: time to apply a link-shape change.
- ``barrier``: iterations x {20, 40, 60, 80, 100}% barrier latency; the
  per-iteration states are runtime-indexed state families.
- ``subtree``: the publisher (publish seq 1) pumps ``iterations`` items a
  size class (64 B to 4 KiB, ``size/4`` f32 lanes) through a stream
  topic while every other instance consumes each item and verifies it
  against the topic's head register.
- ``storm``: wait for network init → (shaped: ConfigureNetwork) →
  SignalAndWait "listening" → share addresses over the "peers" topic →
  SignalAndWait "got-other-addrs" → ``conn_outgoing`` dials to random
  peers after random delays in [0, conn_delay_ms), recording dial.ok /
  dial.fail → rendezvous on "outgoing-dials-done" → write
  ``data_size_kb`` KiB per connection in 4 KiB chunks while draining the
  count-only inbox → SignalAndWait "done writing" → drain until quiet.
  ``link_latency_ms`` / ``link_loss_pct`` route deliveries through the
  count-mode delay wheel and give dials SYN retries; ``churn_tolerant``
  makes the rendezvous churn-tolerant.
- ``sparsetimer``: a ~1% duty-cycle timer plan (one beat tick, then a
  ``timer_period_ms`` sleep, in lockstep), the event-skip showcase.
- ``cliff``: every instance fails iff its ``x`` param exceeds its
  ``x_fail`` param.
"""

import torch

from ..sim import prng
from ..sim.net import recip
from ..sim.program import (
    TAG_DATA,
    PhaseCtrl,
    onehot_get,
    onehot_set,
    ticks_to_secs,
)

SIZES = (64, 128, 256, 512, 1024, 2048, 4096)


def startup(b):
    b.record_point("time_to_start_secs",
                   lambda env, mem: ticks_to_secs(env.tick, env.quantum_ms))
    b.end_ok()


def netinit(b):
    """Time to network initialization."""
    b.mark_tick("t0")
    b.wait_network_initialized()
    b.elapsed_point("time_to_network_init_secs", "t0")
    b.end_ok()


def netlinkshape(b):
    """Time to apply a link-shape change."""
    b.wait_network_initialized()
    b.mark_tick("t0")
    b.configure_network(
        latency_ms=250.0,
        callback_state="netlinkshape-callback",
        callback_target=1,
    )
    b.elapsed_point("time_to_shape_network_secs", "t0")
    b.end_ok()


def barrier(b):
    ctx = b.ctx
    iters = ctx.static_param_int("barrier_iterations", 10)
    n = ctx.n_instances

    lp = b.loop_begin(iters)
    for pct in (20, 40, 60, 80, 100):
        name = f"barrier_time_{pct}_percent"
        target = max(1, int(n * pct / 100))
        idx = lambda env, mem, s=lp.slot: mem[s]  # noqa: E731
        # everyone lines up, then the timed barrier waits on a SUBSET
        b.signal_and_wait(
            f"ready_{name}", family_size=iters, index_fn=idx
        )
        b.mark_tick(f"t0_{pct}")
        b.signal_and_wait(
            f"test_{name}", target=target, family_size=iters, index_fn=idx
        )
        b.elapsed_point(name, f"t0_{pct}")
    b.loop_end(lp)
    b.end_ok()


def subtree(b):
    ctx = b.ctx
    iters = ctx.static_param_int("subtree_iterations", 2000)
    n = ctx.n_instances

    # race to publish on the instances topic; seq 1 becomes THE publisher
    b.publish(
        "instances",
        capacity=max(n, 1),
        payload_fn=lambda env, mem: env.instance.to(torch.float32),
        save_seq="inst_seq",
    )
    b.declare("is_pub", (), torch.int32, 0)

    def set_role(env, mem):
        return ({**mem, "is_pub": (mem["inst_seq"] == 1).to(torch.int32)},
                PhaseCtrl(advance=1))

    b.phase(set_role, name="set_role")

    ctr = b.declare("item", (), torch.int32, 0)
    # receivers verify every consumed item against the stream topic's
    # head register; sub_bad counts content mismatches, sub_unverified
    # consumes of a row that is not the newest (0 in lockstep)
    b.declare("sub_bad", (), torch.int32, 0)
    b.declare("sub_unverified", (), torch.int32, 0)
    for size in SIZES:
        name = f"subtree_time_{size}_bytes"
        # the real payload rides the topic: size/4 f32 lanes
        pay = max(1, size // 4)
        tid = b.topics.topic(name, capacity=iters, payload_len=pay,
                             stream=True)
        b.mark_tick(f"t0_{size}")

        def pump(env, mem, tid=tid, pay=pay):
            """The publisher emits one item a tick; receivers consume as
            items arrive and verify each against the head register (row
            i must be [i]*pay: first and last lanes and the exact f32
            row sum, whose terms are equal and < 2^24)."""
            i = mem[ctr]
            is_pub = mem["is_pub"] == 1
            have = env.topic_count(tid)
            can_consume = (~is_pub) & (have > i) & (i < iters)
            newest = can_consume & (i == have - 1)
            head = env.topic_head[tid]
            fi = i.to(torch.float32)
            # the head is unmapped (shared): its sum runs once a tick
            head_sum = torch.sum(head)
            content_ok = (
                (head[0] == fi) & (head[pay - 1] == fi)
                & (head_sum == fi * pay)
            )
            mem = dict(mem)
            mem["sub_bad"] = mem["sub_bad"] + (newest & ~content_ok).to(
                torch.int32)
            mem["sub_unverified"] = mem["sub_unverified"] + (
                can_consume & ~newest
            ).to(torch.int32)
            do_pub = is_pub & (i < iters)
            nxt = torch.where(do_pub | can_consume, i + 1, i)
            done = nxt >= iters
            mem[ctr] = torch.where(done, 0, nxt)
            return mem, PhaseCtrl(
                advance=done.to(torch.int32),
                publish_topic=torch.where(do_pub, tid, -1),
                # a batched fill: expand, not torch.full (vmap)
                publish_payload=fi.expand(pay),
            )

        b.phase(pump, name=f"pump:{size}")
        b.elapsed_point(name + "_secs", f"t0_{size}")

    # everyone done (the reference's handoff/end states collapse to this)
    b.signal_and_wait("end")
    b.fail_if(
        lambda env, mem: (mem["sub_bad"] > 0) | (mem["sub_unverified"] > 0),
        "subtree payload verification",
    )
    b.end_ok()


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


def sparsetimer(b):
    """A ~1% duty-cycle timer plan: every instance runs ``timer_rounds``
    beats, each one active tick (a counter bump and one ping to the next
    lane) followed by a ``timer_period_ms`` sleep, in lockstep, so all
    but ~1/period of the simulated ticks are dead."""
    ctx = b.ctx
    n = ctx.n_instances
    rounds = ctx.static_param_int("timer_rounds", 20)
    period_ms = ctx.static_param_int("timer_period_ms", 100)

    b.enable_net(count_only=True)
    b.wait_network_initialized()
    b.declare("beats", (), torch.int32, 0)
    b.declare("pings", (), torch.int32, 0)

    lp = b.loop_begin(rounds)
    b.sleep_ms(float(period_ms))

    def beat(env, mem):
        mem = dict(mem)
        mem["beats"] = mem["beats"] + 1
        mem["pings"] = mem["pings"] + env.inbox_avail
        return mem, PhaseCtrl(
            advance=1,
            send_dest=torch.remainder(env.instance + 1, n),
            send_size=1.0,
            recv_count=env.inbox_avail,
        )

    b.phase(beat, "beat")
    b.loop_end(lp)
    b.record_point("beats", lambda env, mem: mem["beats"])
    b.record_point("pings", lambda env, mem: mem["pings"])
    b.signal_and_wait("timers-done")
    b.fail_if(lambda env, mem: mem["beats"] != rounds, "missed beats")
    b.end_ok()


def cliff(b):
    """A deterministic severity cliff: every instance fails iff its ``x``
    exceeds its ``x_fail``."""
    b.fail_if(
        lambda env, mem: env.params["x"] > env.params["x_fail"],
        "x above the cliff",
    )
    b.end_ok()
    return {
        "x": b.ctx.param_array_float("x", 0.0),
        "x_fail": b.ctx.param_array_float("x_fail", 0.5),
    }


testcases = {
    "startup": startup,
    "netinit": netinit,
    "netlinkshape": netlinkshape,
    "barrier": barrier,
    "subtree": subtree,
    "storm": storm,
    "sparsetimer": sparsetimer,
    "cliff": cliff,
}
