"""Network plan — the port's torch transcription of ``plans/network``'s
sim plan, in the same op order.

``ping-pong`` is the reference's traffic-shaping oracle: shape the link
to 100 ms latency + 1 Mib bandwidth, do a symmetric byte exchange and
assert the measured RTT falls in [200 ms, 215 ms]; drop latency to
10 ms and assert [20 ms, 35 ms].

``traffic-allowed`` / ``traffic-blocked``: dial the peer with and
without a DROP pair rule on the dialer's egress and assert the dial
succeeds or times out.
"""

import torch

from ..sim import PhaseCtrl
from ..sim.net import ACTION_DROP, F_PORT, F_TAG, NET_HDR
from ..sim.program import TAG_DATA, onehot_set

PORT = 1234


def _peer(env, mem):
    # 2-instance plan: the other instance
    return 1 - env.instance


def _exchange(b, name, payload_fn, expect_fn):
    """Symmetric byte exchange: send my byte to the peer, wait for the
    peer's byte, verify. One phase; both sides run it concurrently."""
    flag = b.declare(f"_x_sent_{name}", (), torch.int32, 0)
    rflag = b.declare(f"_x_rcvd_{name}", (), torch.int32, 0)
    got = b.declare(f"got_{name}", (), torch.float32, 0.0)

    def fn(env, mem):
        sent = mem[flag] > 0
        have = env.inbox_avail > 0
        head = env.inbox_entry(0)
        is_data = have & (head[F_TAG] == TAG_DATA) & (head[F_PORT] == PORT)
        rcvd = (mem[rflag] > 0) | is_data  # latch: the byte may arrive
        mem = dict(mem)  # before our send-flag is set
        mem[got] = torch.where(is_data, head[NET_HDR], mem[got])
        done = sent & rcvd
        mem[flag] = torch.where(done, 0, torch.clamp(mem[flag], min=1))
        mem[rflag] = torch.where(done, 0, rcvd.to(torch.int32))
        val = payload_fn(env, mem)
        val = (val.to(torch.float32) if isinstance(val, torch.Tensor)
               else float(val))
        pay = onehot_set(head.new_zeros((b._net_spec.payload_len,)), 0, val)
        return mem, PhaseCtrl(
            advance=done.to(torch.int32),
            send_dest=torch.where(sent, -1, _peer(env, mem)),
            send_tag=TAG_DATA,
            send_port=PORT,
            send_size=1.0,
            send_payload=pay,
            recv_count=is_data.to(torch.int32),
        )

    b.phase(fn, name=f"exchange:{name}")
    if expect_fn is not None:
        b.fail_if(
            lambda env, mem: mem[got] != expect_fn(env, mem),
            f"unexpected byte in {name}",
        )


def _pingpong_round(b, tag, rtt_min_ms, rtt_max_ms):
    # wait till both sides are ready (the reference's 0-byte sync write)
    _exchange(b, f"ready_{tag}", lambda env, mem: 0.0, None)
    b.mark_tick(f"rtt_t0_{tag}")
    # write my seq, read theirs
    _exchange(
        b,
        f"id_{tag}",
        lambda env, mem: env.instance + 1,
        lambda env, mem: 2 - env.instance,  # the peer's seq
    )
    # pong their id back, read my own
    _exchange(
        b,
        f"pong_{tag}",
        lambda env, mem: mem[f"got_id_{tag}"],
        lambda env, mem: env.instance + 1,  # my own seq comes back
    )
    b.elapsed_point(f"ping_rtt_{tag}", f"rtt_t0_{tag}")
    # assert the shaped-RTT window
    b.fail_if(
        lambda env, mem: (
            env.ms(env.tick - mem[f"rtt_t0_{tag}"]) < rtt_min_ms
        ) | (env.ms(env.tick - mem[f"rtt_t0_{tag}"]) > rtt_max_ms),
        f"RTT outside [{rtt_min_ms}, {rtt_max_ms}] ms",
    )
    b.signal_and_wait(f"ping-pong-{tag}")


def pingpong(b):
    b.enable_net(payload_len=2)
    b.wait_network_initialized()
    b.configure_network(
        latency_ms=100.0,
        bandwidth=1 << 20,  # 1 Mib
        callback_state="network-configured",
    )
    b.signal_and_wait("ip-allocation", save_seq="seq")
    b.publish(
        "peers", capacity=2,
        payload_fn=lambda env, mem: env.instance.to(torch.float32),
    )
    b.wait_topic("peers", capacity=2, count=2)

    _pingpong_round(b, "200", 200.0, 215.0)

    b.configure_network(
        latency_ms=10.0,
        bandwidth=1 << 20,
        callback_state="latency-reduced",
    )
    _pingpong_round(b, "10", 20.0, 35.0)
    b.end_ok()


def _traffic(b, blocked: bool):
    """Dial the peer with/without a DROP filter on the dialer's egress."""
    b.enable_net(pair_rules=True)
    b.wait_network_initialized()

    def rules(env, mem):
        n = b.ctx.padded_n
        ar = torch.arange(n, dtype=torch.int32, device=env.instance.device)
        row = torch.full_like(ar, -1)
        if blocked:
            # drop everything to the peer (row.at[1 - instance]: a
            # negative index counts from the end)
            peer = 1 - env.instance
            peer = torch.where(peer < 0, peer + n, peer)
            row = torch.where(ar == peer, ACTION_DROP, row)
        return row

    b.configure_network(
        latency_ms=5.0,
        rules_fn=rules if blocked else None,
        callback_state="net-configured",
    )
    # only instance 0 dials (instance 1 just serves)
    b.dial(
        lambda env, mem: torch.where(env.instance == 0, 1, -1),
        PORT,
        result_slot="dial_r",
        timeout_ms=200.0,
    )
    if blocked:
        b.fail_if(
            lambda env, mem: (env.instance == 0) & (mem["dial_r"] != -2),
            "dial should have timed out (DROP)",
        )
    else:
        b.fail_if(
            lambda env, mem: (env.instance == 0) & (mem["dial_r"] != 1),
            "dial should have succeeded",
        )
    b.signal_and_wait("done")
    b.end_ok()


def traffic_allowed(b):
    _traffic(b, blocked=False)


def traffic_blocked(b):
    _traffic(b, blocked=True)


testcases = {
    "ping-pong": pingpong,
    "traffic-allowed": traffic_allowed,
    "traffic-blocked": traffic_blocked,
}
