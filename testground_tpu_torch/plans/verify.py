"""Verify plan — the port's torch transcription of ``plans/verify``'s sim
plan, in the same op order: each instance sends one byte to its right
neighbour over the data plane and must receive one from its left (a
reachability ring over the whole instance set)."""

import torch

from ..sim import PhaseCtrl
from ..sim.net import F_PORT, F_TAG, NET_HDR
from ..sim.program import TAG_DATA, onehot_set

PORT = 7777


def uses_data_network(b):
    n = b.ctx.n_instances
    b.wait_network_initialized()

    sent = b.declare("sent", (), torch.int32, 0)
    rcvd = b.declare("rcvd", (), torch.int32, 0)
    got = b.declare("got", (), torch.float32, -1.0)

    def ring(env, mem):
        right = (env.instance + 1) % n
        have = env.inbox_avail > 0
        head = env.inbox_entry(0)
        is_data = have & (head[F_TAG] == TAG_DATA) & (head[F_PORT] == PORT)
        mem = dict(mem)
        mem[got] = torch.where(is_data, head[NET_HDR], mem[got])
        was_sent = mem[sent] > 0
        now_rcvd = (mem[rcvd] > 0) | is_data
        done = was_sent & now_rcvd
        mem[sent] = torch.clamp(mem[sent], min=1)
        mem[rcvd] = now_rcvd.to(torch.int32)
        pay = onehot_set(head.new_zeros((b._net_spec.payload_len,)), 0,
                         env.instance.to(torch.float32))
        return mem, PhaseCtrl(
            advance=done.to(torch.int32),
            send_dest=torch.where(was_sent, -1, right),
            send_tag=TAG_DATA,
            send_port=PORT,
            send_size=1.0,
            send_payload=pay,
            recv_count=is_data.to(torch.int32),
        )

    b.phase(ring, name="ring")
    # the byte must have come from my left neighbour over the data plane
    b.fail_if(
        lambda env, mem: mem[got] != ((env.instance - 1) % n).to(
            torch.float32),
        "byte did not arrive from the left neighbour",
    )
    b.signal_and_wait("verified")
    b.end_ok()


testcases = {"uses-data-network": uses_data_network}
