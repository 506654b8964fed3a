"""Example plan — the port's torch transcription of ``plans/example``'s
sim plan (the reference's example cases as phase programs), in the same
op order."""

import torch

from ..sim import PhaseCtrl


def output(b):
    b.log("hello, world")
    b.end_ok()


def failure(b):
    b.log("intentional failure")
    b.end_fail()


def panic(b):
    b.log("intentional panic")
    b.end_crash()


def params(b):
    p1 = b.ctx.static_param_int("param1", 1)
    p2 = b.ctx.static_param_int("param2", 2)
    p3 = b.ctx.static_param_int("param3", 3)
    if (p1, p2, p3) == (0, 0, 0):
        b.end_fail()
    else:
        b.record_point("param_sum", lambda env, mem: float(p1 + p2 + p3))
        b.end_ok()


def sync(b):
    """Leader/follower: publish-seq 1 leads; every instance signals
    'ready' and waits for all, then each signals 'released' and waits
    for all."""
    n = b.ctx.n_instances
    b.publish(
        "enrolled",
        capacity=max(n, 1),
        payload_fn=lambda env, mem: env.instance.to(torch.float32),
        save_seq="seq",
    )
    b.declare("is_leader", (), torch.int32, 0)

    def set_role(env, mem):
        return (
            {**mem, "is_leader": (mem["seq"] == 1).to(torch.int32)},
            PhaseCtrl(advance=1),
        )

    b.phase(set_role, name="set_role")
    b.signal_and_wait("ready")
    b.signal("released")
    b.barrier("released", target=n)
    b.end_ok()


def metrics(b):
    b.record_point("example.counter1", lambda env, mem: 7.0)
    b.record_point("example.gauge1", lambda env, mem: 3.5)
    b.end_ok()


def artifact(b):
    # the plan's artifact ships with its sources and is checked on the
    # host side; the sim records success
    b.log("artifact available in plan sources")
    b.end_ok()


testcases = {
    "output": output,
    "failure": failure,
    "panic": panic,
    "params": params,
    "sync": sync,
    "metrics": metrics,
    "artifact": artifact,
}
