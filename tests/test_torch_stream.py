"""Stream topics in the port (testground_tpu_torch/sim/core.py
``_stream_push``, the ``topic_head`` register, ``stream_violations``)
against the JAX package, on the CPU: each program runs in both packages
and every state leaf must be equal, bit for bit, with the same ticks.
The first three mirror tests/test_sim_core.py's
``TestRaggedStreamTopics`` and ``test_stream_topic_head_register`` and
keep their assertions; the others cover a -0.0 payload (which the JAX
package's masked sum stores as +0.0), ticks with no publisher, and two
stream topics published on the same tick."""

import jax.numpy as jnp
import numpy as np
import torch
from _storm_parity import assert_leaves_equal

from testground_tpu.parallel import instance_mesh
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import PhaseCtrl as JCtrl
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_program as j_compile
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import PhaseCtrl as TCtrl
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import compile_program as t_compile

CFG = dict(chunk_ticks=64, max_ticks=1000)


def run_pair(jbuild, tbuild, n=3, **cfg):
    """Both builds at ``n`` instances on the CPU: (JAX result, port
    result), every leaf held equal and the ticks the same."""
    import jax

    cfg = dict(CFG, **cfg)
    chunk = cfg.pop("chunk_ticks")
    jr = j_compile(
        jbuild, JCtx([JGroup("single", 0, n, {})], test_case="t",
                     test_run="r"),
        JConfig(chunk_ticks=chunk, **cfg),
        mesh=instance_mesh(jax.devices()[:1]),
    ).run()
    tr = t_compile(
        tbuild, TCtx([TGroup("single", 0, n, {})], test_case="t",
                     test_run="r"),
        TConfig(chunk_ticks=8, **cfg), device="cpu",
    ).run()
    assert tr.ticks == jr.ticks
    assert assert_leaves_equal(jr.state, tr.state) > 0
    assert tr.stream_violations() == jr.stream_violations()
    return jr, tr


class TestRaggedStreamTopics:
    def test_stream_topic_full_payload_contents(self):
        iters, pay = 6, 16

        def jbuild(b):
            tid = b.topics.topic("data", capacity=iters, payload_len=pay,
                                 stream=True)
            b.topics.topic("small", capacity=4, payload_len=1)
            ctr = b.declare("i", (), jnp.int32, 0)

            def pump(env, mem):
                i = mem[ctr]
                is_pub = env.instance == 0
                have = env.topic_count(tid)
                consume = (~is_pub) & (have > i) & (i < iters)
                do_pub = is_pub & (i < iters)
                nxt = jnp.where(do_pub | consume, i + 1, i)
                return {**mem, ctr: nxt}, JCtrl(
                    advance=jnp.int32(nxt >= iters),
                    publish_topic=jnp.where(do_pub, tid, -1),
                    publish_payload=jnp.full((pay,), jnp.float32(i * 10)),
                )

            b.phase(pump)
            b.publish("small", capacity=4,
                      payload_fn=lambda env, mem: jnp.float32(env.instance))
            b.end_ok()

        def tbuild(b):
            tid = b.topics.topic("data", capacity=iters, payload_len=pay,
                                 stream=True)
            b.topics.topic("small", capacity=4, payload_len=1)
            ctr = b.declare("i", (), torch.int32, 0)

            def pump(env, mem):
                i = mem[ctr]
                is_pub = env.instance == 0
                have = env.topic_count(tid)
                consume = (~is_pub) & (have > i) & (i < iters)
                do_pub = is_pub & (i < iters)
                nxt = torch.where(do_pub | consume, i + 1, i)
                return {**mem, ctr: nxt}, TCtrl(
                    advance=(nxt >= iters).to(torch.int32),
                    publish_topic=torch.where(do_pub, tid, -1),
                    publish_payload=(i * 10).to(torch.float32).expand(pay),
                )

            b.phase(pump)
            b.publish("small", capacity=4,
                      payload_fn=lambda env, mem: env.instance.to(
                          torch.float32))
            b.end_ok()

        _, res = run_pair(jbuild, tbuild)
        assert res.outcomes() == {"single": (3, 3)}
        buf = res.state["topic_bufs"][0].numpy()
        assert buf.shape == (iters, pay)
        want = np.repeat(
            (np.arange(iters, dtype=np.float32) * 10)[:, None], pay, 1)
        assert (buf == want).all()
        small_buf = res.state["topic_bufs"][1].numpy()
        assert small_buf.shape == (4, 1)
        assert sorted(small_buf[:3, 0]) == [0.0, 1.0, 2.0]
        # the head register holds the last row pushed, for the stream
        # topic only
        assert set(res.state["topic_head"]) == {0}
        assert (res.state["topic_head"][0].numpy() == 50.0).all()

    def test_stream_violation_is_counted_first_arrival_kept(self):
        iters, pay = 4, 3

        def jbuild(b):
            tid = b.topics.topic("s", capacity=iters, payload_len=pay,
                                 stream=True)

            def pump(env, mem):
                return mem, JCtrl(
                    advance=1, publish_topic=tid,
                    publish_payload=jnp.full(
                        (pay,), jnp.float32(env.instance + 1)),
                )

            b.phase(pump)
            b.end_ok()

        def tbuild(b):
            tid = b.topics.topic("s", capacity=iters, payload_len=pay,
                                 stream=True)

            def pump(env, mem):
                return mem, TCtrl(
                    advance=1, publish_topic=tid,
                    publish_payload=(env.instance + 1).to(
                        torch.float32).expand(pay),
                )

            b.phase(pump)
            b.end_ok()

        _, res = run_pair(jbuild, tbuild)
        assert res.stream_violations() == 2  # 3 publishers, 1 allowed
        buf = res.state["topic_bufs"][0].numpy()
        assert (buf[0] == 1.0).all()  # the first arrival, instance 0
        # seq counts every publish; the rows after the first stay empty
        assert int(res.state["topic_len"][0]) == 3
        assert (buf[1:] == 0.0).all()


def test_stream_topic_head_register():
    def jbuild(b):
        tid = b.topics.topic("s", capacity=8, payload_len=2, stream=True)
        b.topics.topic("plain", capacity=4, payload_len=1)  # no register
        b.declare("step", (), jnp.int32, 0)
        b.declare("seen", (4,), jnp.float32, 0.0)

        def pump(env, mem):
            mem = dict(mem)
            step = mem["step"]
            mem["step"] = step + 1
            do_pub = (env.instance == 0) & (step < 4)
            have = env.topic_count(tid)
            mem["seen"] = jnp.where(
                (jnp.arange(4) == step - 1) & (have > 0),
                env.topic_head[tid][1],
                mem["seen"],
            )
            return mem, JCtrl(
                advance=jnp.int32(step >= 5),
                publish_topic=jnp.where(do_pub, tid, -1),
                publish_payload=jnp.stack(
                    [step.astype(jnp.float32), step * 10.0]),
            )

        b.phase(pump, "pump")
        b.end_ok()

    def tbuild(b):
        tid = b.topics.topic("s", capacity=8, payload_len=2, stream=True)
        b.topics.topic("plain", capacity=4, payload_len=1)
        b.declare("step", (), torch.int32, 0)
        b.declare("seen", (4,), torch.float32, 0.0)

        def pump(env, mem):
            mem = dict(mem)
            step = mem["step"]
            mem["step"] = step + 1
            do_pub = (env.instance == 0) & (step < 4)
            have = env.topic_count(tid)
            mem["seen"] = torch.where(
                (torch.arange(4) == step - 1) & (have > 0),
                env.topic_head[tid][1],
                mem["seen"],
            )
            return mem, TCtrl(
                advance=(step >= 5).to(torch.int32),
                publish_topic=torch.where(do_pub, tid, -1),
                publish_payload=torch.stack(
                    [step.to(torch.float32), step * 10.0]),
            )

        b.phase(pump, "pump")
        b.end_ok()

    ex = t_compile(tbuild, TCtx([TGroup("g", 0, 3, {})]),
                   TConfig(chunk_ticks=100, max_ticks=1000), device="cpu")
    assert set(ex.init_state()["topic_head"]) == {0}  # stream only
    _, res = run_pair(jbuild, tbuild)
    assert (res.statuses()[:3] == 1).all()
    seen = res.state["mem"]["seen"].numpy()
    for inst in range(3):
        assert list(seen[inst]) == [0.0, 10.0, 20.0, 30.0], seen[inst]


def test_negative_zero_payload_stored_as_positive_zero():
    """A -0.0 lane of the pushed row is +0.0 in the buffer and the head,
    as the JAX package's masked sum leaves it; other values keep their
    bits."""
    pay = 3

    def jbuild(b):
        tid = b.topics.topic("s", capacity=4, payload_len=pay, stream=True)

        def pump(env, mem):
            return mem, JCtrl(
                advance=1,
                publish_topic=jnp.where(env.instance == 1, tid, -1),
                publish_payload=jnp.array([-0.0, -1.5, -0.0], jnp.float32),
            )

        b.phase(pump)
        b.end_ok()

    def tbuild(b):
        tid = b.topics.topic("s", capacity=4, payload_len=pay, stream=True)

        def pump(env, mem):
            return mem, TCtrl(
                advance=1,
                publish_topic=torch.where(env.instance == 1, tid, -1),
                publish_payload=torch.tensor([-0.0, -1.5, -0.0]),
            )

        b.phase(pump)
        b.end_ok()

    _, res = run_pair(jbuild, tbuild)
    for row in (res.state["topic_bufs"][0][0], res.state["topic_head"][0]):
        assert not torch.signbit(row[0]) and not torch.signbit(row[2])
        assert float(row[1]) == -1.5


def test_ticks_without_a_publisher_leave_the_topic_as_it_was():
    """The publisher pushes on every third step only; on the other ticks
    the push is a no-op (its select keeps the slot and the head), while
    every lane records the head each step."""
    pay, steps = 2, 9

    def jbuild(b):
        tid = b.topics.topic("s", capacity=4, payload_len=pay, stream=True)
        b.declare("step", (), jnp.int32, 0)
        b.declare("seen", (steps,), jnp.float32, -1.0)

        def pump(env, mem):
            mem = dict(mem)
            step = mem["step"]
            mem["step"] = step + 1
            do_pub = (env.instance == 0) & (step % 3 == 1)
            mem["seen"] = jnp.where(jnp.arange(steps) == step,
                                    env.topic_head[tid][0] + step,
                                    mem["seen"])
            return mem, JCtrl(
                advance=jnp.int32(step >= steps - 1),
                publish_topic=jnp.where(do_pub, tid, -1),
                publish_payload=jnp.stack(
                    [step.astype(jnp.float32) + 0.25, -step * 2.0]),
            )

        b.phase(pump, "pump")
        b.end_ok()

    def tbuild(b):
        tid = b.topics.topic("s", capacity=4, payload_len=pay, stream=True)
        b.declare("step", (), torch.int32, 0)
        b.declare("seen", (steps,), torch.float32, -1.0)

        def pump(env, mem):
            mem = dict(mem)
            step = mem["step"]
            mem["step"] = step + 1
            do_pub = (env.instance == 0) & (step % 3 == 1)
            mem["seen"] = torch.where(torch.arange(steps) == step,
                                      env.topic_head[tid][0] + step,
                                      mem["seen"])
            return mem, TCtrl(
                advance=(step >= steps - 1).to(torch.int32),
                publish_topic=torch.where(do_pub, tid, -1),
                publish_payload=torch.stack(
                    [step.to(torch.float32) + 0.25, -step * 2.0]),
            )

        b.phase(pump, "pump")
        b.end_ok()

    _, res = run_pair(jbuild, tbuild, n=2)
    buf = res.state["topic_bufs"][0].numpy()
    assert buf.tolist() == [[1.25, -2.0], [4.25, -8.0], [7.25, -14.0],
                            [0.0, 0.0]]
    assert res.state["topic_head"][0].tolist() == [7.25, -14.0]
    # the head a step reads is the row pushed on an earlier tick
    seen = res.state["mem"]["seen"].numpy()[0]
    assert seen.tolist() == [0.0, 1.0, 3.25, 4.25, 5.25, 9.25, 10.25,
                             11.25, 15.25]


def test_two_stream_topics_published_on_the_same_tick():
    """Lane 0 pushes into topic a and lane 1 into topic b on the same
    ticks; lane 2 also pushes into b on the first tick (a violation
    there only)."""

    def jbuild(b):
        ta = b.topics.topic("a", capacity=3, payload_len=2, stream=True)
        tb = b.topics.topic("b", capacity=3, payload_len=4, stream=True)
        b.declare("step", (), jnp.int32, 0)

        def pump(env, mem):
            step = mem["step"]
            inst = env.instance
            topic = jnp.where(inst == 0, ta, jnp.where(
                (inst == 1) | ((inst == 2) & (step == 0)), tb, -1))
            v = (inst * 100 + step).astype(jnp.float32)
            return {**mem, "step": step + 1}, JCtrl(
                advance=jnp.int32(step >= 2),
                publish_topic=topic,
                publish_payload=jnp.stack([v, v + 0.5, -v, v * 2.0]),
            )

        b.phase(pump, "pump")
        b.end_ok()

    def tbuild(b):
        ta = b.topics.topic("a", capacity=3, payload_len=2, stream=True)
        tb = b.topics.topic("b", capacity=3, payload_len=4, stream=True)
        b.declare("step", (), torch.int32, 0)

        def pump(env, mem):
            step = mem["step"]
            inst = env.instance
            topic = torch.where(inst == 0, ta, torch.where(
                (inst == 1) | ((inst == 2) & (step == 0)), tb, -1))
            v = (inst * 100 + step).to(torch.float32)
            return {**mem, "step": step + 1}, TCtrl(
                advance=(step >= 2).to(torch.int32),
                publish_topic=topic,
                publish_payload=torch.stack([v, v + 0.5, -v, v * 2.0]),
            )

        b.phase(pump, "pump")
        b.end_ok()

    _, res = run_pair(jbuild, tbuild)
    assert res.stream_violations() == 1
    a, bb = (res.state["topic_bufs"][k].numpy() for k in (0, 1))
    assert a.tolist() == [[0.0, 0.5], [1.0, 1.5], [2.0, 2.5]]
    # b: lane 1's row on the first tick (lane 2's dropped), its seq slot 1
    # left empty, then lane 1's second row; the third is past capacity
    assert bb[0].tolist() == [100.0, 100.5, -100.0, 200.0]
    assert (bb[1] == 0.0).all()
    assert bb[2].tolist() == [101.0, 101.5, -101.0, 202.0]
    assert res.state["topic_head"][1].tolist() == [101.0, 101.5, -101.0,
                                                    202.0]
