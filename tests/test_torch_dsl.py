"""The DSL pieces of the port's phase programs that the benchmarks plan
brought in (testground_tpu_torch/sim/program.py ``elapsed_point``,
``ticks_to_secs``, ``end_fail``, ``end_crash``, ``send_message``)
against the JAX package on the CPU: every state leaf equal, bit for
bit, with the same ticks."""

import jax.numpy as jnp
import numpy as np
import pytest
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
from testground_tpu_torch.sim.program import CRASHED, DONE_FAIL, DONE_OK


def run_pair(jbuild, tbuild, n, **cfg):
    import jax

    cfg = dict(dict(max_ticks=1000), **cfg)
    jr = j_compile(
        jbuild, JCtx([JGroup("single", 0, n, {})], test_case="t",
                     test_run="r"),
        JConfig(chunk_ticks=1000, **cfg),
        mesh=instance_mesh(jax.devices()[:1]),
    ).run()
    tr = t_compile(
        tbuild, TCtx([TGroup("single", 0, n, {})], test_case="t",
                     test_run="r"),
        TConfig(chunk_ticks=16, **cfg), device="cpu",
    ).run()
    assert tr.ticks == jr.ticks
    assert assert_leaves_equal(jr.state, tr.state) > 0
    return jr, tr


SPAN = 5_000  # tick differences 0..SPAN, one a lane


@pytest.mark.parametrize("quantum_ms", [1.0, 10.0])
def test_elapsed_point_every_difference(quantum_ms):
    """Lane i marks tick 1 - i, so its elapsed_point at tick 1 records i
    ticks: every difference in 0..5,000, held bit for bit to the JAX
    lowering of ``(tick - t0) * quantum_ms / 1e3``."""

    def jbuild(b):
        b.declare("t0", (), jnp.int32, 0)
        b.phase(lambda env, mem: ({**mem, "t0": 1 - env.instance},
                                  JCtrl(advance=1)))
        b.elapsed_point("e", "t0")
        b.end_ok()

    def tbuild(b):
        b.declare("t0", (), torch.int32, 0)
        b.phase(lambda env, mem: ({**mem, "t0": 1 - env.instance},
                                  TCtrl(advance=1)))
        b.elapsed_point("e", "t0")
        b.end_ok()

    _, res = run_pair(jbuild, tbuild, SPAN + 1, quantum_ms=quantum_ms,
                      metrics_capacity=1)
    got = res.state["metrics_buf"][:, 0, 2].numpy()
    d = np.arange(SPAN + 1, dtype=np.float32)
    assert np.allclose(got, d * quantum_ms / 1e3, rtol=1e-6, atol=0)
    if quantum_ms != 1.0:
        # the folded constant is not the two-step product: this range
        # tells them apart (so the leaf check above is not vacuous)
        two_step = (d * np.float32(quantum_ms)) * (np.float32(1)
                                                   / np.float32(1e3))
        assert (two_step.view(np.int32) != got.view(np.int32)).any()


def _ends(b, ctrl, where, n_pc):
    """A branch phase to end_ok / end_fail / end_crash by instance % 3."""
    pc = n_pc

    def branch(env, mem):
        k = env.instance % 3
        return mem, ctrl(jump=where(k == 0, pc + 1,
                                    where(k == 1, pc + 2, pc + 3)))

    b.phase(branch, "branch")
    b.end_ok()
    b.end_fail()
    b.end_crash()


def _entry_common(b):
    b.enable_net(inbox_capacity=8, payload_len=3, head_k=1)
    b.wait_network_initialized()


def test_send_message_entry_mode_and_ends():
    """Entry mode: each lane sends one 64-byte message to the next lane
    with a 2-float payload (padded to payload_len 3), reads the record
    back, then ends ok, failed or crashed by instance % 3."""
    n = 6

    def jbuild(b):
        _entry_common(b)
        b.declare("got", (8,), jnp.float32, 0.0)
        b.send_message(
            lambda env, mem: (env.instance + 1) % n, 5, 64.0,
            payload_fn=lambda env, mem: jnp.stack(
                [env.instance.astype(jnp.float32), -2.5]))

        def read(env, mem):
            have = env.inbox_avail >= 1
            return ({**mem, "got": jnp.where(have, env.inbox_entry(0),
                                             mem["got"])},
                    JCtrl(advance=jnp.int32(have),
                          recv_count=jnp.where(have, 1, 0)))

        b.phase(read, "read")
        _ends(b, JCtrl, jnp.where, len(b._phases))

    def tbuild(b):
        _entry_common(b)
        b.declare("got", (8,), torch.float32, 0.0)
        b.send_message(
            lambda env, mem: torch.remainder(env.instance + 1, n), 5, 64.0,
            payload_fn=lambda env, mem: torch.stack(
                [env.instance.to(torch.float32),
                 torch.full_like(env.instance, -2.5, dtype=torch.float32)]))

        def read(env, mem):
            have = env.inbox_avail >= 1
            return ({**mem, "got": torch.where(have, env.inbox_entry(0),
                                               mem["got"])},
                    TCtrl(advance=have.to(torch.int32),
                          recv_count=torch.where(have, 1, 0)))

        b.phase(read, "read")
        _ends(b, TCtrl, torch.where, len(b._phases))

    _, res = run_pair(jbuild, tbuild, n)
    st = res.statuses()[:n].tolist()
    assert st == [DONE_OK, DONE_FAIL, CRASHED] * 2
    got = res.state["mem"]["got"].numpy()
    for i in range(n):
        # header (visible, src, tag, port, size), then the padded payload
        assert got[i, 1:].tolist() == [(i - 1) % n, 0.0, 5.0, 64.0,
                                       float((i - 1) % n), -2.5, 0.0]


def test_send_message_count_mode_and_ends():
    """Count mode: each lane sends one message of instance + 1 bytes to
    the next lane (no payload) and waits until it has one arrival."""
    n = 6

    def jbuild(b):
        b.enable_net(count_only=True)
        b.wait_network_initialized()
        b.send_message(lambda env, mem: (env.instance + 1) % n, 9,
                       lambda env, mem: env.instance + 1.0)

        def read(env, mem):
            have = env.inbox_avail >= 1
            return mem, JCtrl(advance=jnp.int32(have),
                              recv_count=env.inbox_avail)

        b.phase(read, "read")
        b.record_point("bytes", lambda env, mem: env.inbox_bytes)
        _ends(b, JCtrl, jnp.where, len(b._phases))

    def tbuild(b):
        b.enable_net(count_only=True)
        b.wait_network_initialized()
        b.send_message(lambda env, mem: torch.remainder(env.instance + 1, n),
                       9, lambda env, mem: env.instance + 1.0)

        def read(env, mem):
            have = env.inbox_avail >= 1
            return mem, TCtrl(advance=have.to(torch.int32),
                              recv_count=env.inbox_avail)

        b.phase(read, "read")
        b.record_point("bytes", lambda env, mem: env.inbox_bytes)
        _ends(b, TCtrl, torch.where, len(b._phases))

    _, res = run_pair(jbuild, tbuild, n)
    assert res.statuses()[:n].tolist() == [DONE_OK, DONE_FAIL, CRASHED] * 2
    recs = res.metrics_records()
    assert sorted((r["instance"], r["value"]) for r in recs) == [
        (i, float((i - 1) % n + 1)) for i in range(n)]
