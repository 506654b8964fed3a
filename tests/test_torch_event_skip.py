"""Event-horizon scheduling in the port (testground_tpu_torch/sim/core.py
``next_event_tick`` / ``skip_step``) against the JAX package's
``event_skip_loop``, on the default lowering: a plan whose lanes sleep
(the burst plan of tests/test_pallas_front.py, transcribed to torch)
jumps over dead ticks in both packages and leaves every state leaf equal;
the dense loop (``event_skip=False``) does too; and forcing event skip
with the fused deliver front is refused alike."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from testground_tpu_torch.sim.core import EVENT_SKIP_STATE_LEAVES
from testground_tpu_torch.sim.program import TAG_DATA, onehot_set
from testground_tpu_torch.sim.state_io import flatten, state_to_numpy

CFG = dict(quantum_ms=10.0, max_ticks=400)


def _burst_common(b):
    n = b.ctx.n_instances
    b.enable_net(inbox_capacity=8, payload_len=2, head_k=1,
                 send_slots=max(4, n // 8))
    b.wait_network_initialized()
    b.configure_network(latency_ms=20.0, loss=5.0, callback_state="shaped",
                        callback_target=n)
    return n


def jax_burst_plan(b):
    """tests/test_pallas_front.py's burst plan: everyone bursts six
    messages at a ring of neighbors through loss + latency links, reads
    them back, then sleeps 400 ms."""
    n = _burst_common(b)

    def burst(env, mem):
        mem = dict(mem)
        step = mem["i"]
        sending = (step < 6) & env.egress_ready()
        dest = (env.instance + 1 + step) % n
        pay = jnp.zeros((2,), jnp.float32).at[0].set(
            env.instance.astype(jnp.float32))
        mem["i"] = step + sending.astype(jnp.int32)
        return mem, JCtrl(
            advance=jnp.int32((step >= 6) & env.egress_ready()),
            send_dest=jnp.where(sending, dest, -1),
            send_tag=TAG_DATA, send_port=7, send_size=64.0,
            send_payload=pay,
            recv_count=jnp.int32(env.inbox_avail > 0),
        )

    b.declare("i", (), jnp.int32, 0)
    b.phase(burst, "burst")
    b.sleep_ms(400.0)
    b.end_ok()


def torch_burst_plan(b):
    """The same plan, line for line, in torch."""
    n = _burst_common(b)

    def burst(env, mem):
        mem = dict(mem)
        step = mem["i"]
        sending = (step < 6) & env.egress_ready()
        dest = torch.remainder(env.instance + 1 + step, n)
        pay = onehot_set(torch.zeros(2, dtype=torch.float32,
                                     device=step.device), 0,
                         env.instance.to(torch.float32))
        mem["i"] = step + sending.to(torch.int32)
        return mem, TCtrl(
            advance=((step >= 6) & env.egress_ready()).to(torch.int32),
            send_dest=torch.where(sending, dest, -1),
            send_tag=TAG_DATA, send_port=7, send_size=64.0,
            send_payload=pay,
            recv_count=(env.inbox_avail > 0).to(torch.int32),
        )

    b.declare("i", (), torch.int32, 0)
    b.phase(burst, "burst")
    b.sleep_ms(400.0)
    b.end_ok()


def jax_exec(n, **kw):
    ctx = JCtx([JGroup("single", 0, n, {})], test_case="burst", test_run="t")
    return j_compile(jax_burst_plan, ctx,
                     JConfig(chunk_ticks=400, **CFG, **kw),
                     mesh=instance_mesh(jax.devices()[:1]))


def torch_exec(n, **kw):
    ctx = TCtx([TGroup("single", 0, n, {})], test_case="burst", test_run="t")
    return t_compile(torch_burst_plan, ctx,
                     TConfig(chunk_ticks=16, **CFG, **kw), device="cpu")


def assert_leaves_equal(jax_state, torch_state):
    a = flatten(jax.device_get(jax_state))
    b = flatten(state_to_numpy(torch_state))
    assert set(a) == set(b), set(a) ^ set(b)
    for k in sorted(a):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(y, x, err_msg=k)


@pytest.mark.parametrize("n,event_skip", [(64, None), (300, None),
                                          (64, False)])
def test_burst_plan_bit_equal(n, event_skip):
    jex, tex = jax_exec(n, event_skip=event_skip), \
        torch_exec(n, event_skip=event_skip)
    assert tex.event_skip == jex.event_skip == (event_skip is None)
    jres, tres = jex.run(), tex.run()
    assert not jres.timed_out()
    assert tres.ticks == jres.ticks
    assert tres.ticks_executed == jres.ticks_executed
    np.testing.assert_array_equal(tres.statuses(), jres.statuses())
    assert_leaves_equal(jres.state, tres.state)
    if event_skip is None:
        # the 400 ms sleep is jumped over in both packages
        assert tres.ticks_executed < tres.ticks
        assert tres.skip_ratio == jres.skip_ratio < 1.0
        assert "ticks_executed" in EVENT_SKIP_STATE_LEAVES
    else:
        assert "ticks_executed" not in tres.state
        assert tres.ticks_executed == tres.ticks


def test_event_skip_with_pallas_front_is_refused_alike():
    with pytest.raises(ValueError) as je:
        jax_exec(300, event_skip=True, pallas_front=True)
    with pytest.raises(ValueError) as te:
        torch_exec(300, event_skip=True, pallas_front=True)
    assert str(te.value) == str(je.value)


def test_skip_leaves_equal_the_fused_front_run():
    """The JAX package's own contract (tests/test_pallas_front.py): the
    default lowering and the fused front leave the same state, but for
    the skip plane's bookkeeping leaf."""
    a = flatten(state_to_numpy(torch_exec(300).run().state))
    b = flatten(state_to_numpy(torch_exec(300, pallas_front=True).run()
                               .state))
    assert a.pop("ticks_executed") < 400
    assert set(a) == set(b)
    for k in sorted(a):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
