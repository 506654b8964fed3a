"""Shared helpers of the runner parity tests (tests/test_torch_runner*.py,
tests/test_torch_cli.py): one composition run through the JAX package's
``run_composition`` and the port's, on the CPU into separate run
directories; the comparison of what they write is the port's own
(testground_tpu_torch/runner/outputs.py ``assert_runs_equal``).

The JAX runner runs on a one-device mesh (as every other parity test
builds its JAX executables): on the tests' eight-device CPU mesh it
would pad the instance axis to a multiple of eight and journal
``mesh: {"instance": 8}``. Both executor pools are emptied before each
pair, so both journal ``executor_cache: "miss"``, and the JAX runner's
persistent compilation cache is off for its runs (nothing is written
outside the run directories). The dispatch heartbeat (a progress row
for every 5 s a chunk runs) is set past any chunk here: its rows count
wall time, not the run."""

import contextlib
import os
from pathlib import Path

import jax

from testground_tpu.api import contracts as jcontracts
from testground_tpu.parallel import mesh as jmesh
from testground_tpu.sim import core as jcore
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch.api import contracts as tcontracts
from testground_tpu_torch.runner.outputs import (  # noqa: F401
    assert_runs_equal,
    deterministic,
    output_files,
    progress_rows,
    run_out_lines,
    summary,
)
from testground_tpu_torch.sim import runner as trunner

REPO = Path(__file__).resolve().parent.parent

@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def one_device_jax():
    """The JAX runner's default mesh on one CPU device."""
    real = jcore.instance_mesh
    jcore.instance_mesh = lambda devices=None: jmesh.instance_mesh(
        jax.devices()[:1] if devices is None else devices)
    try:
        with _env(TESTGROUND_JAX_CACHE="off"):
            yield
    finally:
        jcore.instance_mesh = real


def rinputs(plan, case, groups, run_dir_j, run_dir_t, run_id="parity",
            run_config=None, **tables):
    """The JAX and the port's RunInput of one composition: ``groups`` is
    a list of (id, instances, params); ``tables`` maps a table name
    (``trace``, ``faults``, ``checkpoint``, ``resume``...) to a pair
    (JAX value, port value) or to one value both take."""
    art = str(REPO / "plans" / plan)

    def make(mod, run_dir, side):
        kw = {k: (v[side] if isinstance(v, tuple) else v)
              for k, v in tables.items()}
        return mod.RunInput(
            run_id=run_id, env_config=None, run_dir=str(run_dir),
            test_plan=plan, test_case=case,
            total_instances=sum(g[1] for g in groups),
            groups=[mod.RunGroup(id=g, instances=n, artifact_path=art,
                                 parameters=dict(p))
                    for g, n, p in groups],
            plan_dir=art, run_config=dict(run_config or {}), **kw)

    return make(jcontracts, run_dir_j, 0), make(tcontracts, run_dir_t, 1)


@contextlib.contextmanager
def jax_sees_one_device():
    """``jax.devices()`` cut to its first device: the JAX sweep plane
    picks its (scenario, instance) mesh from the visible devices, and a
    search's sweep takes no ``[sweep] mesh`` to pin it."""
    real = jax.devices
    jax.devices = lambda *a, **k: real(*a, **k)[:1]
    try:
        yield
    finally:
        jax.devices = real


class PreemptAt:
    """A runner's should_stop hook that preempts its run at boundary
    ``k`` (1-based), as a SIGTERM landing during that chunk would."""

    def __init__(self, runner, k):
        self.runner, self.k = runner, k
        self.real = runner._make_should_stop

    def __enter__(self):
        runner, k = self.runner, self.k

        def make(rinput):
            rid, calls = rinput.run_id, [0]
            ev = runner._term_event(rid)

            def should_stop():
                calls[0] += 1
                if calls[0] == k:
                    runner.request_preempt(rid)
                return ev.is_set()

            return should_stop

        runner._make_should_stop = make

    def __exit__(self, *exc):
        self.runner._make_should_stop = self.real


NO_HEARTBEAT = {"TG_DISPATCH_HEARTBEAT_S": "86400"}


def run_jax(ri, clear=True):
    if clear:
        jrunner._EX_CACHE.clear()
    with one_device_jax(), _env(**NO_HEARTBEAT):
        return jrunner.run_composition(ri)


def run_port(ri, clear=True):
    if clear:
        trunner.clear_executor_pool()
    with _env(**NO_HEARTBEAT):
        return trunner.run_composition(ri, device="cpu")


def run_pair(plan, case, groups, tmp, **kw):
    """Both runners on one composition; returns ((jax out, dir), (port
    out, dir))."""
    jd, td = Path(tmp) / "jax", Path(tmp) / "port"
    ri_j, ri_t = rinputs(plan, case, groups, jd, td, **kw)
    return (run_jax(ri_j), jd), (run_port(ri_t), td)
