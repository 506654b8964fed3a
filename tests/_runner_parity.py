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
wall time, not the run.

The daemon and engine parity tests (tests/test_torch_daemon.py,
tests/test_torch_engine.py) take a JAX engine and the port's engine
(``device="cpu"``) here, each over an in-memory task store in its own
``$TESTGROUND_HOME``, with the JAX runner on one device and its disk
executor tier off (``TG_EXECUTOR_CACHE_DIR=off``: the tier the port does
not have), and compare their task rows and outputs tarballs but their
walls."""

import contextlib
import io
import json
import os
import re
import tarfile
from pathlib import Path

import jax

from testground_tpu.api import contracts as jcontracts
from testground_tpu.parallel import mesh as jmesh
from testground_tpu.sim import core as jcore
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch.api import contracts as tcontracts
from testground_tpu_torch.runner.outputs import (  # noqa: F401
    ROW_WALL_KEYS,
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


# ------------------------------------------------- engines and daemons

# every test's environment: the JAX disk tier and its persistent XLA
# cache off, no heartbeat rows
ENV = {"TG_EXECUTOR_CACHE_DIR": "off", "TESTGROUND_JAX_CACHE": "off",
       "TG_DISPATCH_HEARTBEAT_S": "86400"}
PLANS = REPO / "plans"


@contextlib.contextmanager
def jax_on_one_device():
    """The JAX runner's instance mesh and sweep device list on the first
    CPU device, for every thread (the engines' workers included)."""
    with jax_sees_one_device(), one_device_jax(), _env(**ENV):
        yield


def engines(tmp: Path, workers: int = 2):
    """(JAX engine, port engine) over in-memory stores, homes under
    ``tmp``; the port's runs on the CPU."""
    from testground_tpu.config import EnvConfig as JEnvConfig
    from testground_tpu.engine import Engine as JEngine
    from testground_tpu.task import MemoryTaskStorage as JMemory
    from testground_tpu_torch.config import EnvConfig as TEnvConfig
    from testground_tpu_torch.engine import Engine as TEngine
    from testground_tpu_torch.task import MemoryTaskStorage as TMemory

    jcfg = JEnvConfig.load(str(tmp / "jax"))
    tcfg = TEnvConfig.load(str(tmp / "port"))
    jcfg.dirs.ensure()
    tcfg.dirs.ensure()
    jrunner._EX_CACHE.clear()
    trunner.clear_executor_pool()
    return (JEngine(env_config=jcfg, storage=JMemory(), workers=workers),
            TEngine(env_config=tcfg, storage=TMemory(), workers=workers,
                    device="cpu"))


def composition(plan, case, n, params=None, run_config=None, builder=True,
                runner="sim:jax", **tables) -> dict:
    """A composition's dict form (what POST /run carries): one group of
    ``n`` instances, the sim:module builder, and ``tables`` as given."""
    g = {"plan": plan, "case": case, "runner": runner,
         "total_instances": n}
    if builder:
        g["builder"] = "sim:module"
    if run_config:
        g["run_config"] = dict(run_config)
    grp = {"id": "single", "instances": {"count": n}}
    if params:
        grp["run"] = {"test_params": {k: str(v) for k, v in params.items()}}
    return {"metadata": {}, "global": g, "groups": [grp], **tables}


def _scrub(obj, home):
    """``obj`` with the home directory written ``<home>`` and uploaded
    sources' temporary directory names written ``<sources>``."""
    text = json.dumps(obj, sort_keys=True).replace(str(home), "<home>")
    text = re.sub(r"<home>/data/work/sources/[A-Za-z0-9_]+", "<sources>",
                  text)
    return json.loads(text)


def task_view(d: dict, home) -> dict:
    """A task row but its walls: its states' names only, no ``created``
or ``backoff_until``,
    the journal's deterministic keys, the progress snapshot without its
    wall fields, home paths scrubbed."""
    d = dict(d)
    d.pop("created", None)
    d.pop("backoff_until", None)
    d["states"] = [s["state"] for s in d.get("states", [])]
    res = d.get("result")
    if isinstance(res, dict) and isinstance(res.get("journal"), dict):
        run_dir = Path(home) / "data" / "outputs" / d["plan"] / d["id"]
        res = dict(res)
        res["journal"] = deterministic(res["journal"], run_dir)
        d["result"] = res
    if isinstance(d.get("progress"), dict):
        d["progress"] = {k: v for k, v in d["progress"].items()
                         if k not in ROW_WALL_KEYS}
    return _scrub(d, home)


def untar(data: bytes, dest: Path) -> list:
    """Unpack an outputs tarball into ``dest``; its member names."""
    dest.mkdir(parents=True, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tf:
        names = sorted(tf.getnames())
        tf.extractall(dest, filter="data")
    return names


def assert_outputs_equal(jdata: bytes, tdata: bytes, tmp: Path, jrun: Path,
                         trun: Path, rows=True) -> dict:
    """Two outputs tarballs of the runs written to ``jrun`` and ``trun``:
    the same member names, and what they hold equal but their walls
    (runner/outputs.py ``assert_runs_equal``, the run directories in
    the summaries' paths written ``<run_dir>``); returns the port's
    summary."""
    jn = untar(jdata, tmp / "tar-jax")
    tn = untar(tdata, tmp / "tar-port")
    assert tn == jn, sorted(set(tn) ^ set(jn))
    a, b = tmp / "tar-jax" / jrun.name, tmp / "tar-port" / trun.name
    sa, sb = summary(a), summary(b)
    assert deterministic(sb, trun) == deterministic(sa, jrun)
    assert run_out_lines(b) == run_out_lines(a)
    fa, fb = output_files(a), output_files(b)
    assert sorted(fb) == sorted(fa)
    for name in fa:
        assert fb[name] == fa[name], name
    if rows:
        assert progress_rows(b) == progress_rows(a)
    return sb
