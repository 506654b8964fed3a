"""The port's Engine (testground_tpu_torch/engine/) against the JAX
package's, in-process on the CPU, each over an in-memory task store in
its own home: a build task's artifacts and prepared composition, a run
whose plan is found under the home's ``plans/``, the task error of a
plan with no manifest, of a prewarmed ``[search]`` and of an unknown
runner, the wedged-dispatch requeue (a run whose first dispatch raises
``WedgedDispatchError`` is retried with backoff from its checkpoint), the
retries' exhaustion, ``resume_task``'s refusals, and the status posts
(GitHub commit status and Slack message) of a run a CI created. Task
rows are compared but their walls (tests/_runner_parity.py
``task_view``); every wait is on a task's state."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import shutil
import threading
import time

import pytest
from _runner_parity import (
    REPO,
    composition,
    engines,
    jax_on_one_device,
    task_view,
)

from testground_tpu.api import Composition as JComposition
from testground_tpu.engine import EngineError as JEngineError
from testground_tpu.engine.status import StatusReporter as JReporter
from testground_tpu.runner import get_runner as jget_runner
from testground_tpu.sim.checkpoint import WedgedDispatchError as JWedged
from testground_tpu_torch.api import Composition as TComposition
from testground_tpu_torch.engine import EngineError as TEngineError
from testground_tpu_torch.engine.status import StatusReporter as TReporter
from testground_tpu_torch.runner import get_runner as tget_runner
from testground_tpu_torch.sim.checkpoint import (
    WedgedDispatchError as TWedged,
)

PLACEBO = str(REPO / "plans" / "placebo")


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_TASK_RETRY_BACKOFF_S", "0.01")
    with jax_on_one_device():
        je, te = engines(tmp_path)
        try:
            yield je, te
        finally:
            je.close()
            te.close()


def comps(d):
    return JComposition.from_dict(d), TComposition.from_dict(d)


def wait_both(je, te, tid):
    with jax_on_one_device():
        return je.wait(tid, timeout=300), te.wait(tid, timeout=300)


def views(je, te, tid):
    return (task_view(je.get_task(tid).to_dict(), je.env.home),
            task_view(te.get_task(tid).to_dict(), te.env.home))


def test_build_task_matches_jax(pair):
    je, te = pair
    jc, tc = comps(composition("placebo", "ok", 2))
    for eng, c in ((je, jc), (te, tc)):
        assert eng.queue_build(c, sources_dir=PLACEBO) is not None
    jt = je.tasks()[0]
    tt = te.tasks()[0]
    for eng, t in ((je, jt), (te, tt)):
        eng.wait(t.id, timeout=120)
    jv, tv = (task_view(e.get_task(t.id).to_dict(), e.env.home)
              for e, t in ((je, jt), (te, tt)))
    jv.pop("id"), tv.pop("id")
    assert tv == jv
    arts = tv["result"]["artifacts"]
    assert list(arts) == ["single"] and arts["single"].startswith(
        "<home>/data/work/")
    assert je.build_purge("placebo") == te.build_purge("placebo") == 1


def test_run_of_a_plan_in_the_home_matches_jax(pair):
    je, te = pair
    for eng in (je, te):
        shutil.copytree(PLACEBO, eng.env.dirs.plans / "placebo")
    jc, tc = comps(composition("placebo", "metrics", 3))
    assert je.queue_run(jc, task_id="m") == te.queue_run(tc, task_id="m")
    jt, tt = wait_both(je, te, "m")
    assert tt.outcome == jt.outcome == "success"
    jv, tv = views(je, te, "m")
    assert tv == jv
    assert "starting run m: plan=placebo case=metrics" in te.logs("m")


def test_task_errors_match_jax(pair):
    je, te = pair
    jc, tc = comps(composition("placebo", "ok", 2))
    # no sources and no plan under the home
    assert je.queue_run(jc, task_id="nop") == te.queue_run(tc,
                                                           task_id="nop")
    search = composition("benchmarks", "cliff", 4, {"x_fail": "0.5"},
                         search={"param": "x", "lo": 0.0, "hi": 1.0,
                                 "step": 0.25})
    jc, tc = comps(search)
    for eng, c in ((je, jc), (te, tc)):
        eng.queue_prewarm(c, sources_dir=str(REPO / "plans" / "benchmarks"),
                          task_id="pw")
    for tid in ("nop", "pw"):
        jt, tt = wait_both(je, te, tid)
        jv, tv = views(je, te, tid)
        assert tv == jv, tid
        assert tv["error"] == jv["error"] != ""
    assert te.get_task("nop").error.startswith(
        "EngineError: plan not found (no manifest.toml): ")
    assert "prewarm does not support [search]" in te.get_task("pw").error
    bad = composition("placebo", "ok", 2, runner="local:nosuch")
    errs = []
    for eng, cls, c in ((je, JEngineError, comps(bad)[0]),
                        (te, TEngineError, comps(bad)[1])):
        with pytest.raises(cls) as e:
            eng.queue_run(c)
        errs.append(str(e.value))
    assert errs[1] == errs[0] == "unknown runner: local:nosuch"
    # resume_task's refusals
    jc, tc = comps(composition("placebo", "ok", 2))
    for eng, c in ((je, jc), (te, tc)):
        eng.queue_build(c, sources_dir=PLACEBO, created_by={"k": 1})
    errs = []
    for eng, cls in ((je, JEngineError), (te, TEngineError)):
        bid = next(t.id for t in eng.tasks() if t.type == "build")
        with pytest.raises(cls) as e:
            eng.resume_task(bid)
        errs.append(str(e.value).replace(bid, "<id>"))
        with pytest.raises(cls):
            eng.resume_task("nosuch")
    assert errs[1] == errs[0]


class _WedgeOnce:
    """A runner whose first ``run`` raises the package's
    WedgedDispatchError (its dispatch watchdog's), then runs."""

    def __init__(self, runner, exc):
        self.real, self.exc, self.calls = runner.run, exc, 0

    def __call__(self, rinput, *a, **kw):
        self.calls += 1
        if self.calls == 1:
            raise self.exc("chunk 0 dispatch exceeded its deadline")
        return self.real(rinput, *a, **kw)


def test_wedged_dispatch_is_requeued_as_jax_does(pair, monkeypatch):
    je, te = pair
    jr, tr = jget_runner("sim:jax"), tget_runner("sim:jax")
    monkeypatch.setattr(jr, "run", _WedgeOnce(jr, JWedged))
    monkeypatch.setattr(tr, "run", _WedgeOnce(tr, TWedged))
    jc, tc = comps(composition("placebo", "ok", 2))
    for eng, c in ((je, jc), (te, tc)):
        eng.queue_run(c, sources_dir=PLACEBO, task_id="w")
    jt, tt = wait_both(je, te, "w")
    for t in (jt, tt):
        assert [s.state for s in t.states] == [
            "scheduled", "processing", "wedged", "scheduled",
            "processing", "complete"]
        assert t.attempts == 1 and t.outcome == "success"
        assert t.input["resume"] is True
    jv, tv = views(je, te, "w")
    assert tv == jv
    for eng in (je, te):
        assert "requeued with 0.0s backoff" in eng.logs("w")


def test_wedged_retries_exhausted_as_jax_does(pair, monkeypatch):
    je, te = pair
    monkeypatch.setenv("TG_TASK_MAX_ATTEMPTS", "1")
    jr, tr = jget_runner("sim:jax"), tget_runner("sim:jax")
    monkeypatch.setattr(jr, "run", _WedgeOnce(jr, JWedged))
    monkeypatch.setattr(tr, "run", _WedgeOnce(tr, TWedged))
    jc, tc = comps(composition("placebo", "ok", 2))
    for eng, c in ((je, jc), (te, tc)):
        eng.queue_run(c, sources_dir=PLACEBO, task_id="x")
    jt, tt = wait_both(je, te, "x")
    assert tt.error == jt.error == (
        "WedgedDispatchError: chunk 0 dispatch exceeded its deadline")
    assert tt.outcome == jt.outcome == "failure"
    jv, tv = views(je, te, "x")
    assert tv == jv


def test_status_posts_match_jax(pair):
    je, te = pair
    posts = {"jax": [], "port": []}
    lock = threading.Lock()

    def poster(side):
        def post(url, headers, body):
            with lock:
                posts[side].append((url, headers, body))
        return post

    for eng, cls, side in ((je, JReporter, "jax"), (te, TReporter, "port")):
        eng.status = cls(github_token="tok", slack_webhook_url="http://s",
                         tasks_url="http://d/tasks", poster=poster(side))
    jc, tc = comps(composition("placebo", "ok", 2))
    by = {"repo": "o/r", "branch": "main", "commit": "abc"}
    for eng, c in ((je, jc), (te, tc)):
        eng.queue_run(c, sources_dir=PLACEBO, task_id="ci", created_by=by)
    wait_both(je, te, "ci")
    deadline = time.monotonic() + 30
    while any(len(p) < 3 for p in posts.values()):
        assert time.monotonic() < deadline, posts
        time.sleep(0.01)
    time.sleep(0.1)

    def norm(p):
        return sorted((u, sorted(h.items()),
                       b.decode().split(" run succeeded")[0])
                      for u, h, b in p)

    assert norm(posts["port"]) == norm(posts["jax"])
    assert len(posts["port"]) == 3


def test_two_identical_builds_at_once_share_one_artifact(tmp_path,
                                                         monkeypatch):
    """Two scheduler workers may build the same plan at once: both stage
    the same digest, and both must get the one staged directory. The
    copies are held at a barrier so that both are staging together."""
    from testground_tpu_torch.api import TestPlanManifest
    from testground_tpu_torch.api.contracts import BuildInput
    from testground_tpu_torch.builders import sim_module
    from testground_tpu_torch.config import EnvConfig

    env = EnvConfig.load(str(tmp_path / "home"))
    env.dirs.ensure()
    manifest = TestPlanManifest.load(f"{PLACEBO}/manifest.toml")
    comp = TComposition.from_dict(
        composition("placebo", "ok", 2)).prepare_for_build(manifest)
    binput = BuildInput(
        build_id="b", env_config=env, source_dir=PLACEBO,
        select_build=comp.groups[0], composition=comp, manifest=manifest)
    barrier = threading.Barrier(2, timeout=30)
    copytree = shutil.copytree

    def held_copytree(*a, **kw):
        barrier.wait()
        return copytree(*a, **kw)

    monkeypatch.setattr(sim_module.shutil, "copytree", held_copytree)
    out, errs = [], []

    def build():
        try:
            out.append(sim_module.SimModuleBuilder().build(binput))
        except Exception as e:  # noqa: BLE001 (reported below)
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert errs == [] and len(out) == 2
    art = out[0].artifact_path
    assert out[1].artifact_path == art
    work = env.dirs.work
    assert [p.name for p in work.iterdir()] == [art.rsplit("/", 1)[1]]
    staged = sorted(p.relative_to(art).as_posix()
                    for p in sim_module.Path(art).rglob("*"))
    src = sorted(p.relative_to(PLACEBO).as_posix()
                 for p in sim_module.Path(PLACEBO).rglob("*")
                 if "__pycache__" not in p.parts
                 and not p.name.endswith(".pyc"))
    assert staged == sorted(src + [".testground_plan"])
