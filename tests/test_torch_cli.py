"""The port's entry point, ``python -m testground_tpu_torch`` (cli.py), and
its composition loading (api/composition.py, api/manifest.py), on the
CPU: every ``composition.toml`` under ``plans/`` yields, field by field,
the RunInput the JAX engine builds for it (engine/engine.py's run path:
``prepare_for_run`` against the plan's manifest, the groups' RunGroups,
the coalesced run config and every table); the run flags shape a
composition as the JAX command's do; ``run composition
plans/faultsdemo/composition.toml --device cpu`` exits 0 with grade PASS
and writes what the JAX runner writes for the same RunInput; SIGTERM
preempts the command's run and ``--resume`` finishes it; the
healthcheck reports each check. A local ``run composition`` goes through
the port's engine, so ``tasks`` and ``status`` list its task; ``daemon``
serves, and every command with ``--endpoint`` answers as the JAX
command does against a JAX daemon."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
from _runner_parity import (
    NO_HEARTBEAT,
    REPO,
    assert_runs_equal,
    output_files,
    run_jax,
)

from testground_tpu.api import Composition as JComposition
from testground_tpu.api import TestPlanManifest as JManifest
from testground_tpu.api.contracts import RunGroup as JRunGroup
from testground_tpu.api.contracts import RunInput as JRunInput
from testground_tpu.cmd.root import _apply_overrides
from testground_tpu.config.coalescing import CoalescedConfig as JCoalesced
from testground_tpu_torch import cli
from testground_tpu_torch.api.composition import Composition
from testground_tpu_torch.sim.tables import CompositionError

COMPOSITIONS = sorted(REPO.glob("plans/*/composition.toml"))


def jax_engine_rinput(path, run_id, home, comp=None):
    """What the JAX engine's run path builds for a composition file (or
    ``comp``, its loaded and overridden form) whose groups are built by
    the sim:module builder (artifact: the plan's directory)."""
    plan_dir = Path(path).parent
    comp = comp if comp is not None else JComposition.load(path)
    for g in comp.groups:
        g.run.artifact = g.run.artifact or str(plan_dir)
    manifest = JManifest.load(plan_dir / "manifest.toml")
    prepared = comp.prepare_for_run(manifest)
    run_dir = Path(home) / "data" / "outputs" / prepared.global_.plan / run_id
    return JRunInput(
        run_id=run_id, env_config=None, run_dir=str(run_dir),
        test_plan=prepared.global_.plan, test_case=prepared.global_.case,
        total_instances=prepared.global_.total_instances,
        groups=[JRunGroup(id=g.id, instances=g.calculated_instance_count,
                          artifact_path=g.run.artifact,
                          parameters=dict(g.run.test_params),
                          resources=g.resources,
                          profiles=dict(g.run.profiles))
                for g in prepared.groups],
        composition=prepared, manifest=manifest, plan_dir=str(plan_dir),
        disable_metrics=prepared.global_.disable_metrics,
        run_config=JCoalesced().append({}).append(
            prepared.global_.run_config).coalesce(),
        sweep=prepared.sweep, faults=prepared.faults, trace=prepared.trace,
        telemetry=prepared.telemetry, search=prepared.search,
        live=prepared.live, checkpoint=prepared.checkpoint,
        replay=prepared.replay)


def _as_dict(v):
    if hasattr(v, "to_dict"):
        return v.to_dict()
    if hasattr(v, "__dataclass_fields__"):
        return {k: _as_dict(getattr(v, k)) for k in v.__dataclass_fields__}
    if isinstance(v, list):
        return [_as_dict(x) for x in v]
    if isinstance(v, dict):
        return {k: _as_dict(x) for k, x in v.items()}
    return v


def assert_rinputs_equal(t, j):
    names = set(j.__dataclass_fields__)
    assert set(t.__dataclass_fields__) == names
    for name in sorted(names - {"env_config", "on_progress"}):
        assert _as_dict(getattr(t, name)) == _as_dict(getattr(j, name)), name


@pytest.mark.parametrize("path", COMPOSITIONS,
                         ids=[p.parent.name for p in COMPOSITIONS])
def test_composition_loads_as_the_jax_engine_loads_it(path, tmp_path):
    assert len(COMPOSITIONS) >= 2
    comp = Composition.load(path)
    assert comp.to_dict() == JComposition.load(path).to_dict()
    mine = cli.prepare_run(comp, path.parent, "r1", tmp_path)
    assert_rinputs_equal(mine, jax_engine_rinput(path, "r1", tmp_path))
    assert mine.composition.groups[0].calculated_instance_count > 0


def _args(**kw):
    base = dict(test_param=None, run_cfg=None, runner_override=None)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("flags", [
    {"test_param": ["chaos_loss=40", "pump_ms=100"]},
    {"run_cfg": ["max_ticks=900", "event_skip=false", "seed=3"]},
    {"no_faults": True, "no_telemetry": True},
    {"no_live": True, "no_checkpoint": True},
    {"live_interval": 0.5, "checkpoint_interval": 0.0},
    {"telemetry_interval": 20, "trace_on": True},
    {"sweep_seeds": 4},
    {"search_on": True},
    {"search_on": False},
    {"search_on": True, "search_budget": 8},
    {"search_budget": 0},
])
def test_run_flags_shape_the_composition_as_jax_does(flags, tmp_path):
    path = REPO / "plans" / "faultsdemo" / "composition.toml"
    mine, theirs = Composition.load(path), JComposition.load(path)
    cli.apply_overrides(mine, _args(**flags))
    _apply_overrides(theirs, _args(**flags))
    assert mine.to_dict() == theirs.to_dict()


def test_composition_errors_match_jax(tmp_path):
    path = REPO / "plans" / "faultsdemo" / "composition.toml"
    man = JManifest.load(path.parent / "manifest.toml")
    from testground_tpu_torch.api.manifest import TestPlanManifest

    tman = TestPlanManifest.load(path.parent / "manifest.toml")
    for edit in (
        lambda d: d["global"].update(total_instances=5),
        lambda d: d["groups"][0]["instances"].update(count=2000),
        lambda d: d["global"].update(case="nosuch"),
        lambda d: d["global"].update(runner="local:exec"),
        lambda d: d["groups"][1].update(id="left"),
    ):
        d = JComposition.load(path).to_dict()
        edit(d)
        with pytest.raises(Exception) as jerr:
            JComposition.from_dict(d).prepare_for_run(man)
        with pytest.raises(CompositionError) as terr:
            Composition.from_dict(d).prepare_for_run(tman)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("flags", [
    {"search_on": True}, {"search_budget": 8},
])
def test_search_flags_without_a_search_table_fail_as_jax_does(flags):
    path = REPO / "plans" / "election" / "composition.toml"
    with pytest.raises(Exception) as jerr:
        _apply_overrides(JComposition.load(path), _args(**flags))
    with pytest.raises(CompositionError) as terr:
        cli.apply_overrides(Composition.load(path), _args(**flags))
    assert str(terr.value) == str(jerr.value)
    assert "requires a [search] table" in str(terr.value)


def test_sweep_seeds_zero_fails_as_jax_does(tmp_path):
    path = REPO / "plans" / "faultsdemo" / "composition.toml"
    from testground_tpu_torch.api.manifest import TestPlanManifest

    mine, theirs = Composition.load(path), JComposition.load(path)
    cli.apply_overrides(mine, _args(sweep_seeds=0))
    _apply_overrides(theirs, _args(sweep_seeds=0))
    with pytest.raises(Exception) as jerr:
        theirs.prepare_for_run(JManifest.load(path.parent / "manifest.toml"))
    with pytest.raises(CompositionError) as terr:
        mine.prepare_for_run(TestPlanManifest.load(
            path.parent / "manifest.toml"))
    assert str(terr.value) == str(jerr.value)


def _cli(*args, home):
    env = dict(os.environ, TESTGROUND_HOME=str(home), **NO_HEARTBEAT)
    return subprocess.run(
        [sys.executable, "-m", "testground_tpu_torch", *args],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)


def test_cli_runs_faultsdemo_as_the_jax_runner_does(tmp_path):
    path = "plans/faultsdemo/composition.toml"
    proc = _cli("run", "composition", path, "--device", "cpu",
                "--run-id", "cli1", home=tmp_path / "home")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "run cli1: outcome success" in proc.stdout
    port_dir = tmp_path / "home" / "data" / "outputs" / "faultsdemo" / "cli1"
    s = json.loads((port_dir / "sim_summary.json").read_text())
    assert s["outcome"] == "success"
    assert s["outcomes"] == {"left": {"ok": 2, "total": 2},
                             "right": {"ok": 2, "total": 2}}
    ri = jax_engine_rinput(REPO / path, "cli1", tmp_path / "jaxhome")
    run_jax(ri)
    assert_runs_equal(ri.run_dir, port_dir)


@pytest.mark.parametrize("flags", [
    ("--sweep-seeds", "2"), ("--search", "--search-budget", "8"),
])
def test_cli_sweep_and_search_run_as_the_jax_runner_does(flags, tmp_path):
    """``run composition`` with ``--sweep-seeds`` (faultsdemo swept over
    2 seeds) and with ``--search`` (its own [search] table, capped at 8
    probes), each cut at 2,000 ticks: exit 0, and the files the JAX
    runner writes for the same RunInput."""
    from _runner_parity import jax_sees_one_device

    path = "plans/faultsdemo/composition.toml"
    proc = _cli("run", "composition", path, "--device", "cpu",
                "--run-id", "cli2", "--run-cfg", "max_ticks=2000", *flags,
                home=tmp_path / "home")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "run cli2: outcome success" in proc.stdout
    port_dir = tmp_path / "home" / "data" / "outputs" / "faultsdemo" / "cli2"
    comp = JComposition.load(REPO / path)
    _apply_overrides(comp, _args(
        run_cfg=["max_ticks=2000"],
        sweep_seeds=2 if "--sweep-seeds" in flags else None,
        search_on=True if "--search" in flags else None,
        search_budget=8 if "--search" in flags else None))
    ri = jax_engine_rinput(REPO / path, "cli2", tmp_path / "jaxhome",
                           comp=comp)
    with jax_sees_one_device():
        run_jax(ri)
    s = assert_runs_equal(ri.run_dir, port_dir)
    assert s["outcome"] == "success"
    if "--search" in flags:
        assert s["scenarios_probed"] <= 8 and s["compiles"] == 1
        assert (port_dir / "round" / "0" / "scenario" / "0"
                / "results.out").exists()
    else:
        assert [r["seed"] for r in s["scenarios"]] == [0, 1]


def test_cli_refuses_a_plan_the_port_lacks_and_needs_a_card(tmp_path):
    plan = tmp_path / "plans" / "myplan"
    plan.mkdir(parents=True)
    (plan / "manifest.toml").write_text(
        'name = "myplan"\n[runners."sim:jax"]\nenabled = true\n'
        '[[testcases]]\nname = "ok"\ninstances = { min = 1, max = 4 }\n')
    (plan / "sim.py").write_text("import testground_tpu\n")
    comp = tmp_path / "c.toml"
    comp.write_text(
        '[global]\nplan = "myplan"\ncase = "ok"\nrunner = "sim:jax"\n'
        'total_instances = 1\n[[groups]]\nid = "g"\n'
        'instances = { count = 1 }\n')
    proc = _cli("run", "composition", str(comp), "--device", "cpu",
                home=tmp_path)
    assert proc.returncode == 2
    assert "'myplan' has no port" in proc.stderr
    import torch

    if not torch.cuda.is_available():
        # the card is the default device: without one the run raises
        proc = _cli("run", "composition", "plans/faultsdemo/composition.toml",
                    home=tmp_path)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr


def test_sigterm_preempts_the_cli_run_and_resume_finishes_it(tmp_path,
                                                          monkeypatch):
    """SIGTERM, as a scheduler stops a job with, preempts the command's
    run at its next chunk boundary (outcome preempted, a resume token and
    a final checkpoint); ``--resume RUN_ID`` then finishes it with the
    outputs of an uninterrupted run."""
    import signal
    import threading

    from testground_tpu_torch.sim import runner as trunner

    monkeypatch.setenv("TESTGROUND_HOME", str(tmp_path))
    for k, v in NO_HEARTBEAT.items():
        monkeypatch.setenv(k, v)
    flags = ["run", "composition",
             str(REPO / "plans/faultsdemo/composition.toml"), "--device",
             "cpu", "--run-cfg", "chunk_ticks=25",
             "--checkpoint-interval", "0"]
    outputs = tmp_path / "data" / "outputs" / "faultsdemo"
    assert cli.main(flags + ["--run-id", "whole"]) == 0

    def send_when_running():
        while "stopped" not in trunner._TERM_FLAGS:
            time.sleep(0.005)
        os.kill(os.getpid(), signal.SIGTERM)

    chained = []

    def guard(*a):
        chained.append(a)

    prev = signal.signal(signal.SIGTERM, guard)
    try:
        sender = threading.Thread(target=send_when_running, daemon=True)
        sender.start()
        assert cli.main(flags + ["--run-id", "stopped"]) == 1
        sender.join(timeout=60)
        # the command restores the handler it found
        assert signal.getsignal(signal.SIGTERM) is guard
    finally:
        signal.signal(signal.SIGTERM, prev)
    # the engine's handler chains the handler it found, as JAX's does
    assert len(chained) == 1
    s = json.loads((outputs / "stopped" / "sim_summary.json").read_text())
    assert s["outcome"] == "preempted" and s["resume_token"] == "stopped"
    whole = json.loads((outputs / "whole" / "sim_summary.json").read_text())
    assert 0 < s["ticks"] < whole["ticks"] and s["ticks"] % 25 == 0
    assert s["checkpoint"]["snapshots"] >= 1
    assert cli.main(flags + ["--resume", "stopped"]) == 0
    s = json.loads((outputs / "stopped" / "sim_summary.json").read_text())
    assert s["outcome"] == "success" and s["resumed_from_tick"] > 0
    assert output_files(outputs / "stopped") == output_files(
        outputs / "whole")
    trunner.clear_executor_pool()


def test_healthcheck_reports_each_check(tmp_path):
    from testground_tpu_torch.healthcheck import run_checks
    from testground_tpu_torch.healthcheck.checks import default_checks

    checks = default_checks(str(tmp_path))
    assert [c.name for c in checks] == [
        "home-directory-layout", "cuda-backend", "device-memory",
        "plans-loadable"]
    report = run_checks(checks)
    by = {c.name: c for c in report.checks}
    assert by["home-directory-layout"].status == "failed"
    assert by["plans-loadable"].status == "ok"
    assert "faultsdemo" in by["plans-loadable"].message
    import torch

    if not torch.cuda.is_available():
        assert by["cuda-backend"].status == "failed" and not report.ok
    report = run_checks(checks, fix=True)
    assert report.checks[0].status == "fixed"
    assert run_checks(checks[:1]).ok
    proc = _cli("healthcheck", home=tmp_path)
    assert "plans-loadable: ok" in proc.stdout
    assert proc.returncode == (0 if report.ok else 1)


# ------------------------------------------ the engine and the daemon

def test_local_run_journals_a_task_that_tasks_and_status_list(tmp_path,
                                                              monkeypatch,
                                                              capsys):
    """``run composition`` without ``--endpoint`` goes through the
    port's engine: its task lands in the home's task store, and
    ``tasks`` and ``status`` list it, as the JAX command's do."""
    monkeypatch.setenv("TESTGROUND_HOME", str(tmp_path))
    comp = tmp_path / "ok.toml"
    comp.write_text(
        '[global]\nplan = "placebo"\ncase = "ok"\nrunner = "sim:jax"\n'
        'builder = "sim:module"\ntotal_instances = 2\n[[groups]]\n'
        'id = "single"\ninstances = { count = 2 }\n')
    shutil.copytree(REPO / "plans" / "placebo", tmp_path / "plans/placebo")
    assert cli.main(["run", "composition", str(comp), "--device", "cpu",
                     "--run-id", "loc1"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("task queued: loc1\n")
    assert "starting run loc1: plan=placebo case=ok instances=2" in out
    assert "run loc1: outcome success" in out
    assert cli.main(["tasks"]) == 0
    assert capsys.readouterr().out.split() == [
        "loc1", "run", "complete", "success", "placebo/ok"]
    assert cli.main(["status", "--task", "loc1"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["state"] == "complete" and st["outcome"] == "success"
    assert st["result"]["outcome"] == "success" and st["result"]["journal"]
    assert cli.main(["tasks", "--failed"]) == 0
    assert capsys.readouterr().out == "no failed run tasks\n"
    assert cli.main(["status", "--task", "nope"]) == 1
    assert capsys.readouterr().err == "no such task: nope\n"
    assert cli.main(["logs", "--task", "loc1"]) == 0
    assert "run finished: outcome=success" in capsys.readouterr().out
    assert cli.main(["collect", "--task", "loc1", "--output",
                     str(tmp_path / "o.tgz")]) == 0
    assert (tmp_path / "o.tgz").stat().st_size > 0
    assert cli.main(["cache", "ls"]) == 0
    assert capsys.readouterr().out.endswith(
        "executor disk cache: disabled (TG_EXECUTOR_CACHE_DIR=off)\n")
    assert cli.main(["kill", "--task", "loc1"]) == 1


def _port_daemon(home):
    """``python -m testground_tpu_torch daemon --listen 127.0.0.1:0
    --device cpu`` as users start it; (process, endpoint)."""
    from _torch_threads import thread_cap

    env = dict(os.environ, TESTGROUND_HOME=str(home),
               OMP_NUM_THREADS=str(thread_cap()), **NO_HEARTBEAT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "testground_tpu_torch", "daemon",
         "--listen", "127.0.0.1:0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    line = proc.stdout.readline()
    assert line.startswith("daemon listening on http://127.0.0.1:"), line
    return proc, line.split()[-1]


def _mask(text, tid):
    return text.replace(tid, "<tid>")


def test_endpoint_commands_answer_as_jax_does(tmp_path, monkeypatch,
                                              capsys):
    """Every daemon-backed command of the port's command line, against a
    port daemon started as a subprocess (``daemon --device cpu``), gives
    the JAX command's output and exit code against a JAX daemon, the
    run's own log lines aside: run composition, tasks (plain, --json,
    --failed), status, logs (and --follow), collect, kill, terminate,
    prewarm, cache ls/purge, healthcheck --runner, an unknown task and an
    unreachable daemon. SIGTERM then stops the daemon, exit code 0."""
    from _runner_parity import jax_on_one_device

    from testground_tpu.cmd import root as jroot
    from testground_tpu.daemon import Daemon as JDaemon

    homes = {s: tmp_path / f"{s}-client" for s in ("jax", "port")}
    for h in homes.values():
        shutil.copytree(REPO / "plans" / "placebo", h / "plans" / "placebo")
    proc, tend = _port_daemon(tmp_path / "port-daemon")
    try:
        with jax_on_one_device():
            jd = JDaemon(home=str(tmp_path / "jax-daemon"),
                         listen="127.0.0.1:0").start_background()
            try:
                _drive_both(jroot.main, jd.endpoint, tend, homes,
                            monkeypatch, capsys, tmp_path)
            finally:
                jd.close()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out


def _drive_both(jmain, jend, tend, homes, monkeypatch, capsys, tmp):
    comp = tmp / "metrics.toml"
    comp.write_text(
        '[global]\nplan = "placebo"\ncase = "metrics"\nrunner = "sim:jax"\n'
        'builder = "sim:module"\ntotal_instances = 3\n[[groups]]\n'
        'id = "single"\ninstances = { count = 3 }\n')
    comp = str(comp)
    runs = {}

    def call(side, *argv):
        monkeypatch.setenv("TESTGROUND_HOME", str(homes[side]))
        end = jend if side == "jax" else tend
        main = jmain if side == "jax" else cli.main
        rc = main(["--endpoint", end, "--home", str(homes[side]), *argv])
        o = capsys.readouterr()
        return rc, o.out, o.err

    def both(*argv, same=True):
        r = {s: call(s, *argv) for s in ("jax", "port")}
        if same:
            assert r["port"] == r["jax"], argv
        return r

    for side in ("jax", "port"):
        rc, out, err = call(side, "run", "composition", comp)
        lines = out.splitlines()
        tid = lines[0].split()[-1]
        runs[side] = (rc, lines[0].replace(tid, "<tid>"),
                      lines[-1].replace(tid, "<tid>"), tid)
        assert any("starting run " + tid + ": plan=placebo case=metrics "
                   "instances=3 runner=sim:jax" in ln for ln in lines)
    assert runs["port"][:3] == runs["jax"][:3] == (
        0, "task queued: <tid>", "run <tid> outcome: success")
    tids = {s: runs[s][3] for s in runs}

    r = {s: call(s, "tasks") for s in tids}
    assert (_mask(r["port"][1], tids["port"])
            == _mask(r["jax"][1], tids["jax"]))
    r = {s: call(s, "tasks", "--json") for s in tids}
    rows = {s: json.loads(r[s][1]) for s in r}
    assert [d["id"] for d in rows["port"]] == [tids["port"]]
    assert set(rows["port"][0]) == set(rows["jax"][0])
    both("tasks", "--failed")
    r = {s: call(s, "status", "--task", tids[s]) for s in tids}
    st = {s: json.loads(r[s][1]) for s in r}
    assert set(st["port"]) == set(st["jax"])
    for k in ("state", "outcome", "type", "plan", "case", "attempts"):
        assert st["port"][k] == st["jax"][k], k
    for flags in ((), ("--follow",)):
        r = {s: call(s, "logs", "--task", tids[s], *flags) for s in tids}
        for s in r:
            assert r[s][0] == 0
            assert f"starting run {tids[s]}: plan=placebo" in r[s][1]
    for s in tids:
        out = tmp / f"{s}.tgz"
        assert call(s, "collect", "--task", tids[s], "--output",
                    str(out)) == (0, f"outputs collected: {out}\n", "")
    import tarfile

    names = {}
    for s in tids:
        with tarfile.open(tmp / f"{s}.tgz") as tf:
            names[s] = sorted(n.replace(tids[s], "<tid>")
                              for n in tf.getnames())
    assert names["port"] == names["jax"]
    r = {s: call(s, "kill", "--task", tids[s]) for s in tids}
    assert (r["port"][0], _mask(r["port"][2], tids["port"])) == (
        r["jax"][0], _mask(r["jax"][2], tids["jax"])) == (
        1, "task not killable (not found or complete): <tid>\n")
    # (the JAX daemon, in this process, warns on stderr for its host
    # runners' absent CLIs)
    r = both("terminate", same=False)
    assert r["port"][:2] == r["jax"][:2] == (0, "terminated 0 instances\n")
    both("terminate", "--runner", "sim:jax")
    both("status", "--task", "nope")
    both("cache", "ls")
    both("cache", "purge")
    r = both("cache", "ls", "--json", same=False)
    info = {s: json.loads(r[s][1]) for s in r}
    for k in ("dir", "enabled", "entries"):
        assert info["port"][k] == info["jax"][k], k
    # the JAX disk tier's counters are process-wide (other tests of this
    # process may have moved them); the port has no disk tier
    assert info["port"]["disk"] == dict.fromkeys(info["jax"]["disk"], 0)
    r = {s: call(s, "prewarm", comp) for s in tids}
    for s in r:
        lines = r[s][1].splitlines()
        tid = lines[0].split()[-1]
        assert (r[s][0], lines[0].replace(tid, "<t>"),
                lines[-1].replace(tid, "<t>")) == (
            0, "prewarm task queued: <t>", "prewarm <t> outcome: success")
    r = both("healthcheck", "--runner", "nosuch", same=False)
    for s in r:
        assert r[s][0] == 1
        assert r[s][2].startswith("error: unknown runner: nosuch; have ")
    r = both("healthcheck", "--runner", "sim:jax", same=False)
    for s in r:
        last = r[s][1].splitlines()[-1]
        assert last in ("healthcheck: OK", "healthcheck: FAILED")
        assert r[s][0] == (0 if last == "healthcheck: OK" else 1)
    r = {s: cli.main(["--endpoint", "http://127.0.0.1:1", "tasks"])
         if s == "port" else jmain(["--endpoint", "http://127.0.0.1:1",
                                    "tasks"])
         for s in ("jax", "port")}
    assert r["port"] == r["jax"] == 1
    errs = capsys.readouterr().err.splitlines()
    assert errs[0] == errs[1] and errs[0].startswith(
        "error: cannot reach daemon http://127.0.0.1:1: ")
