"""The rest of the port's command line (testground_tpu_torch/cli.py)
against the JAX command (testground_tpu/cmd/root.py), on the CPU: the
composition template evaluator (testground_tpu_torch/cmd/template.py)
against every case of tests/test_template.py and every
``plans/*/composition.toml``; ``version``, ``plan list|import|rm|create``,
``describe``, ``build composition|single|purge`` (``--write-artifacts``
and a template left alone), ``run single``, ``run --resume`` and the run
command's usage line, each through ``testground_tpu.cmd.root.main`` and
the port's ``cli.main`` on copies of one fresh ``TESTGROUND_HOME``: the
lines the command itself prints (task ids and homes written ``<tid>`` and
``<home>``; the engine's task log between them aside) and its exit code.
A local run's outcome line and exit code are JAX's, a preempted run's
too, and ``run --resume`` finishes that run with the files of JAX's."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import re
import shutil

import pytest
import test_template
from _runner_parity import (
    ENV,
    REPO,
    PreemptAt,
    assert_runs_equal,
    jax_on_one_device,
)
from test_template import tdir  # noqa: F401  (the cases' fixture)

from testground_tpu.cmd import root as jroot
from testground_tpu.cmd import template as jtemplate
from testground_tpu.data.result import exit_code_for_outcome as jexit
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch import cli
from testground_tpu_torch.cmd import template as ttemplate
from testground_tpu_torch.sim import runner as trunner

COMPOSITIONS = sorted(REPO.glob("plans/*/composition.toml"))
PLANS_WITH_MANIFESTS = sorted(p.parent.name
                              for p in REPO.glob("plans/*/manifest.toml"))

# ------------------------------------------------------------- templates


class _BothFuncs:
    """``default_funcs`` of both evaluators, handed back to
    ``render_template`` as a pair."""

    def __init__(self, d):
        self.j = jtemplate.default_funcs(d)
        self.t = ttemplate.default_funcs(d)


def _dual(name, calls):
    """The JAX evaluator's function ``name`` that also runs the port's on
    the same arguments and asserts the same text or the same
    TemplateError message; it returns (or raises) JAX's."""

    def side(mod, which, args, kw):
        args = [getattr(a, which) if isinstance(a, _BothFuncs) else a
                for a in args]
        try:
            return getattr(mod, name)(*args, **kw), None
        except mod.TemplateError as e:
            return None, e

    def call(*args, **kw):
        if name == "default_funcs":
            return _BothFuncs(*args, **kw)
        jv, je = side(jtemplate, "j", args, kw)
        tv, te = side(ttemplate, "t", args, kw)
        assert (tv, te and str(te)) == (jv, je and str(je)), args
        calls.append(name)
        if je is not None:
            raise je
        return jv

    return call


TEMPLATE_CASES = [
    (cls.__name__, name)
    for cls in (test_template.TestLoadResource, test_template.TestHelpers,
                test_template.TestGoZeroValues)
    for name in sorted(vars(cls)) if name.startswith("test_")]


@pytest.mark.parametrize("case", TEMPLATE_CASES,
                         ids=[f"{c}.{n}" for c, n in TEMPLATE_CASES])
def test_template_case_renders_as_jax_does(case, request, monkeypatch):
    """Each case of tests/test_template.py, its every render through
    both evaluators: the same text, or the same TemplateError message
    (the case's own assertions then hold on JAX's result)."""
    cls_name, name = case
    calls = []
    for fn in ("compile_composition_template", "render_template",
               "default_funcs"):
        monkeypatch.setattr(test_template, fn, _dual(fn, calls))
    method = getattr(getattr(test_template, cls_name)(), name)
    kw = {"tdir": request.getfixturevalue("tdir")} if (
        "tdir" in method.__code__.co_varnames) else {}
    method(**kw)
    assert calls, "the case rendered nothing"


@pytest.mark.parametrize("path", COMPOSITIONS,
                         ids=[p.parent.name for p in COMPOSITIONS])
@pytest.mark.parametrize("env", [{}, {"X": "1"}], ids=["no-env", "env"])
def test_plan_composition_renders_as_jax_does(path, env):
    text = ttemplate.compile_composition_template(path, env=env)
    assert text == jtemplate.compile_composition_template(path, env=env)
    assert text == path.read_text()  # no directives: the file as it is


def test_template_errors_match_jax(tmp_path):
    for src in ("{{ with .x }}", "{{ end }}", "{{ else }}",
                "{{ nosuch 1 }}", "{{ $v }}", "{{ .A.b.c }}x{{ (1 }}",
                '{{ with (load_resource "./nope.toml") }}{{ end }}',
                "{{ range 3 }}{{ end }}", "{{ else foo }}"):
        p = tmp_path / "c.toml"
        p.write_text(src)
        with pytest.raises(jtemplate.TemplateError) as je:
            jtemplate.compile_composition_template(p, env={})
        with pytest.raises(ttemplate.TemplateError) as te:
            ttemplate.compile_composition_template(p, env={})
        assert str(te.value) == str(je.value), src


# ----------------------------------------------------- the command lines

TID = re.compile(r"\b[0-9a-z]{16}\b")
LOG_LINE = re.compile(r"^\d\d:\d\d:\d\d ")


def _norm(text, home):
    return TID.sub("<tid>", text.replace(str(home), "<home>"))


def command_lines(text, home):
    """The lines a command prints itself (the engine's task log, whose
    lines start with a time of day, aside), normalized."""
    return [ln for ln in _norm(text, home).splitlines()
            if not LOG_LINE.match(ln)]


@pytest.fixture
def homes(tmp_path, monkeypatch):
    """Copies of one fresh TESTGROUND_HOME holding the placebo plan, one
    for each command line; ``call(side, *argv)`` runs one command in its
    home: (exit code, command lines of stdout, stderr), normalized."""
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    fresh = tmp_path / "fresh"
    shutil.copytree(REPO / "plans" / "placebo", fresh / "plans" / "placebo")
    h = {s: tmp_path / s for s in ("jax", "port")}
    for d in h.values():
        shutil.copytree(fresh, d)

    def call(side, *argv, capsys):
        monkeypatch.setenv("TESTGROUND_HOME", str(h[side]))
        main = jroot.main if side == "jax" else cli.main
        with jax_on_one_device():
            rc = main(["--home", str(h[side]), *argv])
        o = capsys.readouterr()
        return (rc, command_lines(o.out, h[side]),
                _norm(o.err, h[side]).splitlines())

    return h, call


def both(call, capsys, *argv):
    r = {s: call(s, *argv, capsys=capsys) for s in ("jax", "port")}
    assert r["port"] == r["jax"], argv
    return r["port"]


def test_version_prints_the_jax_line(capsys, monkeypatch):
    monkeypatch.setenv("TESTGROUND_GIT_COMMIT", "abc1234")
    assert cli.main(["version"]) == jroot.main(["version"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["testground-tpu 0.1.0 (commit abc1234)"] * 2
    from testground_tpu import version as jversion
    from testground_tpu_torch import version as tversion

    monkeypatch.delenv("TESTGROUND_GIT_COMMIT")
    assert tversion.git_commit() == jversion.git_commit()


def test_plan_commands_answer_as_jax_does(homes, capsys, tmp_path):
    h, call = homes
    assert both(call, capsys, "plan", "list") == (0, ["placebo"], [])
    src = str(REPO / "plans" / "example")
    assert both(call, capsys, "plan", "import", "--from", src) == (
        0, ["imported plan example -> <home>/plans/example"], [])
    assert both(call, capsys, "plan", "import", "--from", src) == (
        1, [], ["plan already exists: <home>/plans/example"])
    assert both(call, capsys, "plan", "import", "--from", src, "--name",
                "ex2")[0] == 0
    assert both(call, capsys, "plan", "create", "my-plan") == (
        0, ["created plan my-plan at <home>/plans/my-plan"], [])
    for name in ("my plan", "a/b", "x.y"):
        assert both(call, capsys, "plan", "create", name)[0] == 1
    assert both(call, capsys, "plan", "create", "my-plan")[0] == 1
    for f in ("manifest.toml", "main.py", "sim.py"):
        assert ((h["port"] / "plans/my-plan" / f).read_bytes()
                == (h["jax"] / "plans/my-plan" / f).read_bytes()), f
    assert both(call, capsys, "plan", "list") == (
        0, ["ex2", "example", "my-plan", "placebo"], [])
    assert both(call, capsys, "describe", "my-plan")[1][:3] == [
        "plan: my-plan", "builders: exec:python, sim:module",
        "runners: local:exec, sim:jax"]
    assert both(call, capsys, "plan", "rm", "ex2") == (0, [], [])
    assert both(call, capsys, "plan", "rm", "ex2") == (
        1, [], ["no such plan: ex2"])
    assert both(call, capsys, "describe", "ex2") == (
        1, [], ["no such plan: ex2"])
    # a git import of a local repository, then of a source that is not
    # a repository: that fails, and leaves no half-cloned plan behind
    import subprocess

    repo = tmp_path / "gitplan"
    shutil.copytree(REPO / "plans" / "placebo", repo)
    git = ["git", "-C", str(repo), "-c", "user.name=t", "-c",
           "user.email=t@localhost"]
    for cmd in (["init", "-q"], ["add", "."], ["commit", "-qm", "plan"]):
        subprocess.run(git + cmd, check=True, capture_output=True)
    assert both(call, capsys, "plan", "import", "--git", "--from",
                str(repo))[:2] == (
        0, ["imported plan gitplan -> <home>/plans/gitplan"])
    assert (h["port"] / "plans" / "gitplan" / "manifest.toml").exists()
    bad = str(tmp_path / "not-a-repo")
    r = both(call, capsys, "plan", "import", "--git", "--from", bad,
             "--name", "g")
    assert r[0] == 1 and r[2][0].startswith("git clone failed: ")
    assert not (h["port"] / "plans" / "g").exists()


@pytest.mark.parametrize("plan", PLANS_WITH_MANIFESTS)
def test_describe_prints_what_jax_prints(plan, homes, capsys):
    h, call = homes
    for d in h.values():
        if plan != "placebo":
            shutil.copytree(REPO / "plans" / plan, d / "plans" / plan)
    rc, lines, err = both(call, capsys, "describe", plan)
    assert rc == 0 and lines[0] == f"plan: {plan}" and not err


PLACEBO = ('[global]\nplan = "placebo"\ncase = "ok"\nrunner = "sim:jax"\n'
           'builder = "sim:module"\ntotal_instances = 2\n[[groups]]\n'
           'id = "{gid}"\ninstances = {{ count = 2 }}\n')


def test_build_commands_answer_as_jax_does(homes, capsys, monkeypatch):
    """build composition (plain, --write-artifacts, a template left
    alone, a template error), build single, build purge: the command
    lines, the artifacts' paths and the written-back file."""
    h, call = homes
    for s, d in h.items():
        (d / "c.toml").write_text(PLACEBO.format(gid="g"))
        (d / "t.toml").write_text(PLACEBO.format(gid="{{ .Env.GID }}"))
        (d / "bad.toml").write_text("{{ with .x }}")
    art = "<home>/data/work/"
    rc, lines, err = both(call, capsys, "build", "composition",
                          str(h["jax"] / "c.toml"))
    assert rc == 0 and not err
    assert lines[0] == "build task queued: <tid>"
    assert lines[1] == "build <tid> outcome: success"
    assert lines[2].startswith(f"  group g: {art}")
    r = {s: call(s, "build", "composition", str(h[s] / "c.toml"), "-w",
                 capsys=capsys) for s in h}
    assert r["port"] == r["jax"] and r["port"][1][-1] == (
        "artifacts written back to <home>/c.toml")
    assert (_norm((h["port"] / "c.toml").read_text(), h["port"])
            == _norm((h["jax"] / "c.toml").read_text(), h["jax"]))
    assert f'artifact = "{art}' in _norm(
        (h["port"] / "c.toml").read_text(), h["port"])
    # a template's artifacts are printed, not written back
    monkeypatch.setenv("GID", "tg")
    r = {s: call(s, "build", "composition", str(h[s] / "t.toml"),
                 "--write-artifacts", capsys=capsys) for s in h}
    assert r["port"] == r["jax"]
    assert r["port"][1][2].startswith(f"  group tg: {art}")
    assert r["port"][2] == ["composition is a template; not writing "
                            "artifacts back (artifacts printed above)"]
    assert "{{ .Env.GID }}" in (h["port"] / "t.toml").read_text()
    r = {s: call(s, "build", "composition", str(h[s] / "bad.toml"),
                 capsys=capsys) for s in h}
    assert r["port"] == r["jax"] == (1, [], [
        "failed to process composition template: unclosed {{with}} "
        "block"])
    rc, lines, _ = both(call, capsys, "build", "single", "--plan",
                        "placebo", "--builder", "sim:module")
    assert rc == 0 and lines[2].startswith(f"  group single: {art}")
    # one staged directory: every build above shares its digest
    assert both(call, capsys, "build", "purge", "--plan", "placebo") == (
        0, ["purged 1 cached artifact(s) for plan placebo"], [])
    assert both(call, capsys, "build", "purge", "--plan", "placebo") == (
        0, ["purged 0 cached artifact(s) for plan placebo"], [])


def test_host_builders_and_runners_are_refused(homes, capsys):
    """The port carries no host builder or runner: ``build single``'s
    default builder fails the build, ``run single``'s defaults are
    refused by the engine, and ``--mesh`` is multi-GPU work."""
    h, call = homes
    rc, lines, _ = call("port", "build", "single", "--plan", "placebo",
                        capsys=capsys)
    assert rc == 1 and lines[-1] == "build <tid> outcome: failure"
    assert "unknown builder: exec:python" in (
        h["port"] / "data" / "daemon").joinpath(
            next(p.name for p in (h["port"] / "data" / "daemon").glob(
                "*.out"))).read_text()
    assert call("port", "run", "single", "--plan", "placebo", "--testcase",
                "ok", "--device", "cpu", capsys=capsys) == (
        1, [], ["error: unknown runner: local:exec"])
    rc, _, err = call("port", "run", "single", "--plan", "placebo",
                      "--testcase", "ok", "--device", "cpu", "--runner",
                      "sim:jax", "--mesh", "2x1", capsys=capsys)
    assert rc == 1 and err == [
        "error: --mesh (a sweep's 2-D device mesh) is not ported to "
        "testground_tpu_torch yet (ROADMAP.md, modules still to port, "
        "item 12: multi-GPU)"]


def test_run_usage_and_resume_errors_match_jax(homes, capsys):
    h, call = homes
    assert both(call, capsys, "run") == (2, [], [
        "usage: testground run single|composition ...  or  "
        "testground run --resume <task_id>"])
    assert both(call, capsys, "run", "--resume", "nope")[:2] == (1, [])
    r = {s: call(s, "run", "--resume", "nope", capsys=capsys)
         for s in h}
    assert r["port"] == r["jax"] == (1, [], ["error: no such task: nope"])


@pytest.mark.parametrize("outcome", [
    "success", "failure", "canceled", "preempted", "terminated", "unknown"])
def test_exit_code_for_each_outcome_is_jax_s(outcome):
    assert cli.exit_code_for_outcome(outcome) == jexit(outcome)


def test_resume_waits_for_a_task_auto_resume_took(homes, capsys,
                                                  monkeypatch):
    """``run --resume`` of a task the engine's boot-time auto-resume is
    already running: the JAX command's "already resuming" line, then it
    waits for the task's outcome."""
    from testground_tpu.engine import Engine as JEngine
    from testground_tpu.engine import EngineError as JEngineError
    from testground_tpu.task import Task as JTask
    from testground_tpu_torch.engine import Engine as TEngine
    from testground_tpu_torch.task import Task as TTask

    h, call = homes

    def busy(err, task):
        def resume_task(self, tid):
            raise err(f"task {tid} is still processing — kill it first, "
                      "or wait for it to finish")

        def wait(self, tid, timeout=300.0):
            t = task(id=tid, type="run", plan="placebo", case="ok")
            t.transition("complete")
            t.result = {"outcome": "success"}
            return t

        return resume_task, wait

    for eng, err, task in ((JEngine, JEngineError, JTask),
                           (TEngine, cli.EngineError, TTask)):
        resume_task, wait = busy(err, task)
        monkeypatch.setattr(eng, "resume_task", resume_task)
        monkeypatch.setattr(eng, "wait", wait)
    r = {s: call(s, "run", "--resume", "t1", *(
        ("--device", "cpu") if s == "port" else ()), capsys=capsys)
        for s in h}
    assert r["port"] == r["jax"] == (0, [
        "task t1 already resuming (auto-resume) — waiting",
        "run t1 outcome: success"], [])


SINGLE = ["run", "single", "--plan", "placebo", "--testcase", "ok",
          "--instances", "3", "--runner", "sim:jax", "--builder",
          "sim:module"]


def test_run_single_writes_what_the_jax_command_writes(homes, capsys):
    """``run single`` of placebo's ok case at 3 instances: the JAX
    command's lines (task queued, the outcome line) and exit code, and
    the files of its run."""
    h, call = homes
    r = {s: call(s, *SINGLE, *(("--device", "cpu") if s == "port"
                               else ()), capsys=capsys) for s in h}
    assert r["port"] == r["jax"] == (0, [
        "task queued: <tid>", "run <tid> outcome: success"], [])
    dirs = {s: next((h[s] / "data" / "outputs" / "placebo").iterdir())
            for s in h}
    s = assert_runs_equal(dirs["jax"], dirs["port"])
    assert s["outcomes"] == {"single": {"ok": 3, "total": 3}}
    trunner.clear_executor_pool()
    jrunner._EX_CACHE.clear()


def test_preempted_run_and_run_resume_answer_as_jax_does(homes, capsys):
    """A local ``run composition`` preempted at its third chunk
    boundary prints the JAX command's outcome line and exits with its
    code (3: preempted is neither success, failure nor canceled); ``run
    --resume TASK_ID`` then finishes it, exit 0, with the files of JAX's
    resumed run."""
    h, call = homes
    comp = str(REPO / "plans" / "faultsdemo" / "composition.toml")
    for d in h.values():
        shutil.copytree(REPO / "plans" / "faultsdemo",
                        d / "plans" / "faultsdemo")
    flags = ["--run-cfg", "chunk_ticks=25", "--checkpoint-interval", "0"]
    r, tids = {}, {}
    for s, runner in (("jax", jrunner), ("port", trunner)):
        with PreemptAt(runner, 3):
            r[s] = call(s, "run", "composition", comp, *flags, *(
                ("--device", "cpu") if s == "port" else ()), capsys=capsys)
        tids[s] = next((h[s] / "data" / "outputs" / "faultsdemo").iterdir())
    assert r["port"] == r["jax"] == (3, [
        "task queued: <tid>", "run <tid> outcome: preempted"], [])
    for s in h:
        r[s] = call(s, "run", "--resume", tids[s].name, *(
            ("--device", "cpu") if s == "port" else ()), capsys=capsys)
    assert r["port"] == r["jax"] == (0, [
        "task requeued for resume: <tid>", "run <tid> outcome: success"], [])
    st = assert_runs_equal(tids["jax"], tids["port"])
    assert st["outcome"] == "success" and st["resumed_from_tick"] == 75
    trunner.clear_executor_pool()
    jrunner._EX_CACHE.clear()


def test_run_composition_renders_its_template(homes, capsys, monkeypatch):
    """``run composition`` renders the file as a template before it
    parses it (an ``{{ .Env.X }}`` group id here), and a template that
    fails gets the JAX command's error, exit 1."""
    h, call = homes
    path = h["port"] / "t.toml"
    path.write_text(PLACEBO.format(gid="{{ .Env.GID }}"))
    monkeypatch.setenv("GID", "tg")
    rc, lines, err = call("port", "run", "composition", str(path),
                          "--device", "cpu", capsys=capsys)
    assert (rc, lines, err) == (0, [
        "task queued: <tid>", "run <tid> outcome: success"], [])
    run_dir = next((h["port"] / "data" / "outputs" / "placebo").iterdir())
    from testground_tpu_torch.runner.outputs import summary

    assert summary(run_dir)["outcomes"] == {"tg": {"ok": 2, "total": 2}}
    for d in h.values():
        (d / "bad.toml").write_text("{{ if }}")
    r = {s: call(s, "run", "composition", str(h[s] / "bad.toml"),
                 capsys=capsys) for s in h}
    assert r["port"] == r["jax"] and r["port"][0] == 1
    assert r["port"][2][0].startswith(
        "failed to process composition template: ")
    trunner.clear_executor_pool()
