"""The port's command line (``python -m testground_tpu_torch``), the
counterpart of the JAX package's ``testground`` command
(``testground_tpu/cmd/root.py``); each command prints the JAX command's
lines and exits with its code:

    version                        the version and its commit
    plan list|import|rm|create     the plans under $TESTGROUND_HOME/plans
    describe PLAN                  a plan's builders, runners and cases
    run composition FILE [flags]   queue a composition and wait for it (a
                                   [sweep] runs as one batched program,
                                   an enabled [search] as a
                                   breaking-point search)
    run single --plan P --testcase C [--instances N] [flags]
                                   the same for a one-group composition
    run --resume TASK_ID           continue an interrupted run from its
                                   last checkpoint
    build composition FILE | single --plan P | purge --plan P
                                   stage a plan's artifacts, or purge them
    prewarm FILE                   build and capture its executor into the
                                   runner's pool, without running it
    daemon [--listen] [--device] [--peer HOST:PORT ...] [--advertise]
                                   serve the engine over HTTP (with
                                   peers: as their fleet's coordinator)
    fleet ls [--json]              a daemon's fleet: role, workers,
                                   routes (needs --endpoint)
    tasks | status | logs | kill | collect | terminate | cache ls|purge
                                   the task store, logs, outputs and the
                                   executor cache
    healthcheck [--runner] [--fix] the port's health checks

Without ``--endpoint`` a command runs against an in-process engine over
the task store in ``$TESTGROUND_HOME/data/daemon`` (engine/): ``run``
queues its task there, a scheduler worker runs it, and ``tasks`` and
``status`` list it afterwards. With ``--endpoint URL`` (before or after
the command's name) it goes to a daemon through the client; the plan's
directory travels with the run. Runs go to the card unless ``--device
cpu`` is given (to ``run`` and ``prewarm`` locally, to ``daemon`` for the
daemon's runs).

A composition file is a template (cmd/template.py), rendered before it
is parsed, as the JAX command renders it. A composition's flags under the
JAX command's names shape it, and it is prepared against its plan's
manifest as the JAX engine prepares it; its outputs go to
``$TESTGROUND_HOME/data/outputs/<plan>/<task id>``. The plan's directory
(its manifest and data files) is the composition file's own directory
when that holds the plan's manifest, else ``$TESTGROUND_HOME/plans/<plan>``,
else the repository's ``plans/<plan>``; without one, the engine looks
under its home and the run fails there, as JAX's does. SIGTERM preempts a local run at
its next chunk boundary (``run --resume TASK_ID`` continues it). A run's
exit code is the JAX command's for its outcome: 0 success, 1 failure, 2
canceled, 3 any other (a preempted or terminated run).

The port has one builder, ``sim:module``, and one runner, the sim
runner under the name ``sim:jax``: the host runners and builders
(``local:exec``, ``exec:python``, ...) are not ported, so ``run single``
and ``build single`` with their default ``--runner``/``--builder`` get
the engine's "unknown runner"/"unknown builder" error. A plan runs only
when the port carries its program (``testground_tpu_torch.plans``).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time
import uuid
from pathlib import Path

from .api.composition import SIM_RUNNER, Checkpoint, Composition, Live
from .api.contracts import RunGroup, RunInput
from .api.manifest import TestPlanManifest
from .config.coalescing import CoalescedConfig
from .engine import EngineError
from .healthcheck.checks import home_dir
from .rpc import RPCError
from .runner import get_runner
from .sim.program import _not_ported
from .sim.tables import (
    CompositionError,
    Replay,
    Sweep,
    Telemetry,
    Trace,
)

REPO_PLANS = Path(__file__).resolve().parent.parent / "plans"


def _typed(v: str):
    """A ``--run-cfg`` value as its JSON type when it parses as JSON."""
    try:
        return json.loads(v)
    except (json.JSONDecodeError, TypeError):
        return v


def _key_values(pairs) -> dict:
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise ValueError(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def apply_overrides(comp: Composition, args) -> None:
    """The run flags, as the JAX command applies them: ``--test-param``
    on every group, ``--run-cfg`` typed into the run config, ``--runner``
    replacing the runner, ``--sweep-seeds`` setting (or creating) the
    [sweep] table's seeds, ``--no-*`` marking a table disabled (created
    for [live] and [checkpoint], which are on by default), the interval
    flags setting (or creating) their table, ``--trace`` enabling one,
    ``--search`` / ``--no-search`` and ``--search-budget`` acting on the
    composition's [search] table, ``--replay FILE`` pointing (or
    creating) the [replay] table, ``--replay-scale`` setting its scale,
    and ``--drain`` / ``--no-drain`` setting the [trace] and [telemetry]
    tables' drain (each an error without its table). ``--mesh`` is not
    ported (a 2-D device mesh is multi-GPU work)."""
    for k, v in _key_values(getattr(args, "test_param", None)).items():
        for g in comp.groups:
            g.run.test_params[k] = v
    comp.global_.run_config.update(
        {k: _typed(v)
         for k, v in _key_values(getattr(args, "run_cfg", None)).items()})
    if getattr(args, "runner_override", None):
        comp.global_.runner = args.runner_override
    if getattr(args, "sweep_seeds", None) is not None:
        # `is not None`: --sweep-seeds 0 reaches Sweep.validate's error
        if comp.sweep is None:
            comp.sweep = Sweep()
        comp.sweep.seeds = args.sweep_seeds
    if getattr(args, "mesh_shape", None) is not None:
        raise _not_ported("--mesh (a sweep's 2-D device mesh)", 12,
                          "multi-GPU")
    if getattr(args, "no_faults", False) and comp.faults is not None:
        comp.faults.disabled = True
    if getattr(args, "trace_on", False):
        if comp.trace is None:
            comp.trace = Trace(enabled=True)
        comp.trace.enabled = True
    if getattr(args, "no_trace", False) and comp.trace is not None:
        comp.trace.enabled = False
    if getattr(args, "telemetry_interval", None) is not None:
        if comp.telemetry is None:
            comp.telemetry = Telemetry(interval=args.telemetry_interval)
        comp.telemetry.interval = args.telemetry_interval
        comp.telemetry.enabled = True
    if getattr(args, "no_telemetry", False) and comp.telemetry is not None:
        comp.telemetry.enabled = False
    if getattr(args, "search_on", None) is not None:
        # no default [search] table: its param and grid cannot be guessed
        if comp.search is None and args.search_on:
            raise CompositionError(
                "--search requires a [search] table in the composition "
                "(the target param and candidate grid cannot be "
                "defaulted); see docs/search.md")
        if comp.search is not None:
            comp.search.enabled = bool(args.search_on)
    if getattr(args, "search_budget", None) is not None:
        if comp.search is None:
            raise CompositionError(
                "--search-budget requires a [search] table in the "
                "composition; see docs/search.md")
        # `is not None`: --search-budget 0 reaches Search.validate
        comp.search.budget = args.search_budget
    if getattr(args, "live_interval", None) is not None:
        if comp.live is None:
            comp.live = Live(interval=args.live_interval)
        comp.live.interval = args.live_interval
        comp.live.enabled = True
    if getattr(args, "no_live", False):
        comp.live = comp.live or Live()
        comp.live.enabled = False
    if getattr(args, "checkpoint_interval", None) is not None:
        if comp.checkpoint is None:
            comp.checkpoint = Checkpoint(interval=args.checkpoint_interval)
        comp.checkpoint.interval = args.checkpoint_interval
        comp.checkpoint.enabled = True
    if getattr(args, "no_checkpoint", False):
        comp.checkpoint = comp.checkpoint or Checkpoint()
        comp.checkpoint.enabled = False
    if getattr(args, "replay_file", None):
        if comp.replay is None:
            comp.replay = Replay(trace=args.replay_file)
        comp.replay.trace = args.replay_file
        comp.replay.enabled = True
    if getattr(args, "replay_scale", None) is not None:
        # `is not None`: --replay-scale 0 reaches Replay.validate's error
        if comp.replay is None:
            raise CompositionError(
                "--replay-scale requires a [replay] table in the "
                "composition (or --replay FILE to create one); see "
                "docs/replay.md")
        comp.replay.scale = args.replay_scale
    if getattr(args, "no_replay", False) and comp.replay is not None:
        comp.replay.enabled = False
    if getattr(args, "drain_on", False):
        if comp.trace is None and comp.telemetry is None:
            raise CompositionError(
                "--drain requires a [trace] or [telemetry] table in the "
                "composition (there is no observer plane to drain); add "
                "one, or combine with --trace / --telemetry-interval")
        for t in (comp.trace, comp.telemetry):
            if t is not None:
                t.drain = True
    if getattr(args, "no_drain", False):
        for t in (comp.trace, comp.telemetry):
            if t is not None:
                t.drain = False


def plan_dir_for(comp: Composition, comp_path, home) -> Path:
    """Where the plan's manifest and data files are (module docstring;
    ``comp_path`` None for a composition made from flags)."""
    plan = comp.global_.plan
    if comp_path is not None:
        beside = Path(comp_path).resolve().parent
        man = beside / "manifest.toml"
        if man.exists() and TestPlanManifest.load(man).name == plan:
            return beside
    for cand in (Path(home) / "plans" / plan, REPO_PLANS / plan):
        if (cand / "manifest.toml").exists():
            return cand
    raise FileNotFoundError(
        f"plan {plan!r}: no manifest.toml beside {comp_path}, under "
        f"{Path(home) / 'plans'} or in {REPO_PLANS}")


def prepare_run(comp: Composition, plan_dir, run_id: str, home,
                resume: bool = False) -> RunInput:
    """The RunInput of a composition, field for field what the JAX
    engine builds for it (``Composition.prepare_for_run`` against the
    plan's manifest), each group's artifact being the plan's
    directory."""
    plan_dir = Path(plan_dir)
    manifest = TestPlanManifest.load(plan_dir / "manifest.toml")
    for g in comp.groups:
        if not g.run.artifact:
            g.run.artifact = str(plan_dir)
    prepared = comp.prepare_for_run(manifest)
    run_dir = Path(home) / "data" / "outputs" / prepared.global_.plan / run_id
    return RunInput(
        run_id=run_id,
        env_config=None,
        run_dir=str(run_dir),
        test_plan=prepared.global_.plan,
        test_case=prepared.global_.case,
        total_instances=prepared.global_.total_instances,
        groups=[RunGroup(id=g.id, instances=g.calculated_instance_count,
                         artifact_path=g.run.artifact,
                         parameters=dict(g.run.test_params),
                         resources=g.resources,
                         profiles=dict(g.run.profiles))
                for g in prepared.groups],
        composition=prepared,
        manifest=manifest,
        plan_dir=str(plan_dir),
        disable_metrics=prepared.global_.disable_metrics,
        run_config=CoalescedConfig().append(
            prepared.global_.run_config).coalesce(),
        sweep=prepared.sweep,
        faults=prepared.faults,
        trace=prepared.trace,
        telemetry=prepared.telemetry,
        search=prepared.search,
        live=prepared.live,
        checkpoint=prepared.checkpoint,
        replay=prepared.replay,
        resume=resume,
    )


def new_run_id() -> str:
    return time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:8]


# ------------------------------------------------------- engine and client

# the JAX command's exit code for each outcome (testground_tpu/data/
# result.py ``exit_code_for_outcome``)
_EXIT_CODES = {"success": 0, "failure": 1, "canceled": 2}


def exit_code_for_outcome(outcome: str) -> int:
    return _EXIT_CODES.get(outcome, 3)


def _remote(args) -> bool:
    return getattr(args, "endpoint", None) is not None


def _env(args):
    from .config import EnvConfig

    return EnvConfig.load(getattr(args, "home", None))


def _engine(args, device="cuda"):
    """An in-process engine over ``$TESTGROUND_HOME``'s task store."""
    from .engine import Engine

    return Engine(env_config=_env(args), device=device)


def _client(args, timeout: float = 600.0):
    """The daemon's client; the bearer token is env.toml's [client]
    token."""
    from .client import Client

    return Client(args.endpoint, token=_env(args).client.token,
                  timeout=timeout)


def _plan_dir(args, comp: Composition):
    """The plan's directory, or None when none is found (the engine, or
    a daemon, then resolves the plan under its own home, as JAX's does,
    and answers for it)."""
    try:
        return plan_dir_for(comp, getattr(args, "composition", None),
                            home_dir())
    except FileNotFoundError:
        return None


# ------------------------------------------------- version, plan, describe

def cmd_version(args) -> int:
    from . import version

    print(version.human())
    return 0


def cmd_plan_list(args) -> int:
    for p in sorted(m.parent.name
                    for m in _env(args).dirs.plans.glob("*/manifest.toml")):
        print(p)
    return 0


def cmd_plan_import(args) -> int:
    """Copy (or git-clone with ``--git``) a plan into
    ``$TESTGROUND_HOME/plans``."""
    import shutil

    cfg = _env(args)
    cfg.dirs.ensure()
    if args.git:
        import subprocess

        name = args.name or Path(args.source).stem.removesuffix(".git")
        dst = cfg.dirs.plans / name
        if dst.exists():
            print(f"plan already exists: {dst}", file=sys.stderr)
            return 1
        try:
            cp = subprocess.run(
                ["git", "clone", "--depth", "1", args.source, str(dst)],
                capture_output=True, text=True, timeout=300)
            err = cp.stderr.strip() if cp.returncode != 0 else ""
        except (subprocess.TimeoutExpired, OSError) as e:
            err = str(e)
        if err:
            shutil.rmtree(dst, ignore_errors=True)  # no half-clone left
            print(f"git clone failed: {err}", file=sys.stderr)
            return 1
        print(f"imported plan {name} -> {dst}")
        return 0
    src = Path(args.source).resolve()
    name = args.name or src.name
    dst = cfg.dirs.plans / name
    if dst.exists():
        print(f"plan already exists: {dst}", file=sys.stderr)
        return 1
    shutil.copytree(src, dst)
    print(f"imported plan {name} -> {dst}")
    return 0


def cmd_plan_rm(args) -> int:
    import shutil

    dst = _env(args).dirs.plans / args.name
    if not dst.exists():
        print(f"no such plan: {args.name}", file=sys.stderr)
        return 1
    shutil.rmtree(dst)
    return 0


# `plan create`'s scaffold, byte for byte the JAX command's: its sim.py
# is written against the JAX package's builder API, which the port does
# not load (it runs only the plans it carries)
_SCAFFOLD_MANIFEST = (
    'name = "{name}"\n\n'
    "[defaults]\n"
    'builder = "exec:python"\n'
    'runner = "local:exec"\n\n'
    "[builders]\n"
    '"exec:python" = {{ enabled = true }}\n'
    '"sim:module" = {{ enabled = true }}\n\n'
    "[runners]\n"
    '"local:exec" = {{ enabled = true }}\n'
    '"sim:jax" = {{ enabled = true }}\n\n'
    "[[testcases]]\n"
    'name = "quickstart"\n'
    "instances = {{ min = 1, max = 100, default = 2 }}\n"
)
_SCAFFOLD_MAIN = (
    '"""Host-substrate entrypoint (local:exec)."""\n'
    "from testground_tpu.sdk import invoke_map\n\n\n"
    "def quickstart(runenv):\n"
    '    seq = runenv.sync_client.signal_and_wait(\n'
    '        "done", runenv.test_instance_count)\n'
    '    runenv.record_message(f"hello, I am instance {seq}")\n'
    "    return None\n\n\n"
    'if __name__ == "__main__":\n'
    '    invoke_map({"quickstart": quickstart})\n'
)
_SCAFFOLD_SIM = (
    '"""sim:jax traceable entrypoint: one SPMD program per composition."""'
    "\n\n\n"
    "def quickstart(b):\n"
    '    b.signal_and_wait("done")\n'
    "    b.end_ok()\n\n\n"
    'testcases = {"quickstart": quickstart}\n'
)


def cmd_plan_create(args) -> int:
    import re

    if not re.fullmatch(r"[A-Za-z0-9_-]+", args.name):
        print(f"invalid plan name {args.name!r}: use letters, digits, "
              "'-', '_'", file=sys.stderr)
        return 1
    cfg = _env(args)
    cfg.dirs.ensure()
    dst = cfg.dirs.plans / args.name
    if dst.exists():
        print(f"plan already exists: {dst}", file=sys.stderr)
        return 1
    dst.mkdir(parents=True)
    (dst / "manifest.toml").write_text(
        _SCAFFOLD_MANIFEST.format(name=args.name))
    (dst / "main.py").write_text(_SCAFFOLD_MAIN)
    (dst / "sim.py").write_text(_SCAFFOLD_SIM)
    print(f"created plan {args.name} at {dst}")
    return 0


def cmd_describe(args) -> int:
    mpath = _env(args).dirs.plans / args.plan / "manifest.toml"
    if not mpath.exists():
        print(f"no such plan: {args.plan}", file=sys.stderr)
        return 1
    m = TestPlanManifest.load(mpath)
    print(f"plan: {m.name}")
    print(f"builders: {', '.join(m.supported_builders())}")
    print(f"runners: {', '.join(m.supported_runners())}")
    for tc in m.test_cases:
        print(f"  case {tc.name}: instances "
              f"[{tc.instances.minimum}, {tc.instances.maximum}] "
              f"default {tc.default_instances}")
        for name, p in tc.parameters.items():
            print(f"    param {name} ({p.type}): {p.description} "
                  f"[default: {p.default!r}]")
    return 0


# ------------------------------------------------- compositions and plans

def load_composition(path):
    """(composition, rendered text) of a composition template, or None
    after printing the JAX command's error for a template that fails."""
    from .cmd.template import TemplateError, compile_composition_template

    try:
        text = compile_composition_template(path)
    except TemplateError as e:
        print(f"failed to process composition template: {e}",
              file=sys.stderr)
        return None
    return Composition.from_toml(text), text


def single_composition(args) -> Composition:
    """The one-group composition of ``run single`` and ``build single``
    (group id ``single``), as the JAX command builds it."""
    from .api.composition import Global, Group, Instances

    n = getattr(args, "instances", 1)
    return Composition(
        global_=Global(plan=args.plan, case=args.testcase or "quickstart",
                       builder=args.builder,
                       runner=getattr(args, "runner", ""),
                       total_instances=n),
        groups=[Group(id="single", instances=Instances(count=n))])


# ----------------------------------------------------------------- build

def _write_artifacts(args, comp, artifacts: dict) -> None:
    """Write built artifacts back into the composition file; a templated
    composition is left alone (its directives would be frozen at their
    build-time values)."""
    if Path(args.composition).read_text() != args.rendered_text:
        print("composition is a template; not writing artifacts back "
              "(artifacts printed above)", file=sys.stderr)
        return
    for g in comp.groups:
        if g.id in artifacts:
            g.run.artifact = artifacts[g.id]
    comp.save(args.composition)
    print(f"artifacts written back to {args.composition}")


def cmd_build_composition(args) -> int:
    loaded = load_composition(args.composition)
    if loaded is None:
        return 1
    comp, args.rendered_text = loaded
    return _build_common(args, comp)


def cmd_build_single(args) -> int:
    args.write_artifacts = False
    return _build_common(args, single_composition(args))


def _build_finish(args, comp, tid, outcome, arts) -> int:
    print(f"build {tid} outcome: {outcome}")
    if outcome != "success":
        return 1
    for gid, path in arts.items():
        print(f"  group {gid}: {path}")
    if args.write_artifacts and arts:
        _write_artifacts(args, comp, arts)
    return 0


def _build_common(args, comp) -> int:
    plan_dir = _plan_dir(args, comp)
    src = str(plan_dir) if plan_dir else None
    if _remote(args):
        cli = _client(args, timeout=args.timeout)
        tid = cli.build(comp, plan_dir=src)
        print(f"build task queued: {tid}")
        outcome = cli.wait(tid, on_line=print)
        arts = (cli.status(tid).get("result") or {}).get("artifacts", {})
        return _build_finish(args, comp, tid, outcome, arts)
    eng = _engine(args)
    try:
        tid = eng.queue_build(comp, sources_dir=src)
        print(f"build task queued: {tid}")
        t = eng.wait(tid, timeout=args.timeout)
        print(eng.logs(tid), end="")
        arts = (t.result or {}).get("artifacts", {})
        return _build_finish(args, comp, tid, t.outcome, arts)
    finally:
        eng.close()


def cmd_build_purge(args) -> int:
    if _remote(args):
        n = _client(args).build_purge(args.plan)
    else:
        eng = _engine(args)
        try:
            n = eng.build_purge(args.plan)
        finally:
            eng.close()
    print(f"purged {n} cached artifact(s) for plan {args.plan}")
    return 0


# ----------------------------------------------------------------- run

def cmd_run_composition(args) -> int:
    loaded = load_composition(args.composition)
    if loaded is None:
        return 1
    comp = loaded[0]
    apply_overrides(comp, args)
    return _run_common(args, comp)


def cmd_run_single(args) -> int:
    comp = single_composition(args)
    apply_overrides(comp, args)
    return _run_common(args, comp)


def _run_common(args, comp) -> int:
    """Queue the run (or, with ``--resume``, requeue it) on the daemon or
    an in-process engine, wait for it, and print the JAX command's
    lines: ``task queued``, the task's log, ``run TID outcome: O``."""
    plan_dir = _plan_dir(args, comp)
    if _remote(args):
        return _run_remote(args, comp, plan_dir)
    from .device import resolve_device
    from .sim.runner import load_plan_module

    resolve_device(args.device)
    if plan_dir is not None:
        load_plan_module(
            TestPlanManifest.load(plan_dir / "manifest.toml").name)
    eng = _engine(args, device=args.device)
    prev = signal.getsignal(signal.SIGTERM)
    eng.install_preemption_handler()
    try:
        if getattr(args, "resume", None):
            tid = _resume(eng, comp, args.resume, plan_dir)
        else:
            tid = eng.queue_run(
                comp, sources_dir=str(plan_dir) if plan_dir else None,
                task_id=args.run_id)
        print(f"task queued: {tid}", flush=True)
        if not args.wait:
            return 0
        t = eng.wait(tid, timeout=args.timeout)
    finally:
        signal.signal(signal.SIGTERM, prev)
        # the worker has stored the task when wait returns
        eng.close()
    print(eng.logs(tid), end="")
    print(f"run {tid} outcome: {t.outcome}")
    if args.collect and t.result:
        _collect_local(eng.env.dirs.outputs / comp.global_.plan
                       / t.result.get("run_id", tid),
                       Path(args.collect_file or f"{tid}.tgz"))
    return exit_code_for_outcome(t.outcome)


def _resume(eng, comp, tid: str, plan_dir) -> str:
    """Requeue task ``tid`` to continue from its last checkpoint; a run
    the task store does not hold (its outputs from elsewhere) is queued
    under its id with a resume request."""
    if eng.get_task(tid) is None:
        return eng.queue_run(
            comp, sources_dir=str(plan_dir) if plan_dir else None,
            task_id=tid, resume=True)
    try:
        return eng.resume_task(tid)
    except EngineError as e:
        if "still processing" not in str(e):
            raise
        return tid


def _run_remote(args, comp, plan_dir) -> int:
    """Daemon-backed run: the plan's directory uploaded when found, the
    task queued, its log followed, its outputs collected on request
    (``testground_tpu/cmd/root.py`` ``_run_remote``)."""
    cli = _client(args, timeout=args.timeout)
    if getattr(args, "resume", None):
        cli.resume(args.resume)
        tid = args.resume
        print(f"task requeued for resume: {tid}")
    else:
        tid = cli.run(comp, plan_dir=str(plan_dir) if plan_dir else None)
        print(f"task queued: {tid}")
    if not args.wait:
        return 0
    try:
        outcome = cli.wait(tid, on_line=print)
    except (TimeoutError, OSError) as e:
        print(f"timed out waiting for task {tid}: {e}", file=sys.stderr)
        return 1
    print(f"run {tid} outcome: {outcome}")
    if args.collect:
        out = Path(args.collect_file or f"{tid}.tgz")
        with open(out, "wb") as f:
            cli.collect_outputs(tid, f)
        print(f"outputs collected: {out}")
    return exit_code_for_outcome(outcome)


def cmd_run_resume(args) -> int:
    """``run --resume TASK_ID`` (no subcommand): requeue an interrupted
    run task to continue from its last checkpoint, and wait for it.
    Without ``--resume`` it prints the usage line, exit 2."""
    tid = args.resume_task
    if not tid:
        print("usage: testground run single|composition ...  or  "
              "testground run --resume <task_id>", file=sys.stderr)
        return 2
    if _remote(args):
        cli = _client(args, timeout=args.timeout)
        cli.resume(tid)
        print(f"task requeued for resume: {tid}")
        if not args.wait:
            return 0
        outcome = cli.wait(tid, on_line=print)
        print(f"run {tid} outcome: {outcome}")
        return exit_code_for_outcome(outcome)
    from .device import resolve_device

    eng = _engine(args, device=args.device)
    try:
        if eng.get_task(tid) is not None:
            # the run's device, checked before the task is requeued
            resolve_device(args.device)
        try:
            eng.resume_task(tid)
            print(f"task requeued for resume: {tid}")
        except EngineError as e:
            if "still processing" not in str(e):
                print(f"error: {e}", file=sys.stderr)
                return 1
            # the engine's boot-time auto-resume already picked the
            # interrupted task up: nothing to requeue, just wait
            print(f"task {tid} already resuming (auto-resume) — waiting")
        # the in-process engine dies with this command: always wait
        t = eng.wait(tid, timeout=args.timeout)
        print(f"run {tid} outcome: {t.outcome}")
        return exit_code_for_outcome(t.outcome)
    finally:
        eng.close()


def _collect_local(run_dir, out: Path) -> None:
    from .runner.outputs import tar_outputs

    with open(out, "wb") as f:
        tar_outputs(str(run_dir), f)
    print(f"outputs collected: {out}")


def cmd_prewarm(args) -> int:
    """Build and capture the composition's executor into the runner's
    pool without running it (the JAX command's ``prewarm``); the next
    run of the same program on that engine captures nothing."""
    loaded = load_composition(args.composition)
    if loaded is None:
        return 1
    comp = loaded[0]
    plan_dir = _plan_dir(args, comp)
    if _remote(args):
        cli = _client(args, timeout=args.timeout)
        tid = cli.prewarm(comp, plan_dir=str(plan_dir) if plan_dir else None)
        print(f"prewarm task queued: {tid}")
        if not args.wait:
            return 0
        outcome = cli.wait(tid, on_line=print)
        print(f"prewarm {tid} outcome: {outcome}")
        return 0 if outcome == "success" else 1
    eng = _engine(args, device=args.device)
    try:
        try:
            tid = eng.queue_prewarm(
                comp, sources_dir=str(plan_dir) if plan_dir else None)
        except EngineError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"prewarm task queued: {tid}")
        t = eng.wait(tid, timeout=args.timeout)
        print(eng.logs(tid), end="")
        print(f"prewarm {tid} outcome: {t.outcome}")
        return 0 if t.outcome == "success" else 1
    finally:
        eng.close()


# ------------------------------------------------------------ the tasks

def _task_row(d: dict) -> str:
    """One ``tasks`` line (the JAX command's ``_task_row``)."""
    extra = ""
    if d.get("attempts"):
        extra += f"  attempts={d['attempts']}"
        if d.get("last_backoff_s"):
            extra += f" backoff={d['last_backoff_s']:.1f}s"
    if any(s.get("state") == "wedged" for s in d.get("states", [])):
        extra += "  [wedged]"
    if d.get("routed_to"):
        extra += f"  @{d['routed_to']}"
    return (
        f"{d['id']}  {d['type']:5s}  {d['state']:10s}  "
        f"{d['outcome']:9s}  {d['plan']}/{d['case']}{extra}"
    )


def _failed_run_rows(rows: list, limit: int) -> list:
    return [
        d for d in rows
        if d.get("type") == "run"
        and d.get("state") in ("complete", "canceled")
        and d.get("outcome") != "success"
    ][: limit or None]


def cmd_tasks(args) -> int:
    failed_only = args.failed
    if _remote(args):
        rows = _client(args).tasks(limit=0 if failed_only else args.limit)
        if failed_only:
            rows = _failed_run_rows(rows, args.limit)
    else:
        eng = _engine(args)
        try:
            tasks = (eng.storage.failed_runs(limit=args.limit)
                     if failed_only else eng.tasks(limit=args.limit))
            rows = [t.to_dict() for t in tasks]
        finally:
            eng.close()
    if args.json:
        print(json.dumps(rows, indent=2, default=str))
        return 0
    if failed_only:
        if not rows:
            print("no failed run tasks")
            return 0
        for d in rows:
            print(_task_row(d))
            print(f"    resume token: {d['id']}  "
                  f"(testground run --resume {d['id']})")
        return 0
    for d in rows:
        print(_task_row(d))
    return 0


def _hoist_compile_breakdown(d: dict) -> dict:
    """The journal's ``compile_breakdown`` as a top-level key, as the JAX
    command's ``status`` gives it."""
    result = d.get("result")
    journal = ((result or {}).get("journal") or {}) if isinstance(
        result, dict) else {}
    breakdown = journal.get("compile_breakdown")
    if isinstance(breakdown, dict) and "compile_breakdown" not in d:
        d = {**d, "compile_breakdown": breakdown}
    return d


def cmd_status(args) -> int:
    if _remote(args):
        row = _hoist_compile_breakdown(_client(args).status(args.task))
        print(json.dumps(row, indent=2, default=str))
        return 0
    eng = _engine(args)
    try:
        t = eng.get_task(args.task)
        if t is None:
            print(f"no such task: {args.task}", file=sys.stderr)
            return 1
        print(json.dumps(_hoist_compile_breakdown(t.to_dict()), indent=2,
                         default=str))
        return 0
    finally:
        eng.close()


def cmd_logs(args) -> int:
    if _remote(args):
        _client(args).logs(args.task, follow=args.follow, on_line=print)
        return 0
    eng = _engine(args)
    try:
        print(eng.logs(args.task), end="")
        return 0
    finally:
        eng.close()


def cmd_kill(args) -> int:
    if _remote(args):
        try:
            _client(args).kill(args.task)
            print(f"killed: {args.task}")
            return 0
        except RPCError as e:
            print(str(e), file=sys.stderr)
            return 1
    eng = _engine(args)
    try:
        if eng.kill(args.task):
            print(f"killed: {args.task}")
            return 0
        print(f"task not killable: {args.task}", file=sys.stderr)
        return 1
    finally:
        eng.close()


def cmd_collect(args) -> int:
    out = Path(args.output or f"{args.task}.tgz")
    if _remote(args):
        with open(out, "wb") as f:
            _client(args).collect_outputs(args.task, f)
        print(f"outputs collected: {out}")
        return 0
    eng = _engine(args)
    try:
        t = eng.get_task(args.task)
        if t is None:
            print(f"no such task: {args.task}", file=sys.stderr)
            return 1
        run_dir = eng.env.dirs.outputs / t.plan / args.task
        if not run_dir.exists():
            print(f"no outputs for task: {args.task}", file=sys.stderr)
            return 1
        _collect_local(run_dir, out)
        return 0
    finally:
        eng.close()


def cmd_terminate(args) -> int:
    if _remote(args):
        n = _client(args).terminate(args.runner)
    else:
        eng = _engine(args)
        try:
            n = eng.terminate(args.runner)
        finally:
            eng.close()
    print(f"terminated {n} instances")
    return 0


def cmd_cache(args) -> int:
    """``cache ls|purge``: the executor cache as the JAX command shows
    it. The port keeps executors in memory only (a daemon's, behind
    ``--endpoint``), so locally the disk tier is off and holds nothing."""
    if args.cache_cmd == "purge":
        n = _client(args).cache_purge(args.key) if _remote(args) else 0
        print(f"purged {n} executor-cache entr{'y' if n == 1 else 'ies'}"
              + (f" matching {args.key!r}" if args.key else ""))
        return 0
    if _remote(args):
        info = _client(args).cache()
    else:
        from .engine.engine import disk_tier_info

        info = disk_tier_info()
    if args.json:
        print(json.dumps(info, indent=2, default=str))
        return 0
    if not info.get("enabled"):
        print("executor disk cache: disabled (TG_EXECUTOR_CACHE_DIR=off)")
        return 0
    print(f"executor disk cache: {info.get('dir', '')}")
    return 0


# --------------------------------------------------- healthcheck, daemon

def cmd_healthcheck(args) -> int:
    from .healthcheck import HealthcheckReport

    if _remote(args):
        report = HealthcheckReport.from_dict(
            _client(args).healthcheck(fix=args.fix, runner=args.runner))
    elif args.runner:
        from .runner.registry import runner_healthcheck

        try:
            report = runner_healthcheck(args.runner, args.fix,
                                        _env(args).runners)
        except LookupError as e:
            print(e, file=sys.stderr)
            return 1
    else:
        report = get_runner(SIM_RUNNER).healthcheck(fix=args.fix)
    print(report.render())
    return 0 if report.ok else 1


def cmd_daemon(args) -> int:
    from .daemon import serve

    return serve(home=getattr(args, "home", None), listen=args.listen,
                 device=args.device, peers=args.peers,
                 advertise=args.advertise)


def cmd_fleet(args) -> int:
    """``fleet ls [--json]`` — the federation plane's fleet
    view (GET /federation): role, per-worker heartbeat age / lease
    headroom / warm cache keys / routed-task counts, and the route
    table."""
    if not _remote(args):
        print(
            "fleet ls needs --endpoint (fleet state lives on the "
            "daemon), e.g. "
            "testground --endpoint http://localhost:8042 fleet ls",
            file=sys.stderr,
        )
        return 2
    info = _client(args).federation()
    if args.json:
        print(json.dumps(info, indent=2, default=str))
        return 0
    role = info.get("role", "standalone")
    print(f"role: {role}  endpoint: {info.get('endpoint', '')}")
    if role == "worker":
        enr = info.get("enrolled", {})
        print(
            f"enrolled with coordinator {enr.get('coordinator', '')} "
            f"({enr.get('heartbeats_sent', 0)} heartbeats sent)"
        )
        return 0
    if role != "coordinator":
        print("standalone daemon (no [daemon] peers configured)")
        return 0
    workers = info.get("workers", [])
    print(
        f"{len(workers)} worker(s); heartbeat every "
        f"{info.get('heartbeat_interval_s', 0):g}s, stale after "
        f"{info.get('stale_after_s', 0):g}s"
    )
    if workers:
        print(
            f"{'worker':<28} {'alive':<6} {'hb age':>7} {'queue':>5} "
            f"{'headroom':>10} {'keys':>5} {'tasks':>5}"
        )
    for w in workers:
        free = (w.get("lease") or {}).get("free_bytes")
        headroom = f"{free / 1e9:.1f} GB" if free is not None else "-"
        print(
            f"{w.get('worker', ''):<28} "
            f"{'yes' if w.get('alive') else 'LOST':<6} "
            f"{w.get('heartbeat_age_s', 0.0):>6.1f}s "
            f"{w.get('queue_depth', 0):>5} {headroom:>10} "
            f"{len(w.get('cache_keys', [])):>5} "
            f"{w.get('routed_tasks', 0):>5}"
        )
    routes = [
        r for r in info.get("routes", [])
        if r.get("state") not in ("complete", "canceled")
    ]
    if routes:
        print(f"{len(routes)} routed task(s) in flight:")
        for r in routes:
            print(
                f"  {r['task_id']}  {r.get('kind', 'run'):<7} "
                f"{r.get('plan', '')}/{r.get('case', '')}  "
                f"{r.get('state', '')}  @{r.get('worker', '')}"
                + (
                    f"  attempts={r['attempts']}"
                    if r.get("attempts")
                    else ""
                )
            )
    return 0


# ------------------------------------------------------------- parser

def _common(sub: bool) -> argparse.ArgumentParser:
    """``--home`` and ``--endpoint``, taken before or after a command's
    name (after it, into ``sub_*``, merged in ``main``; unset there, so
    that a subcommand's parser leaves what its parent took)."""
    p = argparse.ArgumentParser(add_help=False)
    pre = "sub_" if sub else ""
    default = argparse.SUPPRESS if sub else None
    p.add_argument("--home", default=default, dest=f"{pre}home",
                   help="TESTGROUND_HOME override")
    p.add_argument("--endpoint", default=default, dest=f"{pre}endpoint",
                   help="daemon endpoint (e.g. http://localhost:8042); "
                   "without it, commands run against an in-process engine")
    return p


def _device_flag(p, what="cuda (the default) or cpu"):
    p.add_argument("--device", default="cuda", help=what)


def _run_flags(rp) -> None:
    """The flags ``run single`` and ``run composition`` share: the JAX
    command's, and the port's ``--device`` and ``--run-id``."""
    _device_flag(rp)
    rp.add_argument("--run-id", default=None,
                    help="the run's task id (its outputs directory's name)")
    rp.add_argument("--wait", action=argparse.BooleanOptionalAction,
                    default=True)
    rp.add_argument("--collect", action="store_true")
    rp.add_argument("--collect-file", default=None)
    rp.add_argument("--timeout", type=float, default=600.0)
    rp.add_argument("--test-param", action="append", dest="test_param")
    rp.add_argument("--run-cfg", action="append", dest="run_cfg")
    rp.add_argument("--runner", dest="runner_override", default=None,
                    help="the composition's runner (sim:jax: the port's "
                    "sim runner)")
    rp.add_argument("--sweep-seeds", type=int, default=None,
                    dest="sweep_seeds",
                    help="run N seed scenarios as one batched program "
                    "(adds/overrides the composition's [sweep] seeds)")
    rp.add_argument("--mesh", default=None, dest="mesh_shape",
                    metavar="DsxDi",
                    help="a sweep's 2-D device mesh (not ported: "
                    "multi-GPU)")
    rp.add_argument("--trace", action="store_true", dest="trace_on")
    rp.add_argument("--search", action=argparse.BooleanOptionalAction,
                    default=None, dest="search_on",
                    help="run the composition's [search] table: a "
                    "breaking-point search; --no-search marks it disabled")
    rp.add_argument("--search-budget", type=int, default=None,
                    dest="search_budget",
                    help="cap the search at N probed scenarios (sets the "
                    "[search] table's budget)")
    for table in ("faults", "trace", "telemetry", "replay", "live",
                  "checkpoint"):
        rp.add_argument(f"--no-{table}", action="store_true",
                        dest=f"no_{table}",
                        help=f"mark the composition's [{table}] table "
                        "disabled")
    rp.add_argument("--telemetry-interval", type=int, default=None,
                    dest="telemetry_interval")
    rp.add_argument("--live-interval", type=float, default=None,
                    dest="live_interval")
    rp.add_argument("--checkpoint-interval", type=float, default=None,
                    dest="checkpoint_interval")
    rp.add_argument("--drain", action="store_true", dest="drain_on",
                    help="stream the observer planes out at every chunk "
                    "boundary (drain = true on [trace] and [telemetry])")
    rp.add_argument("--no-drain", action="store_true", dest="no_drain",
                    help="clear drain on [trace] and [telemetry]")
    rp.add_argument("--replay", default=None, dest="replay_file",
                    metavar="FILE",
                    help="drive the run from a recorded workload trace "
                    "(sets, or creates, the [replay] table's trace)")
    rp.add_argument("--replay-scale", type=float, default=None,
                    dest="replay_scale",
                    help="request-load multiplier of the replayed trace "
                    "(the [replay] table's scale)")


def build_parser() -> argparse.ArgumentParser:
    common = _common(sub=True)
    p = argparse.ArgumentParser(prog="python -m testground_tpu_torch",
                                parents=[_common(sub=False)])
    sub = p.add_subparsers(dest="cmd")

    sub.add_parser("version", parents=[common]).set_defaults(fn=cmd_version)
    plan = sub.add_parser("plan").add_subparsers(dest="plan_cmd")
    pl = plan.add_parser("list", parents=[common])
    pl.set_defaults(fn=cmd_plan_list)
    pi = plan.add_parser("import", parents=[common])
    pi.add_argument("--from", dest="source", required=True)
    pi.add_argument("--name", default=None)
    pi.add_argument("--git", action="store_true",
                    help="treat --from as a git URL and clone it")
    pi.set_defaults(fn=cmd_plan_import)
    pr = plan.add_parser("rm", parents=[common])
    pr.add_argument("name")
    pr.set_defaults(fn=cmd_plan_rm)
    pc = plan.add_parser("create", parents=[common])
    pc.add_argument("name")
    pc.set_defaults(fn=cmd_plan_create)
    d = sub.add_parser("describe", parents=[common])
    d.add_argument("plan")
    d.set_defaults(fn=cmd_describe)

    runp = sub.add_parser("run", parents=[common])
    runp.add_argument("--resume", default=None, dest="resume_task",
                      metavar="TASK_ID",
                      help="continue an interrupted run task from its last "
                      "checkpoint (see tasks --failed)")
    runp.add_argument("--wait", action=argparse.BooleanOptionalAction,
                      default=True)
    runp.add_argument("--timeout", type=float, default=600.0)
    _device_flag(runp)
    runp.set_defaults(fn=cmd_run_resume)
    run = runp.add_subparsers(dest="run_cmd")
    rp = run.add_parser("composition", parents=[common],
                        help="run a composition file")
    rp.add_argument("composition")
    _run_flags(rp)
    rp.add_argument("--resume", default=None, metavar="TASK_ID",
                    help="continue task TASK_ID from its last checkpoint")
    rp.set_defaults(fn=cmd_run_composition)
    rs = run.add_parser("single", parents=[common],
                        help="run one group of a plan's test case")
    rs.add_argument("--plan", required=True)
    rs.add_argument("--testcase", required=True)
    rs.add_argument("--builder", default="exec:python")
    rs.add_argument("--instances", type=int, default=1)
    _run_flags(rs)
    rs.set_defaults(fn=cmd_run_single, runner="local:exec")

    build = sub.add_parser("build").add_subparsers(dest="build_cmd")
    bc = build.add_parser("composition", parents=[common])
    bc.add_argument("composition")
    bc.add_argument("--wait", action=argparse.BooleanOptionalAction,
                    default=True)
    bc.add_argument("--timeout", type=float, default=600.0)
    bc.add_argument("--write-artifacts", "-w", action="store_true",
                    dest="write_artifacts")
    bc.set_defaults(fn=cmd_build_composition)
    bs = build.add_parser("single", parents=[common])
    bs.add_argument("--plan", required=True)
    bs.add_argument("--testcase", default=None)
    bs.add_argument("--builder", default="exec:python")
    bs.add_argument("--timeout", type=float, default=600.0)
    bs.set_defaults(fn=cmd_build_single)
    bp = build.add_parser("purge", parents=[common])
    bp.add_argument("--plan", required=True)
    bp.set_defaults(fn=cmd_build_purge)

    pw = sub.add_parser("prewarm", parents=[common],
                        help="capture a composition's executor, no run")
    pw.add_argument("composition")
    _device_flag(pw)
    pw.add_argument("--wait", action=argparse.BooleanOptionalAction,
                    default=True)
    pw.add_argument("--timeout", type=float, default=600.0)
    pw.set_defaults(fn=cmd_prewarm)

    dm = sub.add_parser("daemon", parents=[common],
                        help="serve the engine over HTTP")
    dm.add_argument("--listen", default=None,
                    help="HOST:PORT (default: env.toml's [daemon] listen, "
                    "localhost:8042; port 0 picks a free one)")
    _device_flag(dm, "the runs' device: cuda (the default) or cpu")
    dm.add_argument(
        "--peer", action="append", dest="peers", metavar="HOST:PORT",
        help="a worker daemon to federate (repeatable); listing any "
        "peer makes this daemon the fleet COORDINATOR — submitted "
        "runs route to the best worker by cache affinity + headroom "
        "(docs/federation.md)",
    )
    dm.add_argument(
        "--advertise", default=None,
        help="endpoint workers dial back for heartbeats (default: the "
        "listen address; set it when workers reach this daemon "
        "through a different address)",
    )
    dm.set_defaults(fn=cmd_daemon)
    fleet = sub.add_parser("fleet").add_subparsers(dest="fleet_cmd")
    fls = fleet.add_parser("ls", parents=[common])
    fls.add_argument("--json", action="store_true", help="raw JSON")
    fls.set_defaults(fn=cmd_fleet)

    t = sub.add_parser("tasks", parents=[common])
    t.add_argument("--limit", type=int, default=20)
    t.add_argument("--failed", action="store_true",
                   help="only failed, canceled or preempted run tasks, "
                   "with their resume tokens")
    t.add_argument("--json", action="store_true",
                   help="the full task rows as JSON")
    t.set_defaults(fn=cmd_tasks)
    st = sub.add_parser("status", parents=[common])
    st.add_argument("--task", required=True)
    st.add_argument("--json", action="store_true",
                    help="accepted for symmetry: status prints JSON")
    st.set_defaults(fn=cmd_status)
    lg = sub.add_parser("logs", parents=[common])
    lg.add_argument("--task", required=True)
    lg.add_argument("--follow", action="store_true")
    lg.set_defaults(fn=cmd_logs)
    kl = sub.add_parser("kill", parents=[common])
    kl.add_argument("--task", required=True)
    kl.set_defaults(fn=cmd_kill)
    co = sub.add_parser("collect", parents=[common])
    co.add_argument("--task", required=True)
    co.add_argument("--output", default=None)
    co.set_defaults(fn=cmd_collect)
    tm = sub.add_parser("terminate", parents=[common])
    tm.add_argument("--runner", default=None)
    tm.set_defaults(fn=cmd_terminate)
    cache = sub.add_parser("cache").add_subparsers(dest="cache_cmd")
    cls_ = cache.add_parser("ls", parents=[common])
    cls_.add_argument("--json", action="store_true", help="raw JSON")
    cls_.set_defaults(fn=cmd_cache)
    cpu_ = cache.add_parser("purge", parents=[common])
    cpu_.add_argument("--key", default=None,
                      help="entry-id prefix (default: all)")
    cpu_.set_defaults(fn=cmd_cache, json=False)

    hp = sub.add_parser("healthcheck", parents=[common],
                        help="the port's health checks")
    hp.add_argument("--fix", action="store_true")
    hp.add_argument("--runner", default=None,
                    help="check a runner's own infrastructure")
    hp.set_defaults(fn=cmd_healthcheck)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "fn", None) is None:
        parser.print_help()
        return 2
    for k in ("home", "endpoint"):
        if getattr(args, f"sub_{k}", None) is not None:
            setattr(args, k, getattr(args, f"sub_{k}"))
    import os

    if args.home:
        os.environ["TESTGROUND_HOME"] = args.home
    try:
        return args.fn(args)
    except (RPCError, EngineError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (CompositionError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except ConnectionError as e:
        if _remote(args):
            print(f"error: cannot reach daemon {args.endpoint}: {e}",
                  file=sys.stderr)
            return 1
        raise
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
