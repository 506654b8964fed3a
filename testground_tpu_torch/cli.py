"""The port's command line (``python -m testground_tpu_torch``), the
counterpart of the JAX package's ``testground`` command
(``testground_tpu/cmd/root.py``) for the commands that drive the sim
runner:

    run composition FILE [flags]   queue a composition and wait for it (a
                                   [sweep] runs as one batched program,
                                   an enabled [search] as a
                                   breaking-point search)
    prewarm FILE                   build and capture its executor into the
                                   runner's pool, without running it
    daemon [--listen] [--device]   serve the engine over HTTP
    tasks | status | logs | kill | collect | terminate | cache ls|purge
                                   the task store, logs, outputs and the
                                   executor cache
    healthcheck [--runner] [--fix] the port's health checks

Without ``--endpoint`` a command runs against an in-process engine over
the task store in ``$TESTGROUND_HOME/data/daemon`` (engine/): ``run
composition`` queues its task there, a scheduler worker runs it, and
``tasks`` and ``status`` list it afterwards. With ``--endpoint URL`` (before
or after the command's name) it goes to a daemon through the client, with
the JAX command's output and exit codes; the plan's directory travels
with the run. Runs go to the card unless ``--device cpu`` is given (to
``run composition`` and ``prewarm`` locally, to ``daemon`` for the daemon's
runs).

A composition's flags under the JAX command's names shape it, and it is
prepared against its plan's manifest as the JAX engine prepares it; its
outputs go to ``$TESTGROUND_HOME/data/outputs/<plan>/<task id>``. The
plan's directory (its manifest and data files) is the composition file's
own directory when that holds the plan's manifest, else
``$TESTGROUND_HOME/plans/<plan>``, else the repository's ``plans/<plan>``.
SIGTERM preempts a local run at its next chunk boundary (``--resume
TASK_ID`` continues it). A local run's exit code is 0 when it succeeds.
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
from .sim.tables import CompositionError, Sweep, Telemetry, Trace

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
    on every group, ``--run-cfg`` typed into the run config,
    ``--sweep-seeds`` setting (or creating) the [sweep] table's seeds,
    ``--no-*`` marking a table disabled (created for [live] and
    [checkpoint], which are on by default), the interval flags setting
    (or creating) their table, ``--trace`` enabling one, ``--search`` /
    ``--no-search`` and ``--search-budget`` acting on the composition's
    [search] table (an error without one)."""
    for k, v in _key_values(getattr(args, "test_param", None)).items():
        for g in comp.groups:
            g.run.test_params[k] = v
    comp.global_.run_config.update(
        {k: _typed(v)
         for k, v in _key_values(getattr(args, "run_cfg", None)).items()})
    if getattr(args, "sweep_seeds", None) is not None:
        # `is not None`: --sweep-seeds 0 reaches Sweep.validate's error
        if comp.sweep is None:
            comp.sweep = Sweep()
        comp.sweep.seeds = args.sweep_seeds
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
    if getattr(args, "no_replay", False) and comp.replay is not None:
        comp.replay.enabled = False
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


def plan_dir_for(comp: Composition, comp_path, home) -> Path:
    """Where the plan's manifest and data files are (module docstring)."""
    plan = comp.global_.plan
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


def _plan_dir(comp: Composition, comp_path, home):
    """The plan's directory, or None when none is found (a daemon then
    resolves the plan under its own home)."""
    try:
        return plan_dir_for(comp, comp_path, home)
    except FileNotFoundError:
        return None


# ----------------------------------------------------------------- run

def cmd_run_composition(args) -> int:
    home = home_dir()
    comp = Composition.load(args.composition)
    apply_overrides(comp, args)
    if _remote(args):
        return _run_remote(args, comp, _plan_dir(comp, args.composition,
                                                 home))
    from .device import resolve_device
    from .sim.runner import load_plan_module

    resolve_device(args.device)
    plan_dir = plan_dir_for(comp, args.composition, home)
    load_plan_module(TestPlanManifest.load(plan_dir / "manifest.toml").name)
    eng = _engine(args, device=args.device)
    prev = signal.getsignal(signal.SIGTERM)
    eng.install_preemption_handler()
    try:
        if args.resume:
            tid = _resume(eng, comp, args.resume, plan_dir)
        else:
            tid = eng.queue_run(comp, sources_dir=str(plan_dir),
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
    if not isinstance(t.result, dict):
        print(f"run {tid}: outcome {t.outcome} ({t.error})")
        return 1
    r = t.result
    run_dir = eng.env.dirs.outputs / t.plan / tid
    print(f"run {tid}: outcome {r['outcome']} "
          + json.dumps(r.get("outcomes", {})))
    print(f"outputs: {run_dir}")
    if args.collect:
        _collect_local(run_dir, Path(args.collect_file or f"{tid}.tgz"))
    return 0 if r["outcome"] == "success" else 1


def _resume(eng, comp, tid: str, plan_dir) -> str:
    """Requeue task ``tid`` to continue from its last checkpoint; a run
    the task store does not hold (its outputs from elsewhere) is queued
    under its id with a resume request."""
    if eng.get_task(tid) is None:
        return eng.queue_run(comp, sources_dir=str(plan_dir), task_id=tid,
                             resume=True)
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
    if args.resume:
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


def _collect_local(run_dir, out: Path) -> None:
    from .runner.outputs import tar_outputs

    with open(out, "wb") as f:
        tar_outputs(str(run_dir), f)
    print(f"outputs collected: {out}")


def cmd_prewarm(args) -> int:
    """Build and capture the composition's executor into the runner's
    pool without running it (the JAX command's ``prewarm``); the next
    run of the same program on that engine captures nothing."""
    home = home_dir()
    comp = Composition.load(args.composition)
    plan_dir = _plan_dir(comp, args.composition, home)
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
                 device=args.device)


# ------------------------------------------------------------- parser

def _common(sub: bool) -> argparse.ArgumentParser:
    """``--home`` and ``--endpoint``, taken before or after a command's
    name (after it, into ``sub_*``, merged in ``main``)."""
    p = argparse.ArgumentParser(add_help=False)
    pre = "sub_" if sub else ""
    p.add_argument("--home", default=None, dest=f"{pre}home",
                   help="TESTGROUND_HOME override")
    p.add_argument("--endpoint", default=None, dest=f"{pre}endpoint",
                   help="daemon endpoint (e.g. http://localhost:8042); "
                   "without it, commands run against an in-process engine")
    return p


def build_parser() -> argparse.ArgumentParser:
    common = _common(sub=True)
    p = argparse.ArgumentParser(prog="python -m testground_tpu_torch",
                                parents=[_common(sub=False)])
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run").add_subparsers(dest="run_cmd", required=True)
    rp = run.add_parser("composition", parents=[common],
                        help="run a composition file")
    rp.add_argument("composition")
    rp.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    rp.add_argument("--run-id", default=None,
                    help="the run's task id (its outputs directory's name)")
    rp.add_argument("--resume", default=None, metavar="TASK_ID",
                    help="continue task TASK_ID from its last checkpoint")
    rp.add_argument("--wait", action=argparse.BooleanOptionalAction,
                    default=True)
    rp.add_argument("--collect", action="store_true")
    rp.add_argument("--collect-file", default=None)
    rp.add_argument("--timeout", type=float, default=600.0)
    rp.add_argument("--test-param", action="append", dest="test_param")
    rp.add_argument("--run-cfg", action="append", dest="run_cfg")
    rp.add_argument("--sweep-seeds", type=int, default=None,
                    dest="sweep_seeds",
                    help="run N seed scenarios as one batched program "
                    "(adds/overrides the composition's [sweep] seeds)")
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
    rp.set_defaults(fn=cmd_run_composition)

    pw = sub.add_parser("prewarm", parents=[common],
                        help="capture a composition's executor, no run")
    pw.add_argument("composition")
    pw.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    pw.add_argument("--wait", action=argparse.BooleanOptionalAction,
                    default=True)
    pw.add_argument("--timeout", type=float, default=600.0)
    pw.set_defaults(fn=cmd_prewarm)

    dm = sub.add_parser("daemon", parents=[common],
                        help="serve the engine over HTTP")
    dm.add_argument("--listen", default=None,
                    help="HOST:PORT (default: env.toml's [daemon] listen, "
                    "localhost:8042; port 0 picks a free one)")
    dm.add_argument("--device", default="cuda",
                    help="the runs' device: cuda (the default) or cpu")
    dm.set_defaults(fn=cmd_daemon)

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
    cache = sub.add_parser("cache").add_subparsers(dest="cache_cmd",
                                                   required=True)
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
    args = build_parser().parse_args(argv)
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
    except (CompositionError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except ConnectionError as e:
        if _remote(args):
            print(f"error: cannot reach daemon {args.endpoint}: {e}",
                  file=sys.stderr)
            return 1
        raise
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
