"""The port's command line (``python -m testground_tpu_torch``):

    run composition FILE [flags]   run a composition with the port's sim
                                   runner, on the card by default (a
                                   [sweep] as one batched program, an
                                   enabled [search] as a breaking-point
                                   search)
    healthcheck [--fix]            the port's health checks

Counterpart of ``testground run composition FILE`` run locally
(``testground_tpu/cmd/root.py``) without the task queue and the builder:
the composition's flags under the JAX command's names shape it, it is
prepared against its plan's manifest as the JAX engine prepares it, and
its outputs go to ``$TESTGROUND_HOME/data/outputs/<plan>/<run_id>``; the
composition's ``[global] runner`` picks the runner, and SIGTERM preempts
the run at its next chunk boundary (``--resume RUN_ID`` continues it). The
plan's directory (its manifest and data files) is the composition file's
own directory when that holds the plan's manifest, else
``$TESTGROUND_HOME/plans/<plan>``, else the repository's
``plans/<plan>``. The exit code is 0 when the run succeeds.
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
from .healthcheck.checks import home_dir
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


def _preempt_on_sigterm(signum, frame) -> None:
    """SIGTERM preempts the run at its next chunk boundary, with a forced
    final checkpoint and a resume token, as the JAX command's handler
    does."""
    from .sim.runner import preempt_all_runs

    n = preempt_all_runs()
    if n:
        print(f"SIGTERM: preempting {n} in-flight run(s) — each stops at "
              "its next chunk boundary with a final checkpoint", flush=True)


def cmd_run_composition(args) -> int:
    home = home_dir()
    comp = Composition.load(args.composition)
    apply_overrides(comp, args)
    run_id = args.resume or args.run_id or new_run_id()
    rinput = prepare_run(comp, plan_dir_for(comp, args.composition, home),
                         run_id, home, resume=bool(args.resume))
    runner = get_runner(rinput.composition.global_.runner)
    prev = signal.signal(signal.SIGTERM, _preempt_on_sigterm)
    try:
        out = runner.run(rinput, ow=print, device=args.device)
    finally:
        signal.signal(signal.SIGTERM, prev)
    r = out.result
    print(f"run {run_id}: outcome {r.outcome} "
          + json.dumps({k: {"ok": v.ok, "total": v.total}
                        for k, v in r.outcomes.items()}))
    print(f"outputs: {rinput.run_dir}")
    return 0 if r.outcome == "success" else 1


def cmd_healthcheck(args) -> int:
    report = get_runner(SIM_RUNNER).healthcheck(fix=args.fix)
    print(report.render())
    return 0 if report.ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m testground_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run").add_subparsers(dest="run_cmd", required=True)
    rp = run.add_parser("composition", help="run a composition file")
    rp.add_argument("composition")
    rp.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    rp.add_argument("--run-id", default=None,
                    help="the run's id (its outputs directory's name)")
    rp.add_argument("--resume", default=None, metavar="RUN_ID",
                    help="continue run RUN_ID from its last checkpoint")
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
    hp = sub.add_parser("healthcheck", help="the port's health checks")
    hp.add_argument("--fix", action="store_true")
    hp.set_defaults(fn=cmd_healthcheck)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (CompositionError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

