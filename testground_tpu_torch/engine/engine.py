"""The engine (a copy of ``testground_tpu/engine/engine.py``): the task
queue, the scheduler workers and the registries.

It queues build, run and prewarm tasks into the task store, and its
scheduler workers (threads) take them in priority order: a run task's
groups are built by the ``sim:module`` builder when they carry no
artifact, its composition is prepared against the plan's manifest, and
the port's sim runner (``runner/sim_torch.py``, registered as
``sim:jax``) runs it on the engine's ``device`` (the card by default) as
``run_id`` = the task's id, its outputs under
``$TESTGROUND_HOME/data/outputs/<plan>/<task id>``. Two workers run two
tasks at once on one card: the runner leases each run's memory
(sim/leases.py) and serializes their captures (sim/core.py).

The executor cache the engine reports (``executor_cache_info``, GET
/cache) is the runner's in-memory pool and its device leases; the disk
and shared tiers are reported as off, as the JAX engine reports them with
``TG_EXECUTOR_CACHE_DIR=off``, until ROADMAP item 11.3.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

from ..api import Composition, RunGroup, RunInput, TestPlanManifest
from ..api.contracts import BuildInput
from ..builders import all_builders, get_builder
from ..config import CoalescedConfig, EnvConfig
from ..runner import all_runners, get_runner
from ..task import (
    STATE_CANCELED,
    STATE_COMPLETE,
    STATE_PROCESSING,
    STATE_SCHEDULED,
    STATE_WEDGED,
    MemoryTaskStorage,
    Task,
    TaskQueue,
    TaskStorage,
    TYPE_BUILD,
    TYPE_PREWARM,
    TYPE_RUN,
)
from ..obs import REGISTRY as _OBS
from ..utils.ids import new_id
from .status import StatusReporter

# fleet metrics plane (docs/observability.md): the engine owns the
# robustness-loop counters — watchdog fires, retries, backoff budget,
# resumes — plus scrape-time queue gauges (registered per Engine in
# __init__, unregistered in close() so short-lived test engines don't
# pile up dead collectors on the process-global registry).
_M_WATCHDOG_FIRES = _OBS.counter(
    "tg_watchdog_fires_total",
    "Wedged chunk dispatches flagged by the dispatch watchdog.",
)
_M_RETRIES = _OBS.counter(
    "tg_task_retries_total",
    "Wedged run tasks requeued with backoff (resume-from-checkpoint).",
)
_M_RETRIES_EXHAUSTED = _OBS.counter(
    "tg_task_retries_exhausted_total",
    "Wedged run tasks that ran out of attempts and completed as failures.",
)
_M_BACKOFF_S = _OBS.counter(
    "tg_task_backoff_seconds_total",
    "Cumulative retry backoff applied to requeued tasks, in seconds.",
)
_M_RESUMES = _OBS.counter(
    "tg_task_resumes_total",
    "Run tasks explicitly requeued with a resume request.",
)
_M_QUEUE_DEPTH = _OBS.gauge(
    "tg_tasks_queue_depth",
    "Scheduled tasks currently queued (includes backing-off retries).",
)
_M_QUEUE_OLDEST = _OBS.gauge(
    "tg_tasks_oldest_age_seconds",
    "Age of the oldest queued task, in seconds (0 when the queue is empty).",
)


class EngineError(RuntimeError):
    pass


# the runner's modules, once a run has imported them
_SIM_RUNNER = "testground_tpu_torch.sim.runner"
_SIM_LEASES = "testground_tpu_torch.sim.leases"
# the disk tier's counters, all 0: the port has no disk tier (item 11.3)
_DISK_STATS = ("disk_hits", "disk_misses", "stores", "errors",
               "shared_hits", "shared_misses", "shared_stores")


def disk_tier_info() -> dict:
    """The disk executor tier as the JAX engine reports it with
    ``TG_EXECUTOR_CACHE_DIR=off``: no directory, no entries, counters 0."""
    return {"dir": "", "enabled": False, "entries": [],
            "disk": {k: 0 for k in _DISK_STATS}}


class Engine:
    """Singleton orchestrator: task queue + workers + registries."""

    def __init__(
        self,
        env_config: Optional[EnvConfig] = None,
        storage: Optional[TaskStorage] = None,
        workers: int = 0,
        device: str = "cuda",
    ) -> None:
        self.env = env_config or EnvConfig.load()
        self.env.dirs.ensure()
        # the runner's device for every run and prewarm: the card unless
        # the caller asks for the CPU (the runner raises through
        # resolve_device when there is no card)
        self.device = device
        if storage is None:
            if self.env.daemon.task_repo_type == "memory":
                storage = MemoryTaskStorage()
            else:
                storage = TaskStorage(self.env.dirs.daemon / "tasks.db")
        self.storage = storage
        self.queue = TaskQueue(storage)
        self.builders = all_builders()
        self.runners = all_runners()
        self._kill_flags: dict[str, threading.Event] = {}
        self.status = StatusReporter(
            github_token=self.env.daemon.github_repo_status_token,
            slack_webhook_url=self.env.daemon.slack_webhook_url,
            tasks_url=f"http://{self.env.daemon.listen}/tasks",
        )
        self._stop = threading.Event()
        self._workers: list[threading.Thread] = []
        n = workers or self.env.daemon.scheduler_workers
        for i in range(n):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._workers.append(t)
        _OBS.register_collector(self._collect_queue_metrics)

    def _collect_queue_metrics(self) -> None:
        """Scrape-time gauges for GET /metrics — point-in-time queue
        state, computed on demand instead of by a sampler thread."""
        depth, oldest = self.queue.depth_and_oldest_age()
        _M_QUEUE_DEPTH.set(depth)
        _M_QUEUE_OLDEST.set(round(oldest, 3))

    # --------------------------------------------------------------- queue

    def queue_build(
        self,
        composition: Composition,
        sources_dir: Optional[str] = None,
        priority: int = 0,
        created_by: Optional[dict] = None,
    ) -> str:
        composition.validate_for_build()
        tid = new_id()
        task = Task(
            id=tid,
            type=TYPE_BUILD,
            priority=priority,
            plan=composition.global_.plan,
            case=composition.global_.case,
            created_by=created_by or {},
            composition=composition.to_dict(),
            input={"sources_dir": sources_dir},
        )
        self.queue.push(task)
        return tid

    def queue_run(
        self,
        composition: Composition,
        sources_dir: Optional[str] = None,
        priority: int = 0,
        created_by: Optional[dict] = None,
        run_ids: Optional[dict] = None,
        task_id: Optional[str] = None,
        routed_to: str = "",
        attempts: int = 0,
        resume: bool = False,
    ) -> str:
        """Queue one run. ``task_id``/``routed_to``/``attempts``/
        ``resume`` are the federation plane's routed-submission fields:
        the coordinator mints the id (stable across requeues on worker
        loss), names the worker it chose, carries the retry count into
        the run journal's ``attempt`` and asks for a checkpoint resume
        when the run dir may survive on shared storage."""
        # Runner must exist and not be disabled
        # (reference engine.go:203-249, supervisor.go:566-569).
        runner = composition.global_.runner
        if runner not in self.runners:
            raise EngineError(f"unknown runner: {runner}")
        if self.env.runner_disabled(runner):
            raise EngineError(f"runner is disabled in configuration: {runner}")
        composition.validate_for_run()
        comp_dict = composition.to_dict()
        tid = task_id or new_id()
        task_input: dict = {
            "sources_dir": sources_dir,
            "affinity": self._affinity(comp_dict),
            **(run_ids or {}),
        }
        if resume:
            task_input["resume"] = True
        task = Task(
            id=tid,
            type=TYPE_RUN,
            priority=priority,
            plan=composition.global_.plan,
            case=composition.global_.case,
            created_by=created_by or {},
            composition=comp_dict,
            input=task_input,
            routed_to=routed_to,
            attempts=attempts,
        )
        if task.created_by.get("repo") and task.created_by.get("branch"):
            self.queue.push_unique_by_branch(task)
        else:
            self.queue.push(task)
        return tid

    @staticmethod
    def _affinity(comp_dict: dict) -> str:
        """The federation plane's portable composition digest, computed
        at queue time — BEFORE build/prepare mutate the composition —
        so it matches what a coordinator computed on the identical
        submitted dict (federation/affinity.py)."""
        from ..federation.affinity import affinity_key

        try:
            return affinity_key(comp_dict)
        except Exception:  # noqa: BLE001 — routing hint only
            return ""

    def queue_prewarm(
        self,
        composition: Composition,
        sources_dir: Optional[str] = None,
        priority: int = 0,
        created_by: Optional[dict] = None,
        task_id: Optional[str] = None,
        routed_to: str = "",
    ) -> str:
        """Queue a PREWARM task (compile-on-upload, docs/federation.md):
        build + capture the composition's executor into the runner's
        in-memory pool without dispatching a run, so its next run on
        this engine — the one a coordinator routes here by affinity —
        builds nothing. Only runners exposing ``prewarm`` (sim:jax)
        support it."""
        runner = composition.global_.runner
        if runner not in self.runners:
            raise EngineError(f"unknown runner: {runner}")
        if not hasattr(self.runners[runner], "prewarm"):
            raise EngineError(
                f"runner {runner} does not support prewarm "
                "(only sim:jax compiles executors)"
            )
        composition.validate_for_run()
        comp_dict = composition.to_dict()
        tid = task_id or new_id()
        task = Task(
            id=tid,
            type=TYPE_PREWARM,
            priority=priority,
            plan=composition.global_.plan,
            case=composition.global_.case,
            created_by=created_by or {},
            composition=comp_dict,
            input={
                "sources_dir": sources_dir,
                "affinity": self._affinity(comp_dict),
            },
            routed_to=routed_to,
        )
        self.queue.push(task)
        return tid

    # ------------------------------------------------------------- workers

    def _worker(self, idx: int) -> None:
        while not self._stop.is_set():
            task = self.queue.pop(timeout=0.5)
            if task is None:
                continue
            task.transition(STATE_PROCESSING)
            self.storage.put(task)
            self.status.post(task)
            kill = threading.Event()
            self._kill_flags[task.id] = kill
            log_path = self.task_log_path(task.id)
            # per-task watchdog for RUN tasks (reference: 10 min default,
            # cancel signal — supervisor.go:47-190): fires kill(), which the
            # runners honor via the kill flag + terminate_run. Builds have
            # no cancellation point, so arming the timer for them would only
            # mislabel a slow-but-successful build as canceled.
            watchdog = None
            if task.type == TYPE_RUN:
                watchdog = threading.Timer(
                    self.env.daemon.task_timeout_min * 60.0,
                    lambda tid=task.id: self.kill(tid),
                )
                watchdog.daemon = True
                watchdog.start()
            requeued = False
            try:
                with open(log_path, "a") as logf:
                    # concurrent builders share this logger; text streams
                    # are not thread-safe for interleaved writes
                    log_lock = threading.Lock()

                    def log(msg: str) -> None:
                        with log_lock:
                            logf.write(
                                f"{time.strftime('%H:%M:%S')} {msg}\n"
                            )
                            logf.flush()

                    if task.type == TYPE_BUILD:
                        result = self._do_build(task, log)
                    elif task.type == TYPE_PREWARM:
                        result = self._do_prewarm(task, log)
                    else:
                        result = self._do_run(task, log, kill)
                    task.result = result
            except Exception as e:  # noqa: BLE001 — task outcome carries it
                # the dispatch-watchdog path (sim/checkpoint.py): a
                # wedged chunk dispatch is a retryable infrastructure
                # fault, not a plan failure — requeue with capped
                # exponential backoff, resuming from the last
                # checkpoint. Matched by name, as the JAX engine
                # matches it, so the engine imports no runner module.
                wedged = type(e).__name__ == "WedgedDispatchError"
                if wedged:
                    _M_WATCHDOG_FIRES.inc()
                if (
                    wedged
                    and task.type == TYPE_RUN
                    and not kill.is_set()
                ):
                    requeued = self._requeue_wedged(task, e, log_path)
                if not requeued:
                    task.error = f"{type(e).__name__}: {e}"
                    with open(log_path, "a") as logf:
                        logf.write(traceback.format_exc())
            finally:
                if watchdog is not None:
                    watchdog.cancel()
                self._kill_flags.pop(task.id, None)
            if requeued:
                self.status.post(task)
                continue
            if (
                task.type == TYPE_RUN
                and isinstance(task.result, dict)
                and task.result.get("outcome") == "preempted"
            ):
                # a SIGTERM-preempted run completed with a forced final
                # checkpoint: keep the resume request on the task so
                # `testground run --resume <id>` (or resume_task)
                # continues it
                task.input = {**(task.input or {}), "resume": True}
            task.transition(
                STATE_CANCELED if kill.is_set() else STATE_COMPLETE
            )
            self.storage.put(task)
            self.status.post(task)

    # retry policy for wedged dispatches (docs/robustness.md): capped
    # exponential backoff, bounded attempts — env-tunable so tests and
    # constrained deployments can retune without code changes. Like
    # runner._env_num, a malformed value WARNS (once per bad value)
    # instead of silently becoming the default.
    _WARNED_RETRY_ENV: dict = {}

    @classmethod
    def _retry_env(cls, name: str, default: float) -> float:
        import os

        raw = os.environ.get(name)
        if raw is None or raw == "":
            return default
        try:
            return float(raw)
        except ValueError:
            if cls._WARNED_RETRY_ENV.get(name) != raw:
                cls._WARNED_RETRY_ENV[name] = raw
                print(
                    f"WARNING: ignoring malformed {name}={raw!r} "
                    f"(not a number); using default {default}",
                    file=sys.stderr,
                )
            return default

    def _requeue_wedged(self, task: Task, err, log_path) -> bool:
        """Requeue a wedged run task with backoff; False when its
        attempts are exhausted (the task then completes as a failure,
        its error carrying the watchdog's diagnosis)."""
        max_attempts = int(self._retry_env("TG_TASK_MAX_ATTEMPTS", 3))
        task.attempts += 1
        if task.attempts >= max_attempts:
            _M_RETRIES_EXHAUSTED.inc()
            with open(log_path, "a") as logf:
                logf.write(
                    f"wedged dispatch, attempt {task.attempts}/"
                    f"{max_attempts} — retries exhausted: {err}\n"
                )
            return False
        base = self._retry_env("TG_TASK_RETRY_BACKOFF_S", 2.0)
        cap = self._retry_env("TG_TASK_RETRY_BACKOFF_CAP_S", 60.0)
        backoff = min(cap, base * (2.0 ** (task.attempts - 1)))
        task.last_backoff_s = backoff
        task.backoff_until = time.time() + backoff
        task.input = {**(task.input or {}), "resume": True}
        # the wedged transition stays in the state history (auditable on
        # /tasks and /status), then the task goes back to scheduled —
        # pop() honors backoff_until
        task.transition(STATE_WEDGED)
        self.storage.put(task)
        with open(log_path, "a") as logf:
            logf.write(
                f"wedged dispatch ({err}); attempt {task.attempts}/"
                f"{max_attempts}, requeued with {backoff:.1f}s backoff "
                "— will resume from the last checkpoint\n"
            )
        task.transition(STATE_SCHEDULED)
        self.queue.push(task)
        _M_RETRIES.inc()
        _M_BACKOFF_S.inc(backoff)
        return True

    # --------------------------------------------------------------- build

    def _resolve_plan(
        self, plan: str, sources_dir: Optional[str]
    ) -> tuple[Path, TestPlanManifest]:
        pdir = Path(sources_dir) if sources_dir else self.env.dirs.plans / plan
        mpath = pdir / "manifest.toml"
        if not mpath.exists():
            raise EngineError(f"plan not found (no manifest.toml): {pdir}")
        return pdir, TestPlanManifest.load(mpath)

    def _do_build(self, task: Task, log) -> dict:
        comp = Composition.from_dict(task.composition)
        pdir, manifest = self._resolve_plan(
            comp.global_.plan, (task.input or {}).get("sources_dir")
        )
        prepared = comp.prepare_for_build(manifest)

        # Dedup groups by build key (reference supervisor.go:359-364).
        artifacts: dict[str, str] = {}
        by_key: dict[str, list[int]] = {}
        for i, g in enumerate(prepared.groups):
            by_key.setdefault(g.build_key(), []).append(i)

        # Distinct build keys build CONCURRENTLY with bounded workers
        # (reference supervisor.go:298-492's errgroup with concurrency cap).
        def build_one(idxs: list[int]):
            g = prepared.groups[idxs[0]]
            builder = get_builder(g.builder)
            log(f"building group(s) {[prepared.groups[i].id for i in idxs]} "
                f"with {g.builder}")
            return idxs, builder.build(
                BuildInput(
                    build_id=task.id,
                    env_config=self.env,
                    source_dir=str(pdir),
                    select_build=g,
                    composition=prepared,
                    manifest=manifest,
                )
            )

        groups_by_key = list(by_key.values())
        from concurrent.futures import (
            FIRST_EXCEPTION,
            ThreadPoolExecutor,
            wait,
        )

        pool = ThreadPoolExecutor(max_workers=min(4, len(groups_by_key)))
        try:
            futs = [pool.submit(build_one, idxs) for idxs in groups_by_key]
            done, not_done = wait(futs, return_when=FIRST_EXCEPTION)
            err = next(
                (f.exception() for f in done if f.exception()), None
            )
            if err is not None:
                # fail fast: queued builds are cancelled; an already-running
                # build finishes in the background into its own staging dir
                # (builders have no cancellation point) but its result is
                # discarded
                raise err
            results = [f.result() for f in done]
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        for idxs, out in results:
            for i in idxs:
                prepared.groups[i].run.artifact = out.artifact_path
                artifacts[prepared.groups[i].id] = out.artifact_path
            log(f"build artifact: {out.artifact_path}")

        task.composition = prepared.to_dict()
        return {"artifacts": artifacts, "composition": prepared.to_dict()}

    def build_purge(self, plan: str) -> int:
        """Delete cached build artifacts for a plan (reference
        api.Engine.DoBuildPurge / builder.Purge, pkg/api/engine.go:49-76).
        Staged build dirs record their owning plan in ``.testground_plan``."""
        purged = 0
        work = self.env.dirs.work
        if not work.exists():
            return 0
        import shutil

        for d in work.iterdir():
            marker = d / ".testground_plan"
            if d.is_dir() and marker.exists() and marker.read_text().strip() == plan:
                shutil.rmtree(d, ignore_errors=True)
                if not d.exists():
                    purged += 1
        # builders with their own artifact stores (docker images) purge
        # those too (reference Builder.Purge, api/builder.go:14-26)
        for b in self.builders.values():
            purge = getattr(b, "purge", None)
            if callable(purge):
                try:
                    purged += int(purge(plan) or 0)
                except Exception:  # noqa: BLE001 — purge is best-effort
                    pass
        return purged

    # ----------------------------------------------------------------- run

    def _do_run(self, task: Task, log, kill: threading.Event) -> dict:
        comp = Composition.from_dict(task.composition)
        sources_dir = (task.input or {}).get("sources_dir")
        pdir, manifest = self._resolve_plan(comp.global_.plan, sources_dir)

        # Build any group that is missing an artifact
        # (reference supervisor.go:495-518).
        need_build = [g.id for g in comp.groups if not g.run.artifact]
        if need_build:
            log(f"groups missing artifacts, building first: {need_build}")
            self._do_build(task, log)
            comp = Composition.from_dict(task.composition)

        prepared = comp.prepare_for_run(manifest)
        runner_name = prepared.global_.runner
        runner = get_runner(runner_name)

        # Config precedence: composition run_config > env.toml runner config
        # (reference supervisor.go:553-579).
        run_config = (
            CoalescedConfig()
            .append(self.env.runners.get(runner_name, {}))
            .append(prepared.global_.run_config)
            .coalesce()
        )

        run_id = task.id
        run_dir = (
            self.env.dirs.outputs / prepared.global_.plan / run_id
        )
        run_dir.mkdir(parents=True, exist_ok=True)

        groups = [
            RunGroup(
                id=g.id,
                instances=g.calculated_instance_count,
                artifact_path=g.run.artifact,
                parameters=dict(g.run.test_params),
                resources=g.resources,
                profiles=dict(g.run.profiles),
            )
            for g in prepared.groups
        ]
        rinput = RunInput(
            run_id=run_id,
            env_config=self.env,
            run_dir=str(run_dir),
            test_plan=prepared.global_.plan,
            test_case=prepared.global_.case,
            total_instances=prepared.global_.total_instances,
            groups=groups,
            composition=prepared,
            manifest=manifest,
            plan_dir=str(pdir),
            disable_metrics=prepared.global_.disable_metrics,
            run_config=run_config,
            # a [sweep] composition stays ONE task: the sim:jax runner
            # expands it into a single scenario-batched program instead
            # of the engine queueing N near-identical runs
            sweep=prepared.sweep,
            # the [faults] schedule rides the same way: sim:jax compiles
            # it into schedule tensors inside the one batched program
            faults=prepared.faults,
            # and the [trace] table: sim:jax records per-lane event
            # rings in state and demuxes them to trace.json post-run
            trace=prepared.trace,
            # and the [telemetry] table: sim:jax samples time-series
            # buffers in state and demuxes them into results.out series
            telemetry=prepared.telemetry,
            # and the [search] table: sim:jax drives rounds of scenario
            # batches through one compiled program to locate the
            # breaking point (sim/search.py) — still ONE engine task
            search=prepared.search,
            # and the [live] table: sim:jax streams chunk-boundary
            # progress snapshots to <run_dir>/progress.jsonl; each one
            # is mirrored into the task store so /progress and the
            # /live dashboard can watch the run mid-flight
            live=prepared.live,
            on_progress=self._progress_mirror(task),
            # and the [checkpoint] table: host-only chunk-boundary state
            # snapshots (sim/checkpoint.py) — ON by default, so a crash
            # or preemption costs one chunk, not the run
            checkpoint=prepared.checkpoint,
            # and the [replay] table: sim:jax compiles the recorded
            # workload trace into per-lane schedule tensors — real
            # traffic shapes as sweepable scenarios (sim/replay.py)
            replay=prepared.replay,
            # resume request: set by `testground run --resume`, the
            # queue's daemon-restart auto-resume of interrupted tasks,
            # and the wedged-dispatch retry path
            resume=bool((task.input or {}).get("resume")),
            attempt=task.attempts,
            # federation routing digest (set at queue time, rides to
            # the executor-cache entries + worker heartbeats)
            affinity=(task.input or {}).get("affinity", "") or "",
        )
        log(
            f"starting run {run_id}: plan={rinput.test_plan} "
            f"case={rinput.test_case} instances={rinput.total_instances} "
            f"runner={runner_name}"
            + (
                f" sweep={prepared.sweep.total_scenarios()} scenarios"
                if prepared.sweep is not None
                else ""
            )
            + (
                f" faults={len(prepared.faults.events)} events"
                if prepared.faults is not None
                else ""
            )
            + (
                " trace=on"
                if prepared.trace is not None and prepared.trace.enabled
                else ""
            )
            + (
                f" telemetry=interval:{prepared.telemetry.interval}"
                if prepared.telemetry is not None
                and prepared.telemetry.enabled
                else ""
            )
            + (
                f" search={prepared.search.strategy}"
                f" over {prepared.search.param}"
                if prepared.search is not None and prepared.search.enabled
                else ""
            )
            + (
                " live=off"
                if prepared.live is not None and not prepared.live.enabled
                else ""
            )
            + (
                f" replay={prepared.replay.trace}"
                if prepared.replay is not None and prepared.replay.enabled
                else ""
            )
        )
        out = runner.run(rinput, ow=log, device=self.device)
        log(f"run finished: outcome={out.result.outcome} "
            f"outcomes={ {k: (v.ok, v.total) for k, v in out.result.outcomes.items()} }")
        result = {"run_id": run_id, **out.result.to_dict()}
        if task.routed_to and isinstance(result.get("journal"), dict):
            # federation: the run journal records which worker executed
            # it (the coordinator's routing decision, auditable per run)
            result["journal"]["routed_to"] = task.routed_to
        return result

    def _do_prewarm(self, task: Task, log) -> dict:
        """PREWARM task: resolve + build like a run, then hand the
        prepared input to the runner's ``prewarm``, which builds and
        captures the executor into the in-memory pool WITHOUT running
        it, so the composition's next run on this engine captures
        nothing (``executor_cache: memory_hit``, ``compiles: 0``)."""
        comp = Composition.from_dict(task.composition)
        sources_dir = (task.input or {}).get("sources_dir")
        pdir, manifest = self._resolve_plan(comp.global_.plan, sources_dir)
        need_build = [g.id for g in comp.groups if not g.run.artifact]
        if need_build:
            log(f"groups missing artifacts, building first: {need_build}")
            self._do_build(task, log)
            comp = Composition.from_dict(task.composition)
        prepared = comp.prepare_for_run(manifest)
        runner = get_runner(prepared.global_.runner)
        run_config = (
            CoalescedConfig()
            .append(self.env.runners.get(prepared.global_.runner, {}))
            .append(prepared.global_.run_config)
            .coalesce()
        )
        groups = [
            RunGroup(
                id=g.id,
                instances=g.calculated_instance_count,
                artifact_path=g.run.artifact,
                parameters=dict(g.run.test_params),
                resources=g.resources,
                profiles=dict(g.run.profiles),
            )
            for g in prepared.groups
        ]
        rinput = RunInput(
            run_id=task.id,
            env_config=self.env,
            run_dir=str(
                self.env.dirs.outputs / prepared.global_.plan / task.id
            ),
            test_plan=prepared.global_.plan,
            test_case=prepared.global_.case,
            total_instances=prepared.global_.total_instances,
            groups=groups,
            composition=prepared,
            manifest=manifest,
            plan_dir=str(pdir),
            run_config=run_config,
            # the full table set rides along so the prewarmed
            # executor's cache key is EXACTLY the later run's
            sweep=prepared.sweep,
            faults=prepared.faults,
            trace=prepared.trace,
            telemetry=prepared.telemetry,
            search=prepared.search,
            live=prepared.live,
            checkpoint=prepared.checkpoint,
            replay=prepared.replay,
            affinity=(task.input or {}).get("affinity", ""),
        )
        log(
            f"prewarming {task.id}: plan={rinput.test_plan} "
            f"case={rinput.test_case} instances={rinput.total_instances}"
        )
        out = runner.prewarm(rinput, ow=log, device=self.device)
        result = {"run_id": task.id, **out.result.to_dict()}
        if task.routed_to and isinstance(result.get("journal"), dict):
            result["journal"]["routed_to"] = task.routed_to
        return result

    def _progress_mirror(self, task: Task):
        """The live plane's task-store hook: each snapshot the sim:jax
        runner streams lands on the task row, so task listings and the
        /live dashboard show progress without reading the outputs tree.
        Best-effort — a storage hiccup must never fail the run."""

        def mirror(snap: dict) -> None:
            task.progress = snap
            try:
                self.storage.put(task)
            except Exception:  # noqa: BLE001 — observer plane only
                pass

        return mirror

    # ------------------------------------------------------------ mgmt api

    def executor_cache_info(self) -> dict:
        """The serving plane's cache state (GET /cache, the dashboard
        cache table, ``cache ls --endpoint``) under the JAX engine's
        keys: the disk tier off (no directory, no entries, its counters
        0), then, once a run has imported the runner, the in-memory
        pool's counters and occupancy and the live device leases."""
        info = disk_tier_info()
        sim_runner = sys.modules.get(_SIM_RUNNER)
        if sim_runner is not None:
            info["memory"] = sim_runner.executor_cache_stats()
        sim_leases = sys.modules.get(_SIM_LEASES)
        if sim_leases is not None:
            info["leases"] = sim_leases.LEASES.active()
        return info

    def executor_cache_purge(self, key: Optional[str] = None) -> int:
        """Drop disk-tier entries: none, with the tier off (the JAX
        engine's answer with ``TG_EXECUTOR_CACHE_DIR=off``)."""
        return 0

    def get_task(self, task_id: str) -> Optional[Task]:
        return self.storage.get(task_id)

    def tasks(self, states: Optional[list[str]] = None, limit: int = 0) -> list[Task]:
        if states:
            return self.storage.by_state(*states, limit=limit)
        out = self.storage.all()
        out.sort(key=lambda t: t.created, reverse=True)
        return out[:limit] if limit else out

    def resume_task(self, task_id: str) -> str:
        """Requeue an interrupted run task with a resume request
        (``run --resume <task_id>``): the sim runner continues it from
        its last checkpoint, with the outputs of an uninterrupted run
        (docs/robustness.md)."""
        t = self.storage.get(task_id)
        if t is None:
            raise EngineError(f"no such task: {task_id}")
        if t.type != TYPE_RUN:
            raise EngineError(
                f"only run tasks can be resumed (task {task_id} is a "
                f"{t.type})"
            )
        if t.state == STATE_PROCESSING:
            raise EngineError(
                f"task {task_id} is still processing — kill it first, "
                "or wait for it to finish"
            )
        if t.state == STATE_SCHEDULED:
            return task_id  # already queued (auto-resume got it first)
        if t.state == STATE_COMPLETE and t.outcome == "success":
            # nothing to resume — the run finished (possibly via the
            # boot-time auto-resume racing this request); re-running a
            # successful task would only redo completed work
            return task_id
        t.input = {**(t.input or {}), "resume": True}
        t.error = ""
        t.transition(STATE_SCHEDULED)
        self.queue.push(t)
        _M_RESUMES.inc()
        return task_id

    def preempt_all(self) -> int:
        """Flag every in-flight sim run for preemption: each stops at
        its next chunk boundary with a forced final checkpoint and
        outcome ``preempted`` + a resume token. If no sim task ever ran
        in this process there is nothing to preempt."""
        sim_runner = sys.modules.get(_SIM_RUNNER)
        if sim_runner is None:
            return 0
        return sim_runner.preempt_all_runs()

    def install_preemption_handler(self, on_idle=None) -> bool:
        """Install a SIGTERM handler (main thread only) that preempts
        in-flight runs instead of dropping them mid-chunk: a preempted
        machine or a drained node costs one chunk, not one study.
        Chains any previously-installed handler. ``on_idle`` is the
        caller's shutdown hook (the daemon passes its HTTP server's
        shutdown): it fires from a helper thread once every flagged run
        has stopped at its exit boundary — or after
        ``TG_PREEMPT_GRACE_S`` (default 30 s) regardless — so
        ``systemctl stop``/``docker stop`` still terminates the
        process, just one checkpointed chunk later. Without ``on_idle``
        (the CLI: its wait loop returns once the run lands as
        ``preempted``) the handler only flags. Returns False when not
        on the main thread (daemon worker threads cannot install signal
        handlers)."""
        import signal

        prev = signal.getsignal(signal.SIGTERM)

        def _idle_after_grace():
            # the flagged runs clear their termination flags at run
            # exit — once drained (or the grace cap passes), hand
            # control to the caller's shutdown hook
            grace = self._retry_env("TG_PREEMPT_GRACE_S", 30.0)
            deadline = time.monotonic() + grace
            sim_runner = sys.modules.get(_SIM_RUNNER)
            while time.monotonic() < deadline:
                if sim_runner is None or not sim_runner._TERM_FLAGS:
                    break
                time.sleep(0.1)
            on_idle()

        def _handler(signum, frame):
            n = self.preempt_all()
            if n:
                print(
                    f"SIGTERM: preempting {n} in-flight run(s) — each "
                    "stops at its next chunk boundary with a final "
                    "checkpoint",
                    flush=True,
                )
            if callable(prev):
                prev(signum, frame)
            if on_idle is not None:
                threading.Thread(
                    target=_idle_after_grace, daemon=True
                ).start()

        try:
            signal.signal(signal.SIGTERM, _handler)
            return True
        except ValueError:  # not the main thread
            return False

    def kill(self, task_id: str) -> bool:
        """Cancel a scheduled task, or flag + terminate a processing one
        (reference engine.go:419-427)."""
        if self.queue.cancel(task_id):
            return True
        flag = self._kill_flags.get(task_id)
        if flag is not None:
            flag.set()
            # scope termination to this task's run (run_id == task id)
            for r in self.runners.values():
                if hasattr(r, "terminate_run"):
                    r.terminate_run(task_id)
            return True
        return False

    def terminate(self, runner_name: Optional[str]) -> int:
        n = 0
        for name, r in self.runners.items():
            if runner_name in (None, name) and hasattr(r, "terminate_all"):
                try:
                    n += r.terminate_all()
                except Exception as e:  # noqa: BLE001
                    # an ALL-runner sweep must not die on one runner's
                    # missing substrate CLI (docker/kubectl absent);
                    # an explicitly-named runner still raises
                    if runner_name is not None:
                        raise
                    print(
                        f"WARNING: terminate skipped {name}: {e}",
                        file=sys.stderr,
                    )
        return n

    def task_log_path(self, task_id: str) -> Path:
        return self.env.dirs.daemon / f"{task_id}.out"

    def logs(self, task_id: str) -> str:
        p = self.task_log_path(task_id)
        return p.read_text() if p.exists() else ""

    def wait(self, task_id: str, timeout: float = 300.0) -> Task:
        """Convenience: block until the task completes."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            t = self.storage.get(task_id)
            if t is not None and t.state in (STATE_COMPLETE, STATE_CANCELED):
                return t
            time.sleep(0.05)
        raise TimeoutError(f"task {task_id} did not complete in {timeout}s")

    def close(self) -> None:
        _OBS.unregister_collector(self._collect_queue_metrics)
        self._stop.set()
        self.queue.close()
        for t in self._workers:
            t.join(timeout=2)
