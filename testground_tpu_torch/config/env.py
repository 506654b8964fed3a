"""``$TESTGROUND_HOME`` layout and ``.env.toml`` loading (a copy of
``testground_tpu/config/env.py``; reference pkg/config/env.go:11-59,
dirs.go:5-31).

The port reads every key the JAX package reads. The ``[daemon]`` keys of
what the port has not ported raise naming the ROADMAP item instead of
being ignored: ``peers``, ``advertise`` and ``executor_cache_shared_dir``
(federation, item 11.5b), an ``executor_cache_dir`` other than ``off``
(the disk tier, item 11.3; the port keeps executors in memory only) and an
``executor_pool`` above 1 (the port pools one executor a key).

Directory layout (same as the reference):
  $TESTGROUND_HOME/
    plans/         test plans (each a dir with manifest.toml)
    sdks/          linked SDKs
    data/work      builder work dirs
    data/outputs   collected run outputs
    data/daemon    task logs + task database
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import tomllib

ENV_HOME_VAR = "TESTGROUND_HOME"
DEFAULT_LISTEN_ADDR = "localhost:8042"


@dataclass
class Directories:
    home: Path

    @property
    def plans(self) -> Path:
        return self.home / "plans"

    @property
    def sdks(self) -> Path:
        return self.home / "sdks"

    @property
    def work(self) -> Path:
        return self.home / "data" / "work"

    @property
    def outputs(self) -> Path:
        return self.home / "data" / "outputs"

    @property
    def daemon(self) -> Path:
        return self.home / "data" / "daemon"

    def ensure(self) -> None:
        for p in (self.plans, self.sdks, self.work, self.outputs, self.daemon):
            p.mkdir(parents=True, exist_ok=True)


@dataclass
class DaemonConfig:
    listen: str = DEFAULT_LISTEN_ADDR
    scheduler_workers: int = 2
    task_timeout_min: float = 10
    task_repo_type: str = "disk"  # disk | memory
    tokens: list[str] = field(default_factory=list)  # bearer auth tokens
    # status hooks (reference supervisor.go:192-296)
    github_repo_status_token: str = ""
    slack_webhook_url: str = ""
    # serving plane (sim/excache.py + sim/runner.py executor pool):
    # where the on-disk executor cache lives ("" = the
    # ~/.cache/testground/executors default, "off" disables the tier)
    # and how many executors one composition pools for concurrent runs
    # (0 = the TG_EXECUTOR_POOL_N default of 2). The engine exports
    # both to the runner's env vars at startup.
    executor_cache_dir: str = ""
    executor_pool: int = 0
    # federation plane (testground_tpu/federation/, docs/federation.md):
    # a daemon listing peers acts as COORDINATOR of those worker
    # daemons — it enrolls them, routes submitted runs by
    # cache-affinity/headroom and proxies task endpoints through.
    # `advertise` is the endpoint workers dial back for heartbeats
    # (default: the listen address — set it when workers reach the
    # coordinator through a different address). The shared executor
    # cache dir (an NFS/object-store mount all workers see) lets any
    # worker warm-start from any other worker's compile; exported to
    # the runner as TG_EXECUTOR_CACHE_SHARED_DIR.
    peers: list[str] = field(default_factory=list)
    advertise: str = ""
    executor_cache_shared_dir: str = ""


@dataclass
class AWSConfig:
    """[aws] section (reference config.AWSConfig; consumed by pkg aws/ECR)."""

    region: str = ""
    access_key_id: str = ""
    secret_access_key: str = ""


@dataclass
class DockerHubConfig:
    """[dockerhub] section (reference config.DockerHubConfig; image pushes)."""

    repo: str = ""
    username: str = ""
    access_token: str = ""


@dataclass
class ClientConfig:
    endpoint: str = f"http://{DEFAULT_LISTEN_ADDR}"
    token: str = ""


@dataclass
class EnvConfig:
    """Loaded from ``$TESTGROUND_HOME/.env.toml``; component config maps keep
    the reference's precedence contract: flags > env.toml > defaults
    (reference env-example.toml:15-22)."""

    home: Path = field(default_factory=lambda: _default_home())
    daemon: DaemonConfig = field(default_factory=DaemonConfig)
    client: ClientConfig = field(default_factory=ClientConfig)
    aws: AWSConfig = field(default_factory=AWSConfig)
    dockerhub: DockerHubConfig = field(default_factory=DockerHubConfig)
    builders: dict[str, dict[str, Any]] = field(default_factory=dict)
    runners: dict[str, dict[str, Any]] = field(default_factory=dict)

    @property
    def dirs(self) -> Directories:
        return Directories(home=self.home)

    @classmethod
    def load(cls, home: Optional[str] = None) -> "EnvConfig":
        h = Path(home or _default_home())
        cfg = cls(home=h)
        env_file = h / ".env.toml"
        if env_file.exists():
            with open(env_file, "rb") as f:
                data = tomllib.load(f)
            d = data.get("daemon", {})
            cfg.daemon = DaemonConfig(
                listen=d.get("listen", DEFAULT_LISTEN_ADDR),
                scheduler_workers=int(
                    d.get("scheduler", {}).get("workers", 2)
                    if isinstance(d.get("scheduler"), dict)
                    else d.get("workers", 2)
                ),
                task_timeout_min=float(d.get("task_timeout_min", 10)),
                task_repo_type=d.get("task_repo_type", "disk"),
                tokens=list(d.get("tokens", [])),
                github_repo_status_token=d.get("github_repo_status_token", ""),
                slack_webhook_url=d.get("slack_webhook_url", ""),
                executor_cache_dir=str(d.get("executor_cache_dir", "")),
                executor_pool=int(d.get("executor_pool", 0)),
                peers=[str(p) for p in d.get("peers", [])],
                advertise=str(d.get("advertise", "")),
                executor_cache_shared_dir=str(
                    d.get("executor_cache_shared_dir", "")
                ),
            )
            a = data.get("aws", {})
            cfg.aws = AWSConfig(
                region=a.get("region", ""),
                access_key_id=a.get("access_key_id", ""),
                secret_access_key=a.get("secret_access_key", ""),
            )
            dh = data.get("dockerhub", {})
            cfg.dockerhub = DockerHubConfig(
                repo=dh.get("repo", ""),
                username=dh.get("username", ""),
                access_token=dh.get("access_token", ""),
            )
            c = data.get("client", {})
            cfg.client = ClientConfig(
                endpoint=c.get("endpoint", f"http://{cfg.daemon.listen}"),
                token=c.get("token", ""),
            )
            cfg.builders = dict(data.get("builders", {}))
            cfg.runners = dict(data.get("runners", {}))
            _refuse_unported(cfg.daemon)
        return cfg

    def runner_disabled(self, name: str) -> bool:
        # `disabled = true` in env.toml disables a runner
        # (reference env.go:64, enforced engine/supervisor.go:566-569).
        return bool(self.runners.get(name, {}).get("disabled", False))

    def builder_disabled(self, name: str) -> bool:
        return bool(self.builders.get(name, {}).get("disabled", False))


def _default_home() -> Path:
    env = os.environ.get(ENV_HOME_VAR)
    if env:
        return Path(env)
    return Path.home() / "testground"


def _refuse_unported(d: DaemonConfig) -> None:
    """Raise for a ``[daemon]`` setting the port does not carry out."""
    from ..sim.program import _not_ported

    fed = [k for k in ("peers", "advertise", "executor_cache_shared_dir")
           if getattr(d, k)]
    if fed:
        raise _not_ported(f"[daemon] {', '.join(fed)} in .env.toml", 11,
                          "the daemon's federation (11.5b)")
    if d.executor_cache_dir and d.executor_cache_dir.lower() != "off":
        raise _not_ported(
            f"[daemon] executor_cache_dir = {d.executor_cache_dir!r} in "
            ".env.toml", 11, "the executor cache's disk tier (11.3)")
    if d.executor_pool > 1:
        raise _not_ported(
            f"[daemon] executor_pool = {d.executor_pool} in .env.toml", 11,
            "the executor cache's disk tier (11.3); the port pools one "
            "executor a key")
