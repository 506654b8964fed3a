"""The port's runner registry: the runner a composition's
``[global] runner`` names."""

from __future__ import annotations

_REGISTRY: dict[str, object] = {}


def register(name: str, runner) -> None:
    _REGISTRY[name] = runner


def get_runner(name: str):
    r = _REGISTRY.get(name)
    if r is None:
        raise ValueError(f"unknown runner: {name}; have {sorted(_REGISTRY)}")
    return r


def all_runners() -> dict[str, object]:
    return dict(_REGISTRY)


def runner_healthcheck(name: str, fix: bool, env_runners: dict,
                       runners: dict = None):
    """Resolve + invoke a runner's healthcheck with its env.toml section
    (shared by the command line and the daemon; a copy of the JAX
    registry's). Raises LookupError with a user-facing message for an
    unknown runner or one with no healthcheck."""
    pool = runners if runners is not None else _REGISTRY
    r = pool.get(name)
    if r is None:
        raise LookupError(f"unknown runner: {name}; have {sorted(pool)}")
    hc = getattr(r, "healthcheck", None)
    if hc is None:
        raise LookupError(f"no healthcheck for runner: {name}")
    return hc(fix=fix, runner_config=dict(env_runners.get(name, {})))
