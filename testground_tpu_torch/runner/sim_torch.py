"""The sim runner on the card: a whole composition as one torch program
(counterpart of ``testground_tpu/runner/sim_jax.py``). It runs the
compositions that name ``runner = "sim:jax"`` unchanged, as that
runner's counterpart, and adds no runner name."""

from __future__ import annotations

from ..api.composition import SIM_RUNNER
from ..api.contracts import RunInput, RunOutput
from .registry import register


class SimTorchRunner:
    name = SIM_RUNNER

    def run(self, rinput: RunInput, ow=None, device="cuda") -> RunOutput:
        from ..sim.runner import run_composition

        return run_composition(rinput, ow=ow, device=device)

    def prewarm(self, rinput: RunInput, ow=None,
                device="cuda") -> RunOutput:
        """Build and capture the composition's executor into the pool
        without running it."""
        from ..sim.runner import prewarm_composition

        return prewarm_composition(rinput, ow=ow, device=device)

    def healthcheck(self, fix: bool = False, runner_config=None):
        """The port's checks (``runner_config``, the runner's env.toml
        section, configures none of them)."""
        from ..healthcheck import run_checks
        from ..healthcheck.checks import default_checks

        return run_checks(default_checks(), fix=fix)

    def terminate_run(self, run_id: str) -> None:
        """Stop the run at its next chunk boundary (outcome
        ``terminated``, the streamed prefix kept)."""
        from ..sim.runner import request_terminate

        request_terminate(run_id)

    def terminate_all(self) -> int:
        """Instances stopped outright: none (a run stops at its chunk
        boundary through ``terminate_run``), as the JAX runner answers."""
        return 0

    def collect_outputs(self, run_dir: str, writer) -> None:
        """A tar.gz of the run's outputs into ``writer``."""
        from .outputs import tar_outputs

        tar_outputs(run_dir, writer)


register(SimTorchRunner.name, SimTorchRunner())
