"""The port's counterpart of ``__graft_entry__.py``: the storm program
with the compressed dial window of ``__graft_entry__._storm_executable``
(2 s dial jitter, 32 KiB per connection), and ``entry``, one storm tick
at 64 instances."""

from __future__ import annotations

from .plans import benchmarks
from .sim import BuildContext, GroupSpec, SimConfig, compile_program

# __graft_entry__._storm_executable's params
STORM_PARAMS = {
    "conn_count": 4,
    "conn_outgoing": 4,
    "conn_delay_ms": 2_000,
    "data_size_kb": 32,
    "storm_quiet_ms": 200,
    "dial_timeout_ms": 5_000,
}
SHAPED_PARAMS = {"link_latency_ms": 30, "link_loss_pct": 2,
                 "dial_timeout_ms": 500, "dial_retries": 3}


def storm_executable(n_instances, device="cuda", quantum_ms=10.0,
                     churn_fraction=0.0, shaped=False, tolerant=False,
                     **config):
    """The storm program at ``n_instances`` with the compressed params.
    ``shaped`` adds latency and loss (deliveries ride the delay wheel,
    dials retransmit SYNs); ``tolerant`` makes the rendezvous
    churn-tolerant; ``config`` overrides SimConfig fields."""
    params = dict(STORM_PARAMS)
    if shaped:
        params.update(SHAPED_PARAMS)
    if tolerant:
        params["churn_tolerant"] = 1
    ctx = BuildContext(
        [GroupSpec("single", 0, n_instances,
                   {k: str(v) for k, v in params.items()})],
        test_case="storm",
        test_run="graft",
    )
    cfg = SimConfig(
        quantum_ms=quantum_ms,
        max_ticks=100_000,
        churn_fraction=churn_fraction,
        churn_start_ms=500.0,
        churn_end_ms=1_500.0,
        **config,
    )
    return compile_program(benchmarks.storm, ctx, cfg, device=device)


def entry(device="cuda"):
    """(tick_fn, (state,)): one storm tick at 64 instances on ``device``."""
    ex = storm_executable(64, device=device)
    return ex.tick_fn(), (ex.init_state(),)
