"""Engine: the orchestration core (counterpart of
``testground_tpu.engine``; reference pkg/engine/).

Owns the component registries, the persistent task queue and the worker
pool; executes build, run and prewarm tasks (reference engine.go:73-125
construction, supervisor.go:47-190 worker loop, :298-492 doBuild,
:494-627 doRun).
"""

from .engine import Engine, EngineError

__all__ = ["Engine", "EngineError"]
