"""Compositions, manifests and the runner's input and output types
(counterpart of ``testground_tpu.api``)."""

from ..sim.tables import CompositionError
from .composition import Checkpoint, Composition, Global, Group, Instances, Live
from .contracts import GroupOutcome, RunGroup, RunInput, RunOutput, RunResult
from .manifest import TestPlanManifest

__all__ = [
    "Checkpoint", "Composition", "CompositionError", "Global", "Group",
    "GroupOutcome", "Instances", "Live", "RunGroup", "RunInput",
    "RunOutput", "RunResult", "TestPlanManifest",
]
