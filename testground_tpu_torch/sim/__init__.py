"""The port's simulation engine (counterpart of ``testground_tpu.sim``)."""

from .context import BuildContext, GroupSpec
from .core import SimConfig, SimExecutable, SimResult, compile_program
from .program import PhaseCtrl, ProgramBuilder, TickEnv

__all__ = [
    "BuildContext",
    "GroupSpec",
    "PhaseCtrl",
    "ProgramBuilder",
    "SimConfig",
    "SimExecutable",
    "SimResult",
    "TickEnv",
    "compile_program",
]
