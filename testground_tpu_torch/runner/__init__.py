"""The port's runners (counterpart of ``testground_tpu.runner``): one,
``SimTorchRunner``, registered under the name the repo's compositions
give (``sim:jax``), whose counterpart it is."""

from .registry import all_runners, get_runner, register
from .sim_torch import SimTorchRunner

__all__ = ["SimTorchRunner", "all_runners", "get_runner", "register"]
