"""The port's builders (counterpart of ``testground_tpu.build``): one,
``sim:module``, which stages a plan's sources for the sim runner.

The package is named ``builders`` and not ``build`` because
``testground_tpu_torch/build/`` is where the CUDA kernels are compiled
(``kernels/build.py``), a directory ``.gitignore`` lists: a ``build``
package would be left out of every commit.

The host builders of the JAX package (``exec:python``, ``exec:generic``,
``docker:*``) build plans for the host runners, which the port does not
carry; a composition naming one gets the engine's ``unknown builder``
error."""

from .registry import all_builders, get_builder
from .sim_module import BuildError, SimModuleBuilder

__all__ = ["BuildError", "SimModuleBuilder", "all_builders", "get_builder"]
