"""Run-configuration merging and the ``$TESTGROUND_HOME`` environment
(counterpart of ``testground_tpu.config``)."""

from .coalescing import CoalescedConfig
from .env import ClientConfig, DaemonConfig, Directories, EnvConfig

__all__ = ["ClientConfig", "CoalescedConfig", "DaemonConfig", "Directories",
           "EnvConfig"]
