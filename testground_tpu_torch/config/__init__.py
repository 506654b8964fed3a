"""Run-configuration merging (counterpart of ``testground_tpu.config``)."""

from .coalescing import CoalescedConfig

__all__ = ["CoalescedConfig"]
