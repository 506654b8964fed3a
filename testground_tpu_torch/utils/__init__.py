"""Host-side helpers (counterpart of ``testground_tpu.utils``)."""
