"""Torch transcriptions of the repo's sim plans (``plans/*/sim.py``)."""
