"""The port's health checks (counterpart of the sim runner's checks in
``testground_tpu/healthcheck/checks.py``):

- ``home-directory-layout``: ``$TESTGROUND_HOME``'s directories (fixed by
  creating them);
- ``cuda-backend``: the card is visible, and the three kernels build
  from ``csrc/`` and load;
- ``device-memory``: the card's free memory (``torch.cuda.mem_get_info``);
- ``plans-loadable``: every plan the port carries imports and has test
  cases.
"""

from __future__ import annotations

import importlib
import os
import pkgutil
from pathlib import Path
from typing import Optional

from . import Check

KERNELS = ("deliver_front", "ring_merge", "count_scatter")


def home_dir(home: Optional[str] = None) -> Path:
    """``$TESTGROUND_HOME``, or ``~/testground``."""
    return Path(home or os.environ.get("TESTGROUND_HOME")
                or Path.home() / "testground")


def home_dirs(home: Optional[str] = None) -> dict:
    h = home_dir(home)
    return {"plans": h / "plans", "sdks": h / "sdks",
            "work": h / "data" / "work", "outputs": h / "data" / "outputs",
            "daemon": h / "data" / "daemon"}


def default_checks(home: Optional[str] = None) -> list[Check]:
    dirs = home_dirs(home)

    def dirs_check():
        missing = [str(p) for p in dirs.values() if not p.is_dir()]
        return (not missing, f"missing: {missing}" if missing
                else "all present")

    def dirs_fix():
        for p in dirs.values():
            p.mkdir(parents=True, exist_ok=True)
        return "created directory layout"

    def cuda_check():
        import torch

        if not torch.cuda.is_available():
            return False, "torch.cuda.is_available() is False"
        name = torch.cuda.get_device_name(0)
        for k in KERNELS:
            importlib.import_module(
                f"{__package__.rsplit('.', 1)[0]}.kernels.{k}").library()
        return True, f"{torch.cuda.device_count()} device(s): {name}; " \
            f"kernels {', '.join(KERNELS)} built and loaded"

    def memory_check():
        import torch

        if not torch.cuda.is_available():
            return False, "no CUDA device"
        free, total = torch.cuda.mem_get_info(0)
        if free / total < 0.05:
            return False, f"device memory nearly full: {free}/{total} " \
                "bytes free"
        return True, f"{free}/{total} bytes free"

    def plans_check():
        from .. import plans

        bad, names = [], []
        for info in pkgutil.iter_modules(plans.__path__):
            try:
                mod = importlib.import_module(
                    f"{plans.__name__}.{info.name}")
                if not isinstance(getattr(mod, "testcases", None), dict):
                    bad.append(f"{info.name}: no testcases")
                else:
                    names.append(info.name)
            except Exception as e:  # noqa: BLE001
                bad.append(f"{info.name}: {e}")
        return (not bad, "; ".join(bad) if bad
                else f"{len(names)} plans loadable: {', '.join(names)}")

    return [
        Check("home-directory-layout", dirs_check, dirs_fix),
        Check("cuda-backend", cuda_check),
        Check("device-memory", memory_check),
        Check("plans-loadable", plans_check),
    ]
