"""Build-stamped version info: the port's copy of the JAX package's
``testground_tpu/version/__init__.py`` (reference pkg/version/version.go).

The commit is resolved lazily: an explicit stamp (``GIT_COMMIT``, set by
packaging, or the ``TESTGROUND_GIT_COMMIT`` environment variable) wins;
otherwise git is asked once.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

from .. import __version__ as VERSION

# stamped by packaging; empty means "resolve from git"
GIT_COMMIT = ""

_resolved: str | None = None


def git_commit() -> str:
    global _resolved
    if GIT_COMMIT:
        return GIT_COMMIT
    env = os.environ.get("TESTGROUND_GIT_COMMIT")
    if env:
        return env
    if _resolved is None:
        try:
            _resolved = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=Path(__file__).resolve().parent,
                capture_output=True, text=True, timeout=5,
            ).stdout.strip() or "unknown"
        except Exception:  # noqa: BLE001 — no git, no repository
            _resolved = "unknown"
    return _resolved


def human() -> str:
    """The JAX command's ``version`` line, with the port's version."""
    return f"testground-tpu {VERSION} (commit {git_commit()})"
