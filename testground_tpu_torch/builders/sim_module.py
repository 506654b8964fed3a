"""The ``sim:module`` builder (counterpart of ``SimModuleBuilder`` in
``testground_tpu/build/python_builders.py``): the plan's sources staged
into a content- and config-addressed directory under the work dir, the
artifact a run's groups carry. The JAX builder also byte-compiles the
staged ``sim.py``; the port never runs a plan directory's ``sim.py`` (it
runs its own copy of the plan, ``testground_tpu_torch.plans``), so it
stages and checks the entry and compiles nothing."""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from pathlib import Path

from ..api.contracts import BuildInput, BuildOutput
from .registry import register


class BuildError(RuntimeError):
    pass


def _stage_sources(source_dir: Path, work_root: Path, key: str) -> Path:
    """Copy plan sources into a content+config-addressed directory so
    identical builds are reused (the reference dedups via BuildKey and
    image caching, pkg/engine/supervisor.go:359-364)."""
    digest = hashlib.sha256(key.encode())
    for p in sorted(source_dir.rglob("*")):
        if p.is_file() and not p.name.endswith(".pyc"):
            digest.update(str(p.relative_to(source_dir)).encode())
            digest.update(p.read_bytes())
    dest = work_root / digest.hexdigest()[:16]
    if dest.exists():
        return dest
    # each build stages into its own directory, so two workers building
    # the same digest at once never share one; the loser of the rename
    # finds ``dest`` made and takes it as a hit
    tmp = Path(tempfile.mkdtemp(dir=work_root, prefix=dest.name + "."))
    try:
        shutil.copytree(
            source_dir, tmp, dirs_exist_ok=True,
            ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
        try:
            os.rename(tmp, dest)
        except OSError:
            if not dest.is_dir():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dest


class SimModuleBuilder:
    """Stages a sim plan; artifact = the staged directory's path."""

    name = "sim:module"
    sim_entry = "sim.py"

    def build(self, binput: BuildInput) -> BuildOutput:
        src = Path(binput.source_dir)
        if not (src / self.sim_entry).exists():
            raise BuildError(
                f"plan has no {self.sim_entry} (required by sim:jax): {src}")
        work_root = Path(binput.env_config.dirs.work)
        work_root.mkdir(parents=True, exist_ok=True)
        staged = _stage_sources(src, work_root,
                                binput.select_build.build_key())
        # the owning plan, so `build purge` finds this artifact
        plan = (binput.composition.global_.plan if binput.composition
                else src.name)
        (staged / ".testground_plan").write_text(plan + "\n")
        return BuildOutput(artifact_path=str(staged))


register(SimModuleBuilder.name, SimModuleBuilder())
