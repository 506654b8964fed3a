"""nvcc build of a ``csrc/*.cu`` source into a shared library with a
plain C interface, loaded with ctypes.

The library name carries a hash of the source, so an edited source is
rebuilt and a stale build is never loaded. The build goes through a
temporary file and an atomic rename."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from testground_tpu_torch/csrc at first use"
    )


def library_path(name: str, defines: tuple = ()) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for d in defines:
        h.update(d.encode())
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD / f"lib{name}{tag}-{h.hexdigest()[:12]}.so"


def build(name: str, defines: tuple = ()) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``)
    unless its library exists; returns the library path and the seconds
    spent compiling (0.0 when cached)."""
    out = library_path(name, defines)
    if out.exists():
        return out, 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *(f"-D{d}" for d in defines),
        "-o", tmp, str(CSRC / f"{name}.cu"),
    ]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    (BUILD / f"{out.stem}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    return out, seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


def check(t, name, dtype, shape, device) -> int:
    """A launch argument's pointer, after checking that it is a
    contiguous tensor of ``dtype`` and ``shape`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()
