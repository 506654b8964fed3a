"""Per-chunk device profiling for the runner (host side).

Counterpart of ``testground_tpu/sim/profile.py``. The chunk boundary is
already a host read, so nothing here adds work on the device. At each
boundary the profiler adds the dispatch lap (the runner's ``dispatch``
span: the chunk's replays and the boundary's host reads) to its
aggregates, and on the card reads ``torch.cuda.max_memory_allocated``
for the memory high-water mark (the CPU reports none, as XLA's CPU
backend does not). ``journal()`` gives the run journal's
``device_profile``.

Each lap is also observed in the metrics plane's
``tg_run_chunk_seconds`` histogram (obs/).

``TG_PROFILE_DIR=/path`` arms a ``torch.profiler`` window over one chunk,
the chunk of index ``TG_PROFILE_CHUNK`` (default 1, 0-based), exported
as a Chrome trace to ``<dir>/chunk<K>/trace.json``. :func:`profiled`
wraps a whole run in such a trace when a group asks for ``profiles``.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional

import torch

from ..obs import histogram

_WARNED: dict = {}
# the metrics plane's chunk histogram, under the JAX profiler's name
_CHUNK_SECONDS = histogram(
    "tg_run_chunk_seconds",
    "Per-chunk dispatch wall seconds (device work + the boundary host "
    "sync).",
)


def env_num(name: str, default, parse=int):
    """A numeric knob from the environment (``parse``: int or float); a
    malformed value warns once and gives ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return parse(raw)
    except ValueError:
        if _WARNED.get(name) != raw:
            _WARNED[name] = raw
            print(f"WARNING: ignoring malformed {name}={raw!r} (not a "
                  f"number); using default {default}", file=sys.stderr)
        return default


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiled(out_dir, device: torch.device):
    """A ``torch.profiler`` trace of the block, exported as a Chrome
    trace to ``<out_dir>/trace.json`` (the JAX runner's ``profiles``
    counterpart)."""
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities(device)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


class ChunkProfiler:
    """``on_boundary(lap_s)`` once a chunk (through
    live.boundary_callback), ``journal()`` at the end of the run."""

    def __init__(self, *, device=None, trace_dir: str = "",
                 trace_chunk: int = 1, log=None) -> None:
        self.device = torch.device(device) if device is not None else None
        self.trace_dir = trace_dir
        self.trace_chunk = int(trace_chunk)
        self.log = log or (lambda msg: None)
        self.chunks = 0
        self.sum_s = 0.0
        self.max_s = 0.0
        self.hbm_high_water: Optional[int] = None
        self._prof = None
        self._trace_done = False

    @classmethod
    def from_env(cls, log=None, device=None) -> "ChunkProfiler":
        return cls(
            device=device,
            trace_dir=os.environ.get("TG_PROFILE_DIR", "").strip(),
            trace_chunk=max(0, env_num("TG_PROFILE_CHUNK", 1)),
            log=log,
        )

    def on_boundary(self, lap_s: float) -> None:
        """One chunk ended; ``lap_s`` is its wall lap."""
        idx = self.chunks
        self.chunks += 1
        lap = max(0.0, float(lap_s))
        self.sum_s += lap
        self.max_s = max(self.max_s, lap)
        _CHUNK_SECONDS.observe(lap)
        if self.device is not None and self.device.type == "cuda":
            peak = int(torch.cuda.max_memory_allocated(self.device))
            self.hbm_high_water = max(self.hbm_high_water or 0, peak)
        if self.trace_dir and not self._trace_done:
            self._trace_boundary(idx)

    def _trace_dir(self) -> str:
        return os.path.join(self.trace_dir, f"chunk{self.trace_chunk}")

    def _trace_boundary(self, idx: int) -> None:
        """Start the window at the boundary before the target chunk and
        stop it at the one after, so it holds exactly that chunk."""
        if self._prof is not None:
            self._stop()
            self.log(f"profiler: captured chunk {idx} trace under "
                     f"{self.trace_dir}")
            return
        if idx == max(0, self.trace_chunk - 1):
            dev = self.device or torch.device("cpu")
            self._prof = torch.profiler.profile(activities=_activities(dev))
            self._prof.__enter__()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self._trace_done = True
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self._trace_dir(), exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(self._trace_dir(), "trace.json"))
        except Exception as e:  # noqa: BLE001 — profiling is advisory
            self.log(f"WARNING: profiler trace failed: {e}")

    def close(self) -> None:
        """Stop a window still open (a run that ended on its boundary)."""
        if self._prof is not None:
            self._stop()

    def journal(self) -> Optional[dict]:
        """The journal's ``device_profile``: aggregate seconds and count,
        and the memory high-water mark on the card."""
        if self.chunks == 0:
            return None
        out = {
            "chunks": self.chunks,
            "dispatch_seconds": round(self.sum_s, 3),
            "dispatch_mean_s": round(self.sum_s / self.chunks, 4),
            "dispatch_max_s": round(self.max_s, 4),
        }
        if self.hbm_high_water is not None:
            out["hbm_high_water_bytes"] = int(self.hbm_high_water)
        if self.trace_dir:
            out["trace_dir"] = self.trace_dir
            out["trace_chunk"] = self.trace_chunk
            out["trace_captured"] = bool(self._trace_done)
        return out
