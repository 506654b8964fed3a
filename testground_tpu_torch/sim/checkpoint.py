"""The durability plane: checkpoints at chunk boundaries, resume, and
the dispatch watchdog (host side).

Counterpart of ``testground_tpu/sim/checkpoint.py``. At a chunk
boundary ``SimExecutable.run`` (and ``SweepExecutable.run``) hands the
(post-drain) state to a :class:`Checkpointer`, which writes it as host
numpy leaves (sim/state_io.py) with the host planes' watermarks (the
live sink's seq and byte offset, the drain's cursors and stream offsets)
into ``<run_dir>/checkpoint/``::

    meta.json          version, program-key and composition digests, kind,
                       seq, chunk, tick, the sweep's persisted chunk
                       finals, host watermarks (written atomically at
                       every save)
    state-<seq>.pkl    the boundary state; the last two are kept, so a
                       crash while writing always leaves one loadable
                       snapshot
    chunkfinal-<c>.pkl a sweep's completed scenario chunk ``c``: a resume
                       at a later chunk demuxes it from here
    driver.pkl         a search's driver, saved at every round (the
                       rounds re-initialize the device state, so the
                       driver is the whole state)

Everything the tick reads rides in the state (keys, rings, cursors,
fault tensors), so a resumed run continues bit for bit: its
``results.out``, ``trace.jsonl`` and ``trace.json`` equal an
uninterrupted run's. A resume whose program-key digest differs from the
checkpoint's raises :class:`CheckpointError`.

:class:`DispatchWatchdog` judges each chunk's wall time against
``max(TG_DISPATCH_TIMEOUT_S, TG_DISPATCH_FACTOR x rolling p95)`` and
raises :class:`WedgedDispatchError` past it; while a chunk runs it can
emit ``kind: "dispatching"`` heartbeat rows.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np

from .state_io import state_to_numpy


def _host_tree(st):
    """A state of tensors or of numpy leaves as numpy leaves."""
    if isinstance(st, dict):
        return {k: _host_tree(v) for k, v in st.items()}
    return st if isinstance(st, np.ndarray) else state_to_numpy(st)

CKPT_DIR = "checkpoint"
_META = "meta.json"
_VERSION = 1


class CheckpointError(RuntimeError):
    """A resume was refused (another program) or a checkpoint cannot be
    used (a drained stream it names is gone or shorter)."""


class WedgedDispatchError(RuntimeError):
    """A chunk took longer than the watchdog's budget."""


# --------------------------------------------------------------- digests


def key_digest(key: str) -> str:
    """Digest of the runner's executor-pool key: the program identity a
    checkpoint belongs to."""
    return hashlib.sha256(key.encode()).hexdigest()[:32]


# host-only tables: retuning them between the legs of a resume changes
# no state
_HOST_ONLY_TABLES = ("live", "checkpoint")


def composition_digest(comp: Any) -> str:
    """Digest of the composition's dict form without its host-only
    tables; empty without a composition."""
    if comp is None:
        return ""
    d = comp.to_dict() if hasattr(comp, "to_dict") else comp
    if not isinstance(d, dict):
        return ""
    d = {k: v for k, v in d.items() if k not in _HOST_ONLY_TABLES}
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, default=str).encode()
    ).hexdigest()[:32]


# ----------------------------------------------------- composition table


def checkpoint_table(rinput):
    """The [checkpoint] table as api.composition.Checkpoint; a default
    one (on, every 60 s) when absent."""
    from ..api.composition import Checkpoint

    ck = getattr(rinput, "checkpoint", None)
    if ck is None:
        return Checkpoint()
    if isinstance(ck, dict):
        ck = Checkpoint.from_dict(ck)
    return ck


def checkpoint_disabled(rinput) -> bool:
    """True when the [checkpoint] table is marked disabled
    (``--no-checkpoint``)."""
    ck = getattr(rinput, "checkpoint", None)
    if ck is None:
        return False
    if isinstance(ck, dict):
        return not ck.get("enabled", True)
    return not getattr(ck, "enabled", True)


# ------------------------------------------------------- atomic file I/O


def _atomic_write(path, data: bytes) -> None:
    """Write to a temporary file beside ``path``, then rename: a crash
    leaves the old file or the new one, never a torn one."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path, obj) -> None:
    """``obj`` as indented JSON, written atomically (the checkpoint's
    meta and the runner's ``sim_summary.json``)."""
    _atomic_write(path, json.dumps(obj, indent=2, default=str).encode())


# ---------------------------------------------------------- checkpointer


class Checkpointer:
    """Boundary snapshots for one run.

    ``boundary(st, force=...)`` is called at every chunk boundary but
    the last; saves are rate-limited by ``interval_s`` (0: every
    boundary) unless forced (a stop: the final snapshot of a preempted
    run). The state is read back only when a save happens.
    ``search_round(r, driver)`` saves a search's driver after round
    ``r``. ``on_first_save`` runs once, after the first snapshot
    lands."""

    def __init__(
        self,
        run_dir,
        *,
        key_hash: str,
        comp_hash: str = "",
        kind: str = "run",
        interval_s: float = 60.0,
        log=None,
        on_first_save=None,
        start_seq: int = 0,
        clock=time.monotonic,
    ) -> None:
        self.dir = Path(run_dir) / CKPT_DIR
        self.key_hash = key_hash
        self.comp_hash = comp_hash
        self.kind = kind
        self.interval_s = float(interval_s)
        self.log = log or (lambda msg: None)
        self.on_first_save = on_first_save
        self._clock = clock
        self._last = clock()
        self.seq = start_seq
        self.snapshots = 0
        self._finals_written: set = set()
        self.sink = None
        self.drain = None
        self._search_round: Optional[int] = None
        if start_seq == 0 and self.dir.exists():
            # a fresh run into a used run_dir drops the old snapshots
            shutil.rmtree(self.dir, ignore_errors=True)
        if start_seq > 0:
            # resuming: the first leg's chunk finals are on disk already
            self._finals_written = {
                int(p.stem.split("-")[1])
                for p in self.dir.glob("chunkfinal-*.pkl")
            }

    def attach(self, sink=None, drain=None) -> None:
        """The host planes whose watermarks ride every snapshot."""
        self.sink = sink
        self.drain = drain

    def _host_watermarks(self) -> dict:
        host: dict = {}
        if self.sink is not None:
            host["live_seq"] = self.sink.seq
            try:
                host["live_bytes"] = self.sink.path.stat().st_size
            except OSError:
                pass
        if self.drain is not None:
            host["drain"] = self.drain.snapshot()
        if self._search_round is not None:
            host["search_round"] = self._search_round
        return host

    def _meta(self, seq: int, chunk: int, tick: int) -> dict:
        return {
            "version": _VERSION,
            "key_hash": self.key_hash,
            "comp_hash": self.comp_hash,
            "kind": self.kind,
            "seq": seq,
            "chunk": chunk,
            "tick": tick,
            "updated": time.time(),
            "snapshots": self.snapshots + 1,
            "finals": sorted(self._finals_written),
            "host": self._host_watermarks(),
        }

    def _saved(self) -> None:
        """After a snapshot landed: the first-save hook, then the crash
        injection of ``TG_CKPT_CRASH_AFTER``."""
        if self.snapshots == 1 and self.on_first_save is not None:
            try:
                self.on_first_save()
            finally:
                self.on_first_save = None
        _maybe_crash_after(self.snapshots, self.log)

    def boundary(self, st, *, chunk: Optional[int] = None, finals=None,
                 force: bool = False) -> bool:
        """Snapshot one boundary; False when rate-limited or the write
        failed (a full disk degrades durability, not the run). ``chunk``
        is a sweep's scenario-chunk index, ``finals`` its completed
        chunks' final states: those not yet on disk are written with
        this snapshot, so a resume at chunk ``c`` can demux every chunk
        before ``c``."""
        now = self._clock()
        if not force and (now - self._last) < self.interval_s:
            return False
        self._last = now
        host_state = _host_tree(st)
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            for ci, final in enumerate(finals or ()):
                if ci in self._finals_written or final is None:
                    continue
                _atomic_write(self.dir / f"chunkfinal-{ci}.pkl",
                              pickle.dumps(_host_tree(final)))
                self._finals_written.add(ci)
            seq = self.seq
            _atomic_write(self.dir / f"state-{seq}.pkl",
                          pickle.dumps(host_state))
            atomic_write_json(self.dir / _META, self._meta(
                seq, int(chunk or 0),
                int(np.asarray(host_state["tick"]).max())))
            for p in self.dir.glob("state-*.pkl"):
                try:
                    if int(p.stem.split("-")[1]) < seq - 1:
                        p.unlink()
                except (ValueError, OSError):
                    pass
            self.seq = seq + 1
            self.snapshots += 1
        except OSError as e:
            self.log(f"WARNING: checkpoint save failed: {e}")
            return False
        self._saved()
        return True

    def search_round(self, r: int, driver) -> None:
        """A search's checkpoint after round ``r``: the driver (grid,
        bracket, probes, rounds) is the whole state, so a resumed search
        replays from round ``r + 1``."""
        self._search_round = int(r)
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            _atomic_write(self.dir / "driver.pkl", pickle.dumps(driver))
            atomic_write_json(self.dir / _META, self._meta(self.seq, 0, 0))
            self.seq += 1
            self.snapshots += 1
        except OSError as e:
            self.log(f"WARNING: search-round checkpoint failed: {e}")
            return
        self._saved()

    def journal(self) -> dict:
        """The journal's ``checkpoint`` record."""
        return {"snapshots": self.snapshots, "interval_s": self.interval_s,
                "dir": str(self.dir)}


def _maybe_crash_after(snapshots: int, log) -> None:
    """Crash injection for the durability tests and drills:
    ``TG_CKPT_CRASH_AFTER=N`` SIGKILLs the process just after the N-th
    checkpoint save, the kill -9 a resume must survive."""
    raw = os.environ.get("TG_CKPT_CRASH_AFTER", "")
    try:
        n = int(raw) if raw else 0
    except ValueError:
        return
    if snapshots >= n > 0:
        log(f"TG_CKPT_CRASH_AFTER={n}: injecting kill -9 now")
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------- resume


class ResumePoint:
    """A loaded checkpoint: the boundary state (host numpy leaves; None
    for a search's) and the host watermarks."""

    def __init__(self, dir_: Path, meta: dict, state) -> None:
        self.dir = Path(dir_)
        self.meta = meta
        self.state = state

    @property
    def seq(self) -> int:
        return int(self.meta.get("seq", 0))

    @property
    def chunk(self) -> int:
        return int(self.meta.get("chunk", 0))

    @property
    def tick(self) -> int:
        return int(self.meta.get("tick", 0))

    @property
    def kind(self) -> str:
        return str(self.meta.get("kind", "run"))

    @property
    def host(self) -> dict:
        return dict(self.meta.get("host") or {})

    def verify(self, key_hash: str, comp_hash: str = "") -> None:
        """Refuse to resume another program."""
        if self.meta.get("key_hash") != key_hash:
            raise CheckpointError(
                f"resume refused: the checkpoint in {self.dir} was "
                "written by a different program (executor-cache key "
                "digest mismatch — the plan, its params, or an observer "
                "table changed). Run fresh, or restore the original "
                "composition."
            )
        stored = self.meta.get("comp_hash", "")
        if comp_hash and stored and stored != comp_hash:
            raise CheckpointError(
                "resume refused: the composition changed since the "
                f"checkpoint in {self.dir} was written (composition "
                "digest mismatch)."
            )

    def load_final(self, ci: int):
        """A sweep's completed chunk ``ci``: its final state as host
        numpy leaves."""
        p = self.dir / f"chunkfinal-{ci}.pkl"
        try:
            return pickle.loads(p.read_bytes())
        except (OSError, pickle.UnpicklingError, EOFError) as e:
            raise CheckpointError(
                f"checkpoint chunk final {p.name} unreadable: {e}") from e

    def load_driver(self):
        """A search's checkpointed driver, or None when this is not a
        search checkpoint."""
        p = self.dir / "driver.pkl"
        if not p.exists():
            return None
        try:
            return pickle.loads(p.read_bytes())
        except (OSError, pickle.UnpicklingError, EOFError) as e:
            raise CheckpointError(
                f"checkpoint driver state unreadable: {e}") from e


def load_checkpoint(run_dir, log=None) -> Optional[ResumePoint]:
    """The newest usable checkpoint under ``<run_dir>/checkpoint/``, or
    None. A torn newest snapshot falls back to the one before it, unless
    the run drains (its stream offsets belong to the newest): then None.
    Call :meth:`ResumePoint.verify` before using the state."""
    log = log or (lambda msg: None)
    d = Path(run_dir) / CKPT_DIR
    mpath = d / _META
    if not mpath.exists():
        return None
    try:
        meta = json.loads(mpath.read_text())
    except (OSError, json.JSONDecodeError) as e:
        log(f"WARNING: checkpoint meta unreadable ({e}) — running fresh")
        return None
    if meta.get("version") != _VERSION:
        log("WARNING: checkpoint version mismatch — running fresh")
        return None
    if meta.get("kind") == "search":
        # no state: the driver is a search's state
        return ResumePoint(d, meta, None)
    seq = int(meta.get("seq", 0))
    for s in (seq, seq - 1):
        p = d / f"state-{s}.pkl"
        if not p.exists():
            continue
        try:
            state = pickle.loads(p.read_bytes())
        except (OSError, pickle.UnpicklingError, EOFError) as e:
            log(f"WARNING: checkpoint {p.name} corrupt ({e}) — trying the "
                "previous snapshot")
            continue
        if s != seq:
            meta = dict(meta)
            meta["seq"] = s
            meta["tick"] = int(np.asarray(state["tick"]).max())
            if (meta.get("host") or {}).get("drain"):
                log("WARNING: newest checkpoint corrupt and the run drains "
                    "observer streams — the fallback snapshot cannot "
                    "restore stream offsets; running fresh")
                return None
        return ResumePoint(d, meta, state)
    log("WARNING: no loadable checkpoint state — running fresh")
    return None


# ---------------------------------------------------------- the watchdog


class DispatchWatchdog:
    """Judges chunk wall times against the run's own rhythm: the budget
    is ``max(floor_s, factor x p95)`` over the last ``window`` chunks;
    ``observe`` raises :class:`WedgedDispatchError` past it. A chunk that
    never returns is beyond any Python watchdog."""

    def __init__(self, *, floor_s: float = 120.0, factor: float = 8.0,
                 window: int = 32, log=None) -> None:
        self.floor_s = float(floor_s)
        self.factor = float(factor)
        self.window = int(window)
        self.log = log or (lambda msg: None)
        self._times: list[float] = []
        self.boundaries = 0
        self.fired = False
        self._hb_emit = None
        self._hb_interval = 5.0
        self._hb_armed_at: Optional[float] = None
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None

    @classmethod
    def from_env(cls, log=None) -> Optional["DispatchWatchdog"]:
        """The runner's watchdog: floor ``TG_DISPATCH_TIMEOUT_S``
        (default 120; 0 or ``off`` disables it), factor
        ``TG_DISPATCH_FACTOR`` (default 8)."""
        raw = os.environ.get("TG_DISPATCH_TIMEOUT_S", "")
        if raw.lower() in ("off", "disable"):
            return None
        try:
            floor = float(raw) if raw else 120.0
        except ValueError:
            floor = 120.0
        if floor <= 0:
            return None
        try:
            factor = float(os.environ.get("TG_DISPATCH_FACTOR", "") or 8.0)
        except ValueError:
            factor = 8.0
        return cls(floor_s=floor, factor=factor, log=log)

    # ------------------------------------------------- dispatch heartbeat

    def attach_heartbeat(self, emit, interval_s: float = 5.0) -> None:
        """While a chunk runs (between ``begin`` and ``end``), call
        ``emit({"kind": "dispatching", "dispatch_s", "budget_s"})`` at
        most every ``interval_s``; beats stop past the budget."""
        self.detach_heartbeat()
        self._hb_emit = emit
        self._hb_interval = max(0.1, float(interval_s))
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True)
        self._hb_thread.start()

    def detach_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=1.0)
        self._hb_emit = None
        self._hb_stop = None
        self._hb_thread = None

    def begin(self) -> None:
        self._hb_armed_at = time.monotonic()

    def end(self) -> None:
        self._hb_armed_at = None

    def _hb_loop(self) -> None:
        stop = self._hb_stop
        last_beat = None
        while stop is not None and not stop.wait(0.1):
            armed_at = self._hb_armed_at
            if armed_at is None:
                last_beat = None
                continue
            now = time.monotonic()
            ref = last_beat if last_beat is not None else armed_at
            if now - ref < self._hb_interval:
                continue
            budget = self.budget_s()
            if now - armed_at > budget:
                continue
            last_beat = now
            emit = self._hb_emit
            if emit is None:
                continue
            try:
                emit({"kind": "dispatching",
                      "dispatch_s": round(now - armed_at, 3),
                      "budget_s": round(budget, 3)})
            except Exception:  # noqa: BLE001 — the heartbeat is advisory
                pass

    # ------------------------------------------------------------ budget

    def _p95(self) -> float:
        if not self._times:
            return 0.0
        xs = sorted(self._times)
        return xs[min(len(xs) - 1, int(0.95 * (len(xs) - 1) + 0.5))]

    def budget_s(self) -> float:
        return max(self.floor_s, self.factor * self._p95())

    def observe(self, dt: float) -> None:
        """Record one chunk's wall time; raises past the budget."""
        self.boundaries += 1
        budget = self.budget_s()
        dt = float(dt)
        if dt > budget:
            self.fired = True
            raise WedgedDispatchError(
                f"chunk dispatch wedged: {dt:.2f}s exceeded the watchdog "
                f"budget {budget:.2f}s (rolling p95 {self._p95():.2f}s × "
                f"{self.factor:g}, floor {self.floor_s:g}s over "
                f"{len(self._times)} chunks)"
            )
        self._times.append(dt)
        if len(self._times) > self.window:
            del self._times[0]
