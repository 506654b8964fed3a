"""A run's outputs: their collection as a tar.gz of the run's tree (a
copy of ``testground_tpu/runner/outputs.py``), and the comparison of two
runs' outputs but their walls."""

from __future__ import annotations

import json
import tarfile
from pathlib import Path


def tar_outputs(run_dir: str, writer) -> None:
    """Streams a tar.gz of ``run_dir`` into ``writer`` (a binary
    file-like)."""
    root = Path(run_dir)
    with tarfile.open(fileobj=writer, mode="w|gz") as tf:
        if root.exists():
            tf.add(str(root), arcname=root.name)


# ---- comparing two runs' outputs (two devices, two packages, a run and
# its resumed twin): what a run writes but its wall clock and its device

# journal keys that are walls or the runner's own machinery, not the
# run's result
WALL_KEYS = ("wall_seconds", "compile_seconds", "compile_breakdown",
             "host_spans", "device_profile", "lease", "scenarios_per_sec")
# the pre-flight's figures of the device's memory
BUDGET_KEYS = ("hbm_budget_bytes", "hbm_admissible_bytes")
# the progress rows' wall fields
ROW_WALL_KEYS = ("wall_s", "compile_seconds", "wall_seconds",
                 "round_wall_seconds")
OUTPUT_NAMES = ("results.out", "trace.json", "trace.jsonl")


def summary(run_dir) -> dict:
    return json.loads((Path(run_dir) / "sim_summary.json").read_text())


def deterministic(summary: dict, run_dir) -> dict:
    """A summary without its wall and budget figures, the run directory
    in its paths written ``<run_dir>``."""
    s = {k: v for k, v in summary.items() if k not in WALL_KEYS}
    if isinstance(s.get("hbm_preflight"), dict):
        s["hbm_preflight"] = {k: v for k, v in s["hbm_preflight"].items()
                              if k not in BUDGET_KEYS}
    text = json.dumps(s, sort_keys=True).replace(str(run_dir), "<run_dir>")
    return json.loads(text)


def run_out_lines(run_dir) -> list:
    """run.out without the last line's wall figure."""
    lines = (Path(run_dir) / "run.out").read_text().splitlines()
    lines[-1] = lines[-1].rsplit(" wall=", 1)[0]
    return lines


def progress_rows(run_dir) -> list:
    """progress.jsonl's rows without their wall fields."""
    path = Path(run_dir) / "progress.jsonl"
    if not path.exists():
        return []
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ROW_WALL_KEYS}
            for r in rows]


def output_files(run_dir) -> dict:
    """Every results.out, trace.json and trace.jsonl under the run
    directory, by relative path, as bytes."""
    root = Path(run_dir)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.name in OUTPUT_NAMES}


def assert_runs_equal(a, b, rows=True) -> dict:
    """Everything two runs wrote equal: the summaries' deterministic
    keys, run.out but its wall figure, every results.out, trace.json and
    trace.jsonl byte for byte, and (``rows``) the progress rows but their
    walls. Returns ``b``'s summary."""
    sa, sb = summary(a), summary(b)
    da, db = deterministic(sa, a), deterministic(sb, b)
    assert db == da, (a, b, {k: (da.get(k), db.get(k))
                             for k in sorted(set(da) | set(db))
                             if da.get(k) != db.get(k)})
    assert run_out_lines(b) == run_out_lines(a), (a, b)
    fa, fb = output_files(a), output_files(b)
    assert sorted(fb) == sorted(fa), (sorted(fa), sorted(fb))
    for name in fa:
        assert fb[name] == fa[name], name
    if rows:
        assert progress_rows(b) == progress_rows(a), (a, b)
    return sb
