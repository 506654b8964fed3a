"""The election plan of the port (testground_tpu_torch/plans/election.py)
against the JAX package's (plans/election/sim.py), on the CPU, under the
composition's own [replay] and [faults] tables
(plans/election/composition.toml): at its 5 instances, dense and with
event skip, and at the manifest's largest count, 1,024, with the sized
timeout and run length. Every state leaf equal, the case grades PASS,
and the port's copies of the composition and of the recorded trace
match the originals."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import importlib.util
import tomllib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _plane_parity import assert_planes_equal
from _storm_parity import assert_leaves_equal

from testground_tpu.api import Faults as JFaults
from testground_tpu.api import Replay as JReplay
from testground_tpu.parallel import instance_mesh
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_program as j_compile
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.plans import election as te

REPO = Path(__file__).resolve().parent.parent
PLAN = REPO / "plans" / "election"


def _jax_quorum():
    spec = importlib.util.spec_from_file_location("election_reference",
                                                  PLAN / "sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.testcases["quorum"]


def _composition():
    with open(PLAN / "composition.toml", "rb") as f:
        return tomllib.load(f)


def _manifest():
    with open(PLAN / "manifest.toml", "rb") as f:
        return tomllib.load(f)


def test_port_copy_of_the_composition():
    comp = _composition()
    mine = te.COMPOSITION
    assert mine["total_instances"] == comp["global"]["total_instances"]
    assert mine["groups"] == tuple(
        (g["id"], g["instances"]["count"]) for g in comp["groups"])
    assert mine["test_params"] == comp["global"]["run"]["test_params"]
    assert mine["replay"] == comp["replay"]
    assert mine["faults"] == comp["faults"]


def test_port_copy_of_the_trace():
    assert Path(te.REPLAY_TRACE).read_bytes() == \
        (PLAN / "replay.jsonl").read_bytes()


def test_group_sizes_keep_the_composition_split():
    assert te.group_sizes(5) == (3, 2)
    big = max(tc["instances"]["max"] for tc in _manifest()["testcases"])
    assert big == 1024 and te.SIZED_PARAMS.keys() == {big}
    maj, mino = te.group_sizes(big)
    assert maj + mino == big and maj >= big // 2 + 1 > mino


def _jax_run(n, event_skip, params):
    sizes = te.group_sizes(n)
    ctx = JCtx([JGroup(g, i, c, dict(params)) for i, ((g, _), c)
                in enumerate(zip(te.COMPOSITION["groups"], sizes))],
               test_case="quorum", test_run="election")
    cfg = JConfig(quantum_ms=1.0, chunk_ticks=250, max_ticks=5_000,
                  metrics_capacity=8, event_skip=event_skip)
    ex = j_compile(_jax_quorum(), ctx, cfg,
                   mesh=instance_mesh(jax.devices()[:1]),
                   faults=JFaults.from_dict(te.COMPOSITION["faults"]),
                   replay=JReplay(trace=str(PLAN / "replay.jsonl")))
    return ex, ex.run()


def _outcome(g):
    return {k: g[k] for k in te.JAX_OUTCOMES[5]}


@pytest.mark.parametrize("event_skip", [False, True])
def test_election_5_matches_jax_and_grades_pass(event_skip):
    params = te.COMPOSITION["test_params"]
    jex, jr = _jax_run(5, event_skip, params)
    tex = te.election_executable(5, "cpu", event_skip=event_skip)
    tr = tex.run()
    assert_planes_equal((jex, jr), (tex, tr))
    g = te.grade(tr, 5)
    assert g["pass"] and _outcome(g) == te.JAX_OUTCOMES[5]
    assert g["min_changes"] >= int(params["min_leader_changes"])
    assert g["leaders"] == [0]  # the healed cluster agrees on node 0
    assert g["restarts"] == 1
    # 22 recorded arrivals, all consumed; lane 0's restart begins its
    # memory afresh, so the served counts need not sum to 22
    assert g["consumed"] == 22 and g["served"] <= 22
    assert g["served"] == int(np.asarray(
        jr.state["mem"]["requests_served"]).sum())
    assert tex.replay.journal()["events"] == 22
    assert tex.replay.journal()["churn_events"] == 2
    # the realized timeline holds both planes: the [faults] partition
    # and the replayed kill/restart, as in the JAX package
    assert tex.faults.timeline == jex.faults.timeline
    kinds = {(e.get("kind"), e.get("source")) for e in tex.faults.timeline}
    assert ("partition", None) in kinds and ("kill", "replay") in kinds


def test_election_1024_sized_params_grade_pass_as_in_jax():
    n = 1024
    params = dict(te.COMPOSITION["test_params"], **te.SIZED_PARAMS[n])
    jex, jr = _jax_run(n, True, params)
    tex = te.election_executable(n, "cpu")
    tr = tex.run()
    assert_leaves_equal(jr.state, tr.state)
    assert tr.ticks == jr.ticks
    g = te.grade(tr, n)
    assert g["pass"] and g["min_changes"] >= 2
    assert _outcome(g) == te.JAX_OUTCOMES[n]
    assert g["consumed"] == 22 and g["restarts"] == 1
    # the composition's own 30 ms timeout never sees the 513-node quorum
    assert int(te.COMPOSITION["test_params"]["hb_timeout_ms"]) < n // 2


def test_election_executable_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        te.election_executable(5)
