"""Device leases (testground_tpu_torch/sim/leases.py) against the JAX
package's registry (testground_tpu/sim/leases.py), case for case: a
fitting pair is admitted together, an unfitting one waits for the
release, runs on other devices never wait, a footprint that never fits
is admitted at once, a timeout is journaled ``overcommitted``, a kill
flag ends the wait, and a release is idempotent. Then through the
port's runner: the plain path's journal carries ``lease``, a run waits
for a lease that leaves it no room and goes on at its release, a killed
run stops waiting, and the lease is released when the run raises."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import threading
import time

import pytest
from _runner_parity import REPO, _env, run_port, summary

from testground_tpu.sim import leases as jleases
from testground_tpu_torch.api.contracts import RunGroup, RunInput
from testground_tpu_torch.sim import core as tcore
from testground_tpu_torch.sim import leases as tleases
from testground_tpu_torch.sim import runner as trunner

REGISTRIES = {"jax": jleases.DeviceLeaseRegistry,
              "port": tleases.DeviceLeaseRegistry}


@pytest.fixture(params=sorted(REGISTRIES))
def reg(request):
    return REGISTRIES[request.param](budget_fn=lambda: 100)


def _record(rec):
    """A lease record without its wall figures."""
    return {k: v for k, v in rec.items() if k != "waited_s"}


def test_registries_journal_the_same_record():
    recs = []
    for make in REGISTRIES.values():
        r = make(budget_fn=lambda: 100)
        r.acquire("a", ["0"], 40)
        recs.append(_record(r.acquire("b", ["0"], 40)))
    assert recs[0] == recs[1] == {
        "devices": ["0"], "bytes_per_device": 40,
        "hbm_budget_bytes_per_device": 100, "concurrent_runs": 1}


def test_fitting_runs_are_admitted_together(reg):
    r1 = reg.acquire("a", ["0"], 40)
    r2 = reg.acquire("b", ["0"], 40)
    assert r1["waited_s"] < 0.5 and r2["waited_s"] < 0.5
    assert r2["concurrent_runs"] == 1 and "overcommitted" not in r2
    reg.release("a")
    reg.release("b")
    assert reg.active() == {}


def test_unfitting_run_waits_for_the_release(reg):
    reg.acquire("big", ["0"], 80)
    got = {}

    def second():
        got["rec"] = reg.acquire("late", ["0"], 80, wait_timeout_s=30)

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.3)
    assert "rec" not in got  # still waiting for room
    reg.release("big")
    t.join(timeout=10)
    assert got["rec"]["waited_s"] >= 0.25
    assert "overcommitted" not in got["rec"]
    reg.release("late")


def test_other_devices_never_wait(reg):
    reg.acquire("a", ["0"], 80)
    assert reg.acquire("b", ["1"], 80)["waited_s"] < 0.5


def test_footprint_that_never_fits_is_admitted_at_once(reg):
    assert reg.acquire("huge", ["0"], 150)["waited_s"] < 0.5


def test_timeout_is_journaled_overcommitted(reg):
    reg.acquire("holder", ["0"], 80)
    rec = reg.acquire("late", ["0"], 80, wait_timeout_s=0.3)
    assert rec.get("overcommitted") is True and rec["waited_s"] >= 0.25


def test_kill_flag_ends_the_wait(reg):
    reg.acquire("holder", ["0"], 80)
    killed = threading.Event()
    got = {}

    def second():
        got["rec"] = reg.acquire("late", ["0"], 80, wait_timeout_s=60,
                                 should_stop=killed.is_set)

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.2)
    assert "rec" not in got
    killed.set()
    t.join(timeout=10)
    assert got["rec"]["waited_s"] < 10


def test_release_is_idempotent_and_supersedes(reg):
    reg.acquire("a", ["0"], 10)
    reg.acquire("a", ["0"], 30)  # a retried run replaces its lease
    assert reg.active()["a"]["bytes_per_device"] == 30
    reg.release("a")
    reg.release("a")
    assert reg.active() == {}


# ---------------------------------------------------- through the runner


def _placebo(run_dir, run_id, case="metrics", run_config=None):
    return RunInput(
        run_id=run_id, env_config=None, run_dir=str(run_dir),
        test_plan="placebo", test_case=case, total_instances=3,
        groups=[RunGroup(id="single", instances=3,
                         artifact_path=str(REPO / "plans" / "placebo"))],
        run_config=dict(run_config or {}))


@pytest.fixture
def budget(monkeypatch):
    """The runner's registry with a budget of 1,000,000 bytes."""
    monkeypatch.setattr(tleases.LEASES, "_budget_fn", lambda: 1_000_000)
    yield tleases.LEASES
    assert tleases.LEASES.active() == {}


def _footprint(tmp_path) -> int:
    out = run_port(_placebo(tmp_path / "probe", "probe"))
    return out.result.journal["lease"]["bytes_per_device"]


def test_plain_run_journals_its_lease(tmp_path, budget):
    out = run_port(_placebo(tmp_path / "r", "r"))
    lease = summary(tmp_path / "r")["lease"]
    assert lease == out.result.journal["lease"]
    assert lease["devices"] == ["cpu"] and lease["concurrent_runs"] == 0
    assert lease["bytes_per_device"] == out.result.journal[
        "hbm_preflight"]["state_model_bytes_per_device"] > 0
    # no run id: no lease
    ri = _placebo(tmp_path / "anon", "")
    assert "lease" not in run_port(ri).result.journal


def test_runs_that_fit_together_run_concurrently(tmp_path, budget):
    need = _footprint(tmp_path)
    budget.acquire("other", ["cpu"], 1_000_000 - need)
    try:
        lease = run_port(_placebo(tmp_path / "r", "r")).result.journal[
            "lease"]
    finally:
        budget.release("other")
    assert lease["concurrent_runs"] == 1 and lease["waited_s"] < 0.5


def test_run_waits_for_room_then_runs(tmp_path, budget):
    need = _footprint(tmp_path)
    budget.acquire("other", ["cpu"], 1_000_000 - need + 1)
    got = {}
    t = threading.Thread(target=lambda: got.update(
        out=run_port(_placebo(tmp_path / "r", "r"))))
    t.start()
    time.sleep(0.5)
    assert "out" not in got  # waiting at admission
    budget.release("other")
    t.join(timeout=120)
    lease = got["out"].result.journal["lease"]
    assert got["out"].result.outcome == "success"
    assert lease["waited_s"] >= 0.4 and "overcommitted" not in lease


def test_lease_wait_times_out_overcommitted(tmp_path, budget):
    need = _footprint(tmp_path)
    budget.acquire("other", ["cpu"], 1_000_000 - need + 1)
    try:
        with _env(TG_LEASE_WAIT_S="0.3"):
            out = run_port(_placebo(tmp_path / "r", "r"))
    finally:
        budget.release("other")
    assert out.result.journal["lease"]["overcommitted"] is True


def test_killed_run_stops_waiting(tmp_path, budget):
    # the whole budget held: any run waits
    budget.acquire("other", ["cpu"], 1_000_000)
    got = {}
    ri = _placebo(tmp_path / "r", "killed", case="stall",
                  run_config={"max_ticks": 5_000, "chunk_ticks": 100,
                              "event_skip": False})
    t = threading.Thread(target=lambda: got.update(out=run_port(ri)))
    t.start()
    time.sleep(0.5)
    assert "out" not in got
    trunner.request_terminate("killed")
    t.join(timeout=120)
    budget.release("other")
    assert got["out"].result.outcome == "terminated"
    assert 0.4 <= got["out"].result.journal["lease"]["waited_s"] < 30


def test_lease_released_when_the_run_raises(tmp_path, budget,
                                            monkeypatch):
    def boom(self):
        raise RuntimeError("warmup failed")

    monkeypatch.setattr(tcore.SimExecutable, "warmup", boom)
    with pytest.raises(RuntimeError, match="warmup failed"):
        run_port(_placebo(tmp_path / "r", "r"))
    assert budget.active() == {}
