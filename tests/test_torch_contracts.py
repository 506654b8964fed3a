"""The port's build ladder (testground_tpu_torch/tools/compile_ladder.py)
and contract checker (testground_tpu_torch/tools/check_contracts.py) on
the CPU: each combo's ``ops`` within tools/op_budgets.json (the
counterpart of tests/test_fused_deliver.py's ``TestHLOBudgets``); every
combo enabling the planes the JAX ladder's does; the ``all`` combo's run,
fused and unfused, equal to the JAX ladder's ``build_combo`` run (state
leaves, trace events, Chrome trace, telemetry records);
``check_contracts --cpu`` exiting 0 with every ported contract PASS and
the two it does not port named, and a broken contract failing it. (The
new entry points' refusal without a card is in
tests/test_torch_benchmarks.py.)"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import subprocess
import sys

import pytest
from _plane_parity import assert_planes_equal
from _storm_parity import REPO

from testground_tpu_torch.tools import check_contracts, compile_ladder

if str(REPO) not in sys.path:  # tools/ is a plain directory, not a package
    sys.path.insert(0, str(REPO))

from tools import compile_ladder as jladder  # noqa: E402


@pytest.mark.parametrize("combo", compile_ladder.COMBOS)
def test_combo_ops_within_recorded_budget(combo):
    budgets = compile_ladder.load_budgets()["ops"]
    ops = compile_ladder.loop_ops(combo)
    assert ops <= budgets["budgets"][combo], (combo, ops)
    assert budgets["budgets"][combo] <= 1.06 * budgets["measured"][combo]


def test_ladder_combos_enable_the_jax_ladders_planes():
    assert compile_ladder.COMBOS == jladder.COMBOS
    for combo in compile_ladder.COMBOS:
        j = jladder.build_combo(combo, single_device=True)
        t = compile_ladder.build_combo(combo, device="cpu")
        planes = ("faults", "trace", "telemetry")
        assert ([getattr(t, k) is not None for k in planes]
                == [getattr(j, k) is not None for k in planes]), combo


@pytest.mark.parametrize("fused", [True, False])
def test_all_planes_combo_matches_jax(fused):
    jex = jladder.build_combo("all", fused_observers=fused,
                              single_device=True)
    tex = compile_ladder.build_combo("all", fused_observers=fused,
                                     device="cpu")
    (_, jr), (_, tr) = (jex, jex.run()), (tex, tex.run())
    assert assert_planes_equal((jex, jr), (tex, tr)) > 0
    assert tr.trace_events_total() > 0 and tr.telemetry_samples() > 0


def test_check_contracts_cpu_passes_with_two_not_ported():
    out = subprocess.run(
        [sys.executable, "-m", "testground_tpu_torch.tools.check_contracts",
         "--cpu"], capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "zero-overhead contracts (n=8, device cpu):"
    rows = {ln.split()[0]: ln.split()[1] for ln in lines[1:-1]}
    names = [name for name, _ in check_contracts.CONTRACTS]
    assert list(rows) == names
    assert {k for k, v in rows.items() if v == "NOT"} == {"warmstart",
                                                         "prewarm"}
    assert {v for k, v in rows.items() if v != "NOT"} == {"PASS"}
    assert "NOT PORTED (11.3)" in lines[names.index("warmstart") + 1]
    assert "NOT PORTED (11.3)" in lines[names.index("prewarm") + 1]
    assert lines[-1] == (
        "10/10 ported contracts hold; 2 not ported (warmstart: 11.3, "
        "prewarm: 11.3), counted neither as holding nor as failing")


def test_a_broken_contract_fails_the_checker(monkeypatch, capsys):
    """A plane whose off form changes the loop: its row FAILs and the
    exit code is 1."""
    real = check_contracts._compile

    def compile_(n, device, **tables):
        ex = real(n, device, **tables)
        if "trace" in tables:
            tick = ex.tick_fn()
            ex._tick_fn = lambda st: dict(tick(st), tick=tick(st)["tick"])
        return ex

    monkeypatch.setattr(check_contracts, "_compile", compile_)
    assert check_contracts.main(["--cpu", "-n", "4"]) == 1
    out = capsys.readouterr().out
    assert "  trace-off      FAIL" in out
    assert "  telemetry-off  PASS" in out
    assert "9/10 ported contracts hold — 1 BROKEN" in out
