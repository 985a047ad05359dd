"""Whole runs of the small cells on the CPU (the look for a card skipped),
the faults planted underneath, and the runs on the card."""

from __future__ import annotations

import io
import json
import subprocess
import sys

import pytest

from portbench import control, faults, run
from portbench.registry import CHECKOUT

# fs320_vi is parked (tests/data/parked.json): its parts are still held to
# their faults and control here
CELLS = {"grid128_hmc": "hmc_moments", "fs320_vi": "vi_fit"}


def small_run(small, bench, cell, trace=0, seed=3_000_000_001):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], registry=small, bench=bench,
                  device="cpu", require_card=False, out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    return result, err.getvalue().strip().splitlines()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_small_run_is_correct(small, bench_parked, cell):
    result, err = small_run(small, bench_parked, cell)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) >= {"setup_s"}
    assert all(line.startswith("check ") for line in
               err[-len(result["checks"]):])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_small_traced_run(small, bench_parked, cell):
    result, _ = small_run(small, bench_parked, cell, trace=1)
    assert result["correct"]
    assert "compile_s" in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in sorted(CELLS)
    for fault in faults.FAULTS[CELLS[cell]]])
def test_a_planted_fault_is_not_correct(small, bench_parked, cell, fault):
    with faults.plant(fault, CELLS[cell]):
        result, _ = small_run(small, bench_parked, cell)
    assert not result["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_bfloat16_control_is_not_correct(small, bench_parked, cell,
                                              capsys):
    """The reference in the program's place, in bfloat16, reads above
    the cell's limits; in float32 below them."""
    limits = small.json("workloads", cell)["limits"]
    worst = {}
    for mode in ("control", "control32"):
        control.main(["--workload", cell, "--seeds", "5,6", "--mode", mode],
                     registry=small, bench=bench_parked, device="cpu")
        worst[mode] = json.loads(capsys.readouterr().out.splitlines()[-1])[
            "worst"]
    assert any(worst["control"][k] > limits[k] for k in limits)
    assert all(worst["control32"][k] <= limits[k] for k in limits)


def test_no_card_no_result(bench, monkeypatch):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", "grid128_hmc", "--seed", "1", "--seconds",
                   "1"], bench=bench, out=out, err=err)
    assert rc == run.EXIT_NO_CARD and out.getvalue() == ""


def test_forbidden_module_no_result(small, bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", "grid128_hmc", "--seed", "1", "--seconds",
                   "0.1"], registry=small, bench=bench, device="cpu",
                  require_card=False, out=out, err=err)
    assert rc == run.EXIT_FORBIDDEN and out.getvalue() == ""
    assert "jax" in err.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grid128_hmc", "grid128_hmc_wide"])
def test_cell_on_the_card(card, cell):
    """One short run of each cell as the driver starts it."""
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"], cwd=CHECKOUT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
