"""The NUTS cell ``grid10_nuts`` (kind ``nuts_moments``): whole runs of its
small copy on the CPU, its planted faults and its control, its two
metrics, K3's frozen bound, and the cell on the card."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import types

import pytest

from portbench import control_nuts, faults_nuts, roofline, roofline_nuts, run
from portbench.registry import CHECKOUT, Registry

CELL = "grid10_nuts"


def small_run(small, bench, trace=0, seed=3_000_000_001):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], registry=small, bench=bench,
                  device="cpu", require_card=False, out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(small, bench, trace):
    result = small_run(small, bench, trace)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"
    want = {"compile_s", "step_mfu.nuts"} if trace else {"setup_s"}
    assert set(result["metrics"]) >= want


def test_the_kind_counts_the_programs_leaves(small, monkeypatch):
    """A query's work carries the leaves the program counted; a program
    without the counter (the parent of the counter) gives None, and both
    metrics then read nothing."""
    from lhvi_tpu_torch.engines import nuts
    from lhvi_tpu_torch.utils import metrics

    cfg = small.json("configs", "gauss_grid10")
    mix = small.json("traffic", "nuts_c65536")
    kind = small.module("traffic", "nuts_moments")
    ref = small.module("reference", "gauss_grid10")
    fg = small.module("models", "gauss_grid10").build(
        cfg, ref.make_inputs(cfg, 1), "cpu")["fg"]
    small_mix = dict(mix, n_warmup=3, n_samples=4)
    _, work = kind.query(fg, small_mix, run.generator("cpu", 1, 2))
    assert work["transitions"] == 7 and work["samples"] == 4 * mix["n_chains"]
    assert 7 * mix["n_chains"] <= work["leaves"] <= 7 * 15 * mix["n_chains"]

    real = nuts.count
    monkeypatch.setattr(nuts, "count", lambda name, n=1: (
        None if name == "nuts.leaves" else real(name, n)))
    monkeypatch.delitem(metrics._COUNTS, "nuts.leaves")
    _, work = kind.query(fg, small_mix, run.generator("cpu", 1, 2))
    assert work["leaves"] is None
    c = types.SimpleNamespace(
        cfg=cfg, mix=mix, queries=[work],
        trace=dict(busy_s=1.0, window_s=1.0, n_kernels=10),
        untraced=dict(queries=[work], seconds=1.0))
    for name in ("nuts_roofline", "step_mfu.nuts"):
        assert Registry().module("metrics", name).read(c) is None


@pytest.mark.parametrize("fault", faults_nuts.FAULTS)
def test_a_planted_fault_is_not_correct(small, bench, fault):
    with faults_nuts.plant(fault):
        result = small_run(small, bench)
    assert not result["correct"]


def test_the_bfloat16_control_is_not_correct(small, bench, capsys):
    """The reference in the program's place, in bfloat16, reads above the
    small cell's limits; in float32 below them."""
    limits = small.json("workloads", CELL)["limits"]
    worst = {}
    for mode in ("control", "control32"):
        control_nuts.main(["--workload", CELL, "--seeds", "5,6", "--mode",
                           mode], registry=small, bench=bench, device="cpu")
        worst[mode] = json.loads(capsys.readouterr().out.splitlines()[-1])[
            "worst"]
    assert any(worst["control"][k] > limits[k] for k in limits)
    assert all(worst["control32"][k] <= limits[k] for k in limits)


def test_control_nuts_refuses_other_kinds(small, bench):
    with pytest.raises(KeyError):
        control_nuts.main(["--workload", "grid128_hmc", "--seeds", "1"],
                          registry=small, bench=bench, device="cpu")


def test_k3_bound_at_the_cells_shape():
    """K3's least time at the cell's shape, 65,536 chains × 82 latents with
    every tree at depth 4 (15 leaves a chain): 0.2279 ms, bound by its
    operations."""
    C, n, leaves = 65536, 82, 15 * 65536
    n_bytes = roofline_nuts.transition_bytes(C, n)
    flops = roofline_nuts.trajectory_flops(C, n, leaves)
    assert n_bytes == (3 * C * n + n * n + 2 * n) * 4
    assert flops == C * (2 * n * n + 7 * n) + leaves * (2 * n * n + 14 * n)
    assert flops / roofline.F32_FLOPS_PER_S > (n_bytes
                                               / roofline.HBM_BYTES_PER_S)
    assert round(1e3 * roofline.bound_s(n_bytes, flops), 4) == 0.2279
    assert roofline_nuts.least_s(C, n, 1, leaves) == roofline.bound_s(
        n_bytes, flops)


def test_nuts_roofline_and_mfu_arithmetic():
    cfg = dict(n_latent=82)
    mix = dict(n_chains=1024, n_warmup=200, n_samples=200, stream_diag=True)
    qs = [dict(wall_s=0.5, transitions=400, samples=204800,
               leaves=400 * 1024 * 7)] * 2
    least = roofline_nuts.least_s(1024, 82, 800, 2 * 400 * 1024 * 7)
    c = types.SimpleNamespace(
        cfg=cfg, mix=mix, queries=qs,
        trace=dict(busy_s=20 * least, window_s=1.0, n_kernels=100),
        untraced=dict(queries=qs, seconds=0.8))
    reg = Registry()
    assert reg.module("metrics", "nuts_roofline").read(c) == pytest.approx(5)
    n, C = 82, 1024
    query = (400 * C * (2 * n * n + 7 * n) + 400 * C * 7 * (2 * n * n + 14 * n)
             + 400 * C * n + 200 * 4 * C * n + 200 * C * n * 12)
    assert roofline_nuts.query_flops(C, n, 200, 200, 400 * C * 7, True) \
        == query
    assert reg.module("metrics", "step_mfu.nuts").read(c) == pytest.approx(
        100 * 2 * query / (0.8 * roofline.F32_FLOPS_PER_S))


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """One short traced run of the cell, started as the benchmark's command
    starts it: correct, and both new metrics read."""
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "3", "--trace", "1"], cwd=CHECKOUT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"nuts_roofline", "step_mfu.nuts"} <= set(result["metrics"])
