"""The hybrid cell ``robot100_hmc`` (kind ``hmc_hybrid``) and the parked
dense HMC cell ``grid10_hmc`` (kind ``hmc_moments`` on ``gauss_grid10``;
its entries in ``data/parked_grid10_hmc.json``): the robot map's plain
reference against the port's model and a brute force, whole runs of both
cells' small copies on the CPU, their planted faults and their control,
the new metrics and their frozen bounds, and the cells on the card."""

from __future__ import annotations

import io
import itertools
import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import (control_hybrid, faults_hybrid, roofline,
                       roofline_dense, roofline_hybrid, run)
from portbench.registry import CHECKOUT, Registry

REG = Registry()
PARKED = CHECKOUT / "portbench" / "tests" / "data" / "parked_grid10_hmc.json"


@pytest.fixture
def bench(bench):
    """BENCHMARK.json with the parked ``grid10_hmc``: its cell and metric
    appended, and the cell added to the accepted metrics it reports."""
    parked = json.loads(PARKED.read_text())
    out = {k: v + parked.get(k, []) if isinstance(v, list) else v
           for k, v in bench.items()}
    out["end_to_end"], out["per_layer"] = [
        [dict(m, workloads=m["workloads"] + ["grid10_hmc"])
         if m["name"] in parked["also_in"] else m for m in out[k]]
        for k in ("end_to_end", "per_layer")]
    return out
CELLS = {"robot100_hmc": ("sweep_frozen", "state_unchanged", "half_unmoved",
                          "answer_altered", "diag_frozen"),
         "grid10_hmc": ("state_unchanged", "half_unmoved", "answer_altered",
                        "diag_frozen")}


def _robot(**kw):
    cfg = REG.json("configs", "robot_map100")
    return dict(cfg, **kw)


def _robot_parts(cfg, seed):
    ref = REG.module("reference", "robot_map100")
    inputs = ref.make_inputs(cfg, seed)
    return ref, inputs, REG.module("models", "robot_map100").build(
        cfg, inputs, "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_inputs_are_the_programs_scan(seed):
    """The reference draws the evidence ``robot_scan_evidence(100, seed)``
    writes, value for value, and every seed gives 97 latent types and 14
    latent depths, each depth with two observed neighbours."""
    from lhvi_tpu_torch.models.relational import robot_scan_evidence
    from lhvi_tpu_torch.relational.data import load_evidence

    cfg = _robot()
    ref = REG.module("reference", "robot_map100")
    inputs = ref.make_inputs(cfg, seed)
    text, true_types = robot_scan_evidence(100, seed)
    ev = load_evidence(text)
    mine = {("type", (f"s{i}",)): int(v) for i, v in
            zip(inputs["type_obs_idx"], inputs["type_obs_val"])}
    mine.update({("depth", (f"s{i}",)): float(v) for i, v in
                 zip(inputs["depth_obs_idx"], inputs["depth_obs_val"])})
    assert mine == ev
    assert np.array_equal(inputs["true_types"], true_types)
    assert len(ref.latent_types(cfg, inputs)) == cfg["n_latent_types"] == 97
    assert len(ref.latent_depths(cfg, inputs)) == cfg["n_latent_depths"] == 14
    a, _, _ = ref.depth_conditionals(cfg, inputs)
    assert np.allclose(a, 1 / 4 + 2 * 4.0 + 2 * 2 * 0.5)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_reference_log_density_is_the_programs(seed):
    """The reference's unnormalised log density equals the port's compiled
    ``log_prob`` up to one constant at random states (types anywhere,
    latent depths inside the domain), float32 rounding of sums of about
    300 terms apart."""
    cfg = _robot()
    ref, inputs, built = _robot_parts(cfg, seed)
    fg, lay = built["fg"], built["layout"]
    rng = np.random.default_rng(seed)
    lt, ld = ref.latent_types(cfg, inputs), ref.latent_depths(cfg, inputs)
    K, n = 8, cfg["n_segments"]
    T = np.zeros((K, n), np.int64)
    D = np.zeros((K, n))
    T[:, inputs["type_obs_idx"]] = inputs["type_obs_val"]
    D[:, inputs["depth_obs_idx"]] = inputs["depth_obs_val"]
    T[:, lt] = rng.integers(0, 3, (K, len(lt)))
    D[:, ld] = rng.uniform(-2.9, 2.9, (K, len(ld)))
    xc = torch.zeros((K, fg.n_cont))
    xd = torch.zeros((K, fg.n_disc), dtype=torch.int64)
    xc[:, lay["cont"]] = torch.as_tensor(D[:, ld], dtype=torch.float32)
    xd[:, lay["disc"]] = torch.as_tensor(T[:, lt])
    got = np.array([float(fg.log_prob(xc[k], xd[k])) for k in range(K)])
    diff = got - ref.log_density(cfg, inputs, T, D)
    assert np.ptp(diff) < 1e-3


def test_reference_marginals_equal_brute_force():
    """On an 8-segment copy (types labelled at 0, 3, 7; depths missing at 2
    and 5), every type marginal and depth moment of the reference's exact
    method equals brute-force enumeration of the 3^5 type states, each
    with the joint Gaussian over the latent depths integrated densely from
    the log density itself."""
    cfg = _robot(n_segments=8, depth_miss_every=3, n_latent_types=5,
                 n_latent_depths=2)
    ref = REG.module("reference", "robot_map100")
    inputs = ref.make_inputs(cfg, 3)
    lt, ld = ref.latent_types(cfg, inputs), ref.latent_depths(cfg, inputs)
    n, k = cfg["n_segments"], len(ld)
    base_d = np.zeros(n)
    base_d[inputs["depth_obs_idx"]] = inputs["depth_obs_val"]
    logw, mus, covs, states = [], [], [], []
    for combo in itertools.product(range(3), repeat=len(lt)):
        t = np.zeros(n, np.int64)
        t[inputs["type_obs_idx"]] = inputs["type_obs_val"]
        t[lt] = combo

        def f(y):
            d = base_d.copy()
            d[ld] = y
            return float(ref.log_density(cfg, inputs, t, d))

        f0 = f(np.zeros(k))
        E = np.eye(k)
        g = np.array([(f(E[i]) - f(-E[i])) / 2 for i in range(k)])
        H = np.array([[(f(E[i] + E[j]) - f(E[i]) - f(E[j]) + f0)
                       for j in range(k)] for i in range(k)])
        J = -H
        mean = np.linalg.solve(J, g)
        logw.append(f0 + 0.5 * g @ mean + 0.5 * k * math.log(2 * math.pi)
                    - 0.5 * np.linalg.slogdet(J)[1])
        mus.append(mean)
        covs.append(np.linalg.inv(J))
        states.append(combo)
    w = np.exp(np.array(logw) - max(logw))
    w /= w.sum()
    states = np.array(states)
    probs = np.stack([[w[states[:, i] == v].sum() for v in range(3)]
                      for i in range(len(lt))])
    mus, covs = np.array(mus), np.array(covs)
    mean = w @ mus
    var = w @ (np.diagonal(covs, axis1=1, axis2=2) + mus ** 2) - mean ** 2
    post = ref.posterior(cfg, inputs)
    np.testing.assert_allclose(post["type_probs"], probs, atol=1e-9)
    np.testing.assert_allclose(post["mean"], mean, atol=1e-9)
    np.testing.assert_allclose(post["var"], var, atol=1e-9)
    assert ref.mass_beyond(cfg, inputs) < 1e-9


def test_reference_exact_draws_meet_the_posterior():
    """The control's exact draws in float64 meet the exact answer within
    five standard errors of i.i.d. draws, and their streamed split-R-hat
    reads 1 within 0.02 over the depths and the types."""
    cfg = _robot()
    ref = REG.module("reference", "robot_map100")
    inputs = ref.make_inputs(cfg, 5)
    post = ref.posterior(cfg, inputs)
    C, S = 512, 40
    m, v, diag, probs = ref.exact_moments(cfg, inputs, C, 0, S, seed=1,
                                          dtype=torch.float64)
    N = C * S
    assert np.all(np.abs(m - post["mean"]) <= 5 * np.sqrt(post["var"] / N))
    assert np.all(np.abs(v / post["var"] - 1) <= 5 * math.sqrt(4 / N))
    p = post["type_probs"]
    assert np.all(np.abs(probs - p) <= 5 * np.sqrt(p * (1 - p) / N) + 1e-12)
    assert np.all(np.abs(diag["rhat"] - 1) < 0.02)
    assert np.all(np.abs(diag["rhat_disc"] - 1) < 0.02)


# ---- the cells' small copies on the CPU --------------------------------


def small_run(small, bench, cell, trace=0, seed=3_000_000_001):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], registry=small, bench=bench,
                  device="cpu", require_card=False, out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_parts_resolve(small, bench, cell):
    """The new cells' parts resolve through the registry, small and full,
    and each reports ``setup_s``, ``samples_per_s`` and its new roofline."""
    from portbench.registry import cell_spec

    spec = cell_spec(bench, cell)
    for reg in (REG, small):
        mix = reg.json("traffic", spec["traffic"])
        reg.module("traffic", mix["kind"])
        reg.module("judges", f"{spec['config']}.{mix['kind']}")
        reg.json("workloads", cell)
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    new = {"robot100_hmc": {"logpot_roofline", "sweep_roofline"},
           "grid10_hmc": {"dense_roofline", "query_s_p90"}}[cell]
    assert {"setup_s", "samples_per_s", "launches_per_transition",
            "device_idle.sample"} | new <= names
    assert spec["chips"] == 1


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(small, bench, cell, trace):
    result = small_run(small, bench, cell, trace)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"
    assert set(result["metrics"]) >= ({"compile_s"} if trace
                                      else {"setup_s", "samples_per_s"})


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in CELLS[c]])
def test_a_planted_fault_is_not_correct(small, bench, cell, fault):
    with faults_hybrid.plant(fault):
        result = small_run(small, bench, cell)
    assert not result["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_bfloat16_control_is_not_correct(small, bench, cell, capsys):
    """The reference in the program's place, in bfloat16, reads above the
    small cell's limits; in float32 below them."""
    limits = small.json("workloads", cell)["limits"]
    worst = {}
    for mode in ("control", "control32"):
        control_hybrid.main(["--workload", cell, "--seeds", "5,6", "--mode",
                             mode], registry=small, bench=bench,
                            device="cpu")
        worst[mode] = json.loads(capsys.readouterr().out.splitlines()[-1])[
            "worst"]
    assert any(worst["control"][k] > limits[k] for k in limits)
    assert all(worst["control32"][k] <= limits[k] for k in limits)


def test_control_hybrid_refuses_other_cells(small, bench):
    with pytest.raises(KeyError):
        control_hybrid.main(["--workload", "grid10_nuts", "--seeds", "1"],
                            registry=small, bench=bench, device="cpu")


def test_the_kind_counts_the_programs_work(small, monkeypatch):
    """A query's work carries the sweep's classes and rows and the K5
    launches the program counted (none on the CPU: the autograd route);
    on a program without the sweep's counters (the parent of the
    counters) both read None, and the metrics that read them nothing."""
    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.utils import metrics

    cfg = small.json("configs", "robot_map100")
    mix = dict(small.json("traffic", "hmc_hybrid_c65536"), n_warmup=3,
               n_samples=4)
    kind = small.module("traffic", "hmc_hybrid")
    ref = small.module("reference", "robot_map100")
    fg = small.module("models", "robot_map100").build(
        cfg, ref.make_inputs(cfg, 1), "cpu")["fg"]
    _, work = kind.query(fg, mix, run.generator("cpu", 1, 2))
    assert work["transitions"] == 7 and work["samples"] == 4 * mix["n_chains"]
    assert work["sweep_classes"] == 7 * fg.n_colors == 14
    assert work["sweep_rows"] > 7 * 3 * cfg["n_latent_types"]
    assert work["k5_launches"] in (0, None)

    monkeypatch.setattr(hmc, "count", lambda name, n=1: None)
    for name in ("hmc.sweep_classes", "hmc.sweep_rows"):
        monkeypatch.delitem(metrics._COUNTS, name)
    _, work = kind.query(fg, mix, run.generator("cpu", 1, 2))
    assert work["sweep_classes"] is None and work["sweep_rows"] is None
    c = types.SimpleNamespace(
        cfg=cfg, mix=mix, queries=[work],
        trace=dict(busy_s=1.0, window_s=1.0, n_kernels=10))
    assert Registry().module("metrics", "sweep_roofline").read(c) is None


def test_k5_bound_at_the_cells_shapes():
    """K5's least time: 0.0031 ms at robot_map(100), 16,384 chains, 8
    steps (PERF.md's table, bound by the bytes), and at the cell's 65,536
    chains; the bytes and operations as ``chip_smoke.py`` counts them."""
    C, n, rows, steps = 16384, 14, 100, 8
    n_bytes, flops = roofline_hybrid.k5_work(C, rows, n, steps)
    assert n_bytes == (4 * C * n + n + 1 + C * rows + 2 * C) * 4
    assert flops == C * ((steps + 1) * (3 * 16 * n + 2 * n * n)
                         + 16 * (rows - n)) == 179_437_568
    assert n_bytes / roofline.HBM_BYTES_PER_S > flops / \
        roofline.F32_FLOPS_PER_S
    cfg = _robot()
    assert round(1e3 * roofline_hybrid.k5_least_s(C, cfg, steps), 4) == 0.0031
    assert round(1e3 * roofline_hybrid.k5_least_s(65536, cfg, steps),
                 4) == 0.0124


def test_sweep_class_bytes_at_the_cells_shape():
    """A colour class of robot_map(100)'s sweep: 49 even and 48 odd latent
    types; the even class reads 95 latent odd neighbours in its
    agreement rows (segments 49 and 99 are labelled) and its 7 latent
    depths, the odd class 95 latent even neighbours (segment 0 is
    labelled) and its 7 latent depths."""
    cfg = _robot()
    types_, depths = roofline_hybrid.latent_sets(cfg)
    assert len(types_) == 97 and len(depths) == 14
    even, odd = roofline_hybrid.sweep_class_bytes(65536, cfg)
    assert even == 65536 * (95 + 7 + 49) * 4
    assert odd == 65536 * (95 + 7 + 48) * 4
    assert roofline_hybrid.sweep_class_least_s(65536, cfg) == pytest.approx(
        (even + odd) / 2 / roofline.HBM_BYTES_PER_S)


def test_k1_bound_at_the_cells_shape():
    """K1's least time at n = 82, 65,536 chains, 8 steps: 0.1184 ms, bound
    by its operations (PERF.md's table)."""
    n_bytes, flops = roofline_dense.k1_work(65536, 82, 8)
    assert flops == 2 * 65536 * 82 * 82 * 9
    assert n_bytes == (4 * 65536 * 82 + 82 * 82 + 2 * 82 + 1) * 4
    assert flops / roofline.F32_FLOPS_PER_S > n_bytes / \
        roofline.HBM_BYTES_PER_S
    assert round(1e3 * roofline_dense.k1_least_s(65536, 82, 8), 4) == 0.1184


def test_new_roofline_metrics_arithmetic():
    cfg = _robot()
    mix = dict(n_chains=65536, hmc=dict(n_leapfrog=8))
    qs = [dict(transitions=400, samples=13107200, sweep_classes=800,
               sweep_rows=475200, k5_launches=400)] * 2
    k5 = roofline_hybrid.k5_least_s(65536, cfg, 8)
    sw = roofline_hybrid.sweep_class_least_s(65536, cfg)
    c = types.SimpleNamespace(cfg=cfg, mix=mix, queries=qs,
                              trace=dict(busy_s=10.0, window_s=11.0,
                                         n_kernels=1000))
    assert REG.module("metrics", "logpot_roofline").read(c) == pytest.approx(
        100 * 800 * k5 / 10.0)
    assert REG.module("metrics", "sweep_roofline").read(c) == pytest.approx(
        100 * 1600 * sw / 10.0)
    assert REG.module("metrics", "dense_roofline").read(c) is None
    g = types.SimpleNamespace(cfg=dict(n_latent=82), mix=mix, queries=qs,
                              trace=c.trace)
    assert REG.module("metrics", "dense_roofline").read(g) == pytest.approx(
        100 * 800 * roofline_dense.k1_least_s(65536, 82, 8) / 10.0)
    for name in ("logpot_roofline", "sweep_roofline"):
        assert REG.module("metrics", name).read(g) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["robot100_hmc"])
def test_cell_on_the_card(card, cell):
    """One short traced run of each measured cell, started as the
    benchmark's command starts it: correct, and its new metrics read."""
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "1"], cwd=CHECKOUT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"logpot_roofline", "sweep_roofline"} <= set(result["metrics"])
