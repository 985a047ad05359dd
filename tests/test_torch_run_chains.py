"""The contract of ``engines/hmc.py::run_chains``, the one chain loop
behind ``hmc.run_hmc`` and ``nuts.run_nuts``, read from the transitions
themselves: the ``diag`` keys, each window statistic as the mean over the
kept draws of the LAST transition of each ``thin`` block, and NUTS's
``nuts.leaves`` counter as the sum of the leaves the transitions report.
The transitions are watched through the engine modules' attributes, which
``run_chains``'s steps look up at call time (the benchmark's planted faults
rely on that too)."""

import sys
import warnings
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lhvi_tpu_torch.engines import hmc, nuts  # noqa: E402
from lhvi_tpu_torch.models.relational import friends_smokers  # noqa: E402
from lhvi_tpu_torch.relational.fast import fast_compile  # noqa: E402
from lhvi_tpu_torch.utils.metrics import counters  # noqa: E402

C, W, S, THIN = 8, 4, 3, 2
STREAM = {"rhat", "ess_proxy", "ess_bm", "rhat_disc", "disc_diag_idx"}
ENGINES = {
    "hmc": (hmc, "hmc_transition", hmc.run_hmc,
            hmc.HMCConfig(n_leapfrog=3, mode_swap=True), ("accept_rate",)),
    "nuts": (nuts, "nuts_transition", nuts.run_nuts,
             nuts.NUTSConfig(max_depth=3, mode_swap=True),
             ("accept_rate", "mean_depth", "divergence_rate")),
}


@pytest.fixture(scope="module")
def pod16():
    """The 16-person friends-and-smokers pod, 4 smokers observed: hybrid,
    with a mode-swap plan."""
    rg = friends_smokers(n_people=16, hybrid=True)
    for i in range(4):
        rg.observe("smokes", (f"p{i}",), i % 2)
    fg = fast_compile(rg, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a graph without a plan warns
        assert hmc._ensure_mode_swap_plan(
            fg, ENGINES["hmc"][3])[0].mode_swap_plan is not None
    return fg


@pytest.mark.parametrize("collect", ["samples", "moments"])
@pytest.mark.parametrize("engine", ["hmc", "nuts"])
def test_run_chains_reports_the_last_transition_of_each_thin_block(
        pod16, monkeypatch, engine, collect):
    mod, name, run, cfg, stats = ENGINES[engine]
    real = getattr(mod, name)
    seen = []  # (adapt, per-chain stats) of every transition, in order

    def watch(fg, cfg, state, gen, adapt, gate=None, shard=None):
        state, out = real(fg, cfg, state, gen, adapt, gate, shard)
        seen.append((adapt, out if engine == "nuts" else (out,)))
        return state, out

    monkeypatch.setattr(mod, name, watch)
    before = counters().get("nuts.leaves", 0)
    out = run(pod16, torch.Generator().manual_seed(2), cfg, n_chains=C,
              n_warmup=W, n_samples=S, thin=THIN, collect=collect)
    diag = out[2]

    assert [a for a, _ in seen] == [True] * W + [False] * (S * THIN)
    keys = set(stats) | {"step_size", "inv_mass", "mode_swap_accept"}
    assert set(diag) == keys | (STREAM if collect == "moments" else set())
    kept = [o for _, o in seen[W + THIN - 1::THIN]]
    assert len(kept) == S
    for i, stat in enumerate(stats):
        want = sum(float(o[i].float().mean()) for o in kept) / S
        assert float(diag[stat]) == pytest.approx(want, rel=1e-6), stat
    if collect == "samples":
        assert out[0].shape == (S, C, pod16.n_cont)
    else:
        assert out[0]["n_obs"] == S * C
    if engine == "nuts":
        leaves = sum(int(o[3].sum()) for _, o in seen)
        assert counters()["nuts.leaves"] - before == leaves > 0
