"""The port's chain and particle sharding (``parallel/mesh.py``) over two
gloo processes on the CPU, as ``tests/test_multihost.py`` runs the
reference over two local processes.

Mirrors ``tests/test_pod_sharded.py:39-106``,
``tests/test_shard_pallas.py:49-84``, ``tests/test_smc_adaptive.py:133-150``
and ``tests/test_modeswap.py:235``:

- with adaptation off, a sharded run equals the pooled unsharded runs of
  each rank's chains from that rank's stream (``split_generator``):
  discrete counts exactly, means and variances to f32 rounding;
- with adaptation on, the step size and the mass are identical on both
  ranks and the moments meet the reference tests' thresholds (HMC, NUTS);
- SMC's log Z on ``kalman_lds(T=8)`` is within 0.5 of the unsharded run's
  (adaptive and fixed schedules);
- a checkpointed run interrupted and resumed across the ranks is bitwise
  equal to an uninterrupted one;
- a chain count that does not divide raises.

The worker is this file itself (``python test_torch_sharded.py <rank>
<world> <port> <out>``): it imports torch and the port only. Each rank
saves what it saw; the tests below read both ranks' files.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2


def _worker(rank: int, world: int, port: int, out: str) -> None:
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    import lhvi_tpu_torch as lt
    from lhvi_tpu_torch.engines import hmc, nuts, smc
    from lhvi_tpu_torch.engines.gabp import dense_gaussian_marginals
    from lhvi_tpu_torch.engines.resumable import sample_checkpointed
    from lhvi_tpu_torch.models.lds import kalman_lds
    from lhvi_tpu_torch.models.relational import friends_smokers
    from lhvi_tpu_torch.models.toy import gaussian_grid, hybrid_chain
    from lhvi_tpu_torch.parallel import (init_distributed, replicas_equal,
                                         split_generator)
    from lhvi_tpu_torch.relational.fast import fast_compile

    shard = init_distributed("gloo", f"tcp://127.0.0.1:{port}", rank, world)
    res = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def moments(m, d):
        return {"mean": m["mean"].numpy(), "var": m["var"].numpy(),
                "disc_probs": m["disc_probs"].numpy(), "n_obs": m["n_obs"],
                "accept": float(d["accept_rate"])}

    # --- adaptation off: sharded == pooled per-rank unsharded ------------
    rg = friends_smokers(n_people=16, hybrid=True)
    for i in range(4):
        rg.observe("smokes", (f"p{i}",), i % 2)
    pod = fast_compile(rg, "cpu")
    assert pod.color_plan is not None
    for name, cfg in (("pod", hmc.HMCConfig(n_leapfrog=3, init_step_size=0.05,
                                             adapt_mass=False)),
                      ("modeswap", hmc.HMCConfig(n_leapfrog=3,
                                                 init_step_size=0.05,
                                                 adapt_mass=False,
                                                 mode_swap=True))):
        kw = dict(n_warmup=0, n_samples=6, collect="moments")
        m1, _, d1 = hmc.run_hmc(pod, gen(0), cfg, n_chains=16, shard=shard,
                                **kw)
        m0, _, d0 = hmc.run_hmc(pod, split_generator(gen(0), rank)[0], cfg,
                                n_chains=8, **kw)
        res[name] = {"sharded": moments(m1, d1), "local": moments(m0, d0),
                     "rhat": d1["rhat"].numpy(),
                     "ess_proxy": d1["ess_proxy"].numpy()}
        if cfg.mode_swap:
            res[name]["ms"] = (float(d1["mode_swap_accept"]),
                               float(d0["mode_swap_accept"]))

    # --- adaptation on: identical step size and mass, oracle moments -----
    g, latents = gaussian_grid(rows=4, cols=4, seed=0, evidence_frac=0.2)
    grid = lt.compile_graph(g, "cpu")
    oracle, latents = dense_gaussian_marginals(g)
    idx = [grid.meta.loc(rv)[1] for rv in latents]
    exact = np.array([oracle[id(rv)][0] for rv in latents])
    for name, run, cfg in (("hmc", hmc.run_hmc, hmc.HMCConfig()),
                           ("nuts", nuts.run_nuts,
                            nuts.NUTSConfig(max_depth=4))):
        m, _, d = run(grid, gen(0), cfg, n_chains=256, n_warmup=200,
                      n_samples=400, collect="moments", shard=shard)
        res[name] = {
            "err": float(np.mean(np.abs(m["mean"].numpy()[idx] - exact))),
            "step": float(d["step_size"]), "inv_mass": d["inv_mass"].numpy(),
            "same": (replicas_equal(d["step_size"], shard)
                     and replicas_equal(d["inv_mass"], shard)),
            "accept": float(d["accept_rate"])}

    # --- SMC: the collective resampler ------------------------------------
    g, _, _ = kalman_lds(T=8, seed=2)
    lds = lt.compile_graph(g, "cpu")
    for adaptive in (True, False):
        cfg = smc.SMCConfig(n_particles=2048, n_temps=30, n_moves=2,
                            adaptive=adaptive)
        xc, _, lw, lz1, d1 = smc.run_smc(lds, gen(0), cfg, shard=shard)
        *_, lz0, d0 = smc.run_smc(lds, gen(0), cfg)
        res[f"smc_{adaptive}"] = {
            "lz": (float(lz1), float(lz0)), "rows": (xc.shape[0], lw.shape[0]),
            "n_used": int(d1["n_temps_used"]),
            "same": replicas_equal(torch.stack([lz1, d1["final_step"]]),
                                   shard)}

    # --- resume across the ranks ------------------------------------------
    g, _ = hybrid_chain()
    chain = lt.compile_graph(g, "cpu")
    kw = dict(engine="hmc", n_chains=16, n_warmup=20, n_samples=40,
              chunk_size=10, shard=shard,
              cfg=hmc.HMCConfig(n_leapfrog=4, init_step_size=0.3))
    full = sample_checkpointed(chain, gen(2), ckpt_dir=out + "/ck_a", **kw)
    assert sample_checkpointed(chain, gen(2), ckpt_dir=out + "/ck_b",
                               _interrupt_after=2, **kw) is None
    assert sample_checkpointed(chain, gen(2), ckpt_dir=out + "/ck_c",
                               _interrupt_warmup_after=1, **kw) is None
    resumed = [sample_checkpointed(chain, gen(2), ckpt_dir=out + d, **kw)
               for d in ("/ck_b", "/ck_c")]
    res["resume"] = {
        k: [np.array_equal(a, b) for a, b in
            [(full.moments[k], r.moments[k]) for r in resumed]]
        for k in ("mean", "var", "disc_probs")}
    for k in ("accept_rate", "rhat", "ess_bm", "rhat_disc", "step_size"):
        res["resume"][k] = [np.array_equal(full.diag[k], r.diag[k])
                            for r in resumed]
    res["resume_mean"] = full.moments["mean"]
    torch.save(res, f"{out}/rank{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(port), str(out)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("name", ["pod", "modeswap"])
def test_sharded_equals_pooled_rank_runs(ranks, name):
    """Adaptation off (test_pod_sharded.py:39, test_modeswap.py:235): the
    sharded run is the pooled per-rank unsharded runs."""
    sh = [r[name]["sharded"] for r in ranks]
    loc = [r[name]["local"] for r in ranks]
    for k in ("mean", "var", "disc_probs"):
        np.testing.assert_array_equal(sh[0][k], sh[1][k])
    n_obs = sh[0]["n_obs"]
    assert n_obs == sum(x["n_obs"] for x in loc)
    # discrete sufficient statistics are integer counts: exactly equal
    counts = np.rint(sh[0]["disc_probs"] * n_obs)
    pooled = sum(np.rint(x["disc_probs"] * x["n_obs"]) for x in loc)
    np.testing.assert_array_equal(counts, pooled)
    mean = sum(x["mean"] for x in loc) / WORLD
    np.testing.assert_allclose(sh[0]["mean"], mean, rtol=1e-5, atol=1e-6)
    second = sum(x["var"] + x["mean"] ** 2 for x in loc) / WORLD
    np.testing.assert_allclose(sh[0]["var"], second - mean ** 2, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sh[0]["accept"],
                               sum(x["accept"] for x in loc) / WORLD,
                               rtol=1e-5)
    assert np.isfinite(ranks[0][name]["ess_proxy"]).all()
    if name == "modeswap":
        np.testing.assert_allclose(ranks[0][name]["ms"][0],
                                   sum(r[name]["ms"][1] for r in ranks) / WORLD,
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_sharded_adaptation_is_identical_on_every_rank(ranks, name):
    """Adaptation on (test_pod_sharded.py:74, test_shard_pallas.py:62-84):
    dual averaging and Welford read all ranks' chains, so step size and
    mass come out identical on both ranks; the means meet the dense
    oracle's threshold."""
    a, b = ranks[0][name], ranks[1][name]
    assert a["same"] and b["same"]
    assert a["step"] == b["step"]
    np.testing.assert_array_equal(a["inv_mass"], b["inv_mass"])
    assert a["err"] < 0.08, a["err"]
    assert a["accept"] > 0.5


@pytest.mark.parametrize("adaptive", [True, False])
def test_sharded_smc_log_z(ranks, adaptive):
    """test_smc_adaptive.py:133-150: the sharded particle axis agrees with
    the unsharded run; every rank holds the same log Z and step."""
    r = ranks[0][f"smc_{adaptive}"]
    assert r["same"] and ranks[1][f"smc_{adaptive}"]["same"]
    lz1, lz0 = r["lz"]
    assert np.isfinite(lz1) and abs(lz1 - lz0) < 0.5, (lz1, lz0)
    assert r["rows"] == (1024, 1024)
    if adaptive:
        assert r["n_used"] < 30


def test_sharded_resume_is_bitwise(ranks):
    """test_multihost.py:75-93: interrupted at a sample chunk and at the
    first warmup chunk, then resumed, with the chains over both ranks."""
    for r in ranks:
        for k, same in r["resume"].items():
            assert all(same), k
    np.testing.assert_array_equal(ranks[0]["resume_mean"],
                                  ranks[1]["resume_mean"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
