"""The port's factor-axis (``tp``) sharding, ``parallel.shard_fg_factors``,
over two gloo processes on the CPU, held to the JAX package.

Mirrors ``tests/test_models_extra.py:69-90`` (``gaussian_grid(5, 5)``,
``pad_to=8``, ``fuse_quadratic=False``) and adds the fused hybrid
friends-smokers graph of ``__graft_entry__.py:62-64``, whose ELBO has the
replicated terms that must enter once (``mixture_entropy_bound`` and
``_quad_expected``):

- the sharded ``elbo`` and ``log_prob`` equal the JAX package's unsharded
  values at rtol 1e-5, from the reference's parameters carried over by
  ``utils/convert.py::vi_params_from_numpy`` and its initial state;
- the ranks' gradient shares, all-reduced, equal the unsharded gradient
  (each leaf to 1e-5 × (1 + its largest magnitude): the same f32 terms
  summed in another order);
- a 5-step sharded ``vi._fit_from`` equals the port's unsharded fit: the
  ELBO trace at rtol 1e-5 and the parameters within 1e-5 × (1 + their
  largest magnitude), again f32 sums taken in another order;
- a bucket whose rows do not divide raises, and the samplers refuse a
  sharded graph.

The worker is this file itself (``python test_torch_factor_shard.py <rank>
<world> <port> <dir>``): it imports torch and the port only, and reads the
reference's values from ``<dir>/ref.npz``.
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
CASES = ("grid5x5_unfused", "smokers6")
K, N_QUAD = 2, 5


def _graph(toy, friends_smokers, name):
    """(graph, compile kwargs) of a case, built by either package."""
    if name == "grid5x5_unfused":
        g, _ = toy.gaussian_grid(5, 5, seed=0, evidence_frac=0.2)
        return g, dict(pad_to=8, fuse_quadratic=False)
    rg = friends_smokers(n_people=6, hybrid=True)
    g, _ = rg.ground()
    return g, dict(pad_to=max(8, WORLD))


def _grad(p):
    """A leaf's gradient (zeros where the ELBO does not reach it: the
    logits of a graph with no discrete latent)."""
    return torch.zeros_like(p) if p.grad is None else p.grad.clone()


def _worker(rank: int, world: int, port: int, out: str) -> None:
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    import torch.distributed as dist

    import lhvi_tpu_torch as lt
    import lhvi_tpu_torch.models.toy as toy
    from lhvi_tpu_torch.engines import vi
    from lhvi_tpu_torch.models.relational import friends_smokers
    from lhvi_tpu_torch.parallel import (all_reduce, init_distributed,
                                         shard_fg_factors)
    from lhvi_tpu_torch.utils.convert import vi_params_from_numpy

    shard = init_distributed("gloo", f"tcp://127.0.0.1:{port}", rank, world)
    ref = np.load(f"{out}/ref.npz")
    res = {}
    for name in CASES:
        g, kw = _graph(toy, friends_smokers, name)
        fg = lt.compile_graph(g, "cpu", **kw)
        params = vi_params_from_numpy(
            {k: ref[f"{name}/{k}"] for k in vi.VIParams._fields}, "cpu")
        e_whole = vi.elbo(fg, params, N_QUAD)  # fills fg.vi_plans
        fg_tp = shard_fg_factors(fg, shard)
        xc = torch.as_tensor(ref[f"{name}/xc"])
        xd = torch.as_tensor(ref[f"{name}/xd"], dtype=torch.int64)

        leaves = [p.clone().requires_grad_(True) for p in params]
        e = vi.elbo(fg_tp, vi.VIParams(*leaves), N_QUAD)
        e.backward()
        shares = [_grad(p) for p in leaves]
        summed = [all_reduce(s, shard) for s in shares]
        whole = [p.clone().requires_grad_(True) for p in params]
        vi.elbo(fg, vi.VIParams(*whole), N_QUAD).backward()
        whole = [_grad(p) for p in whole]

        cfg = vi.VIConfig(K=K, n_quad=N_QUAD, n_iters=5)
        p_tp, tr_tp = vi._fit_from(fg_tp, params, cfg)
        p_1, tr_1 = vi._fit_from(fg, params, cfg)
        res[name] = {
            "elbo": float(e), "elbo_whole": float(e_whole),
            "log_prob": float(fg_tp.log_prob(xc, xd)),
            "log_prob_batched": fg_tp.log_prob_batched(
                xc[None].expand(3, -1), xd[None].expand(3, -1)).numpy(),
            "grad_summed": [s.numpy() for s in summed],
            "grad_whole": [w.numpy() for w in whole],
            "grad_share_differs": any(
                not torch.equal(s, w) for s, w in zip(shares, whole)),
            "trace": (tr_tp.numpy(), tr_1.numpy()),
            "params": ([p.numpy() for p in p_tp], [p.numpy() for p in p_1]),
            "rows": [(b.n_factors, b2.n_factors)
                     for b, b2 in zip(fg.buckets, fg_tp.buckets)],
            "all_padding": any(float(b.scale.abs().sum()) == 0.0
                               for b in fg_tp.buckets),
            "fresh_plans": (fg_tp.vi_plans is not fg.vi_plans
                            and set(fg.vi_plans) == {N_QUAD}),
        }
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference(out: Path) -> None:
    """The JAX package's unsharded ELBO and log_prob, with the parameters
    and state they were taken at, into ``out/ref.npz``."""
    import jax

    import lhvi_tpu.models.toy as ref_toy
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import vi as ref_vi
    from lhvi_tpu.models.relational import friends_smokers

    arrays = {}
    for name in CASES:
        g, kw = _graph(ref_toy, friends_smokers, name)
        fg = compile_graph(g, **kw)
        params = ref_vi.init_params(fg, jax.random.PRNGKey(0),
                                    ref_vi.VIConfig(K=K, n_quad=N_QUAD))
        xc, xd = fg.init_state(jax.random.PRNGKey(1))
        arrays[f"{name}/elbo"] = float(
            jax.jit(lambda p: ref_vi.elbo(fg, p, N_QUAD))(params))
        arrays[f"{name}/log_prob"] = float(fg.log_prob(xc, xd))
        arrays[f"{name}/xc"] = np.asarray(xc)
        arrays[f"{name}/xd"] = np.asarray(xd)
        for k, v in params._asdict().items():
            arrays[f"{name}/{k}"] = np.asarray(v)
    np.savez(out / "ref.npz", **arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("factor_shard")
    _reference(out)
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
    ref = dict(np.load(out / "ref.npz"))
    return ref, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]


@pytest.mark.parametrize("name", CASES)
def test_sharded_elbo_and_log_prob_match_reference(ranks, name):
    """test_models_extra.py:69-90 on the port: the tp-sharded ELBO and
    log_prob are the JAX package's unsharded values on every rank."""
    ref, res = ranks
    for r in res:
        a = r[name]
        np.testing.assert_allclose(a["elbo"], ref[f"{name}/elbo"], rtol=1e-5)
        np.testing.assert_allclose(a["elbo"], a["elbo_whole"], rtol=1e-5)
        np.testing.assert_allclose(a["log_prob"], ref[f"{name}/log_prob"],
                                   rtol=1e-5)
        np.testing.assert_allclose(a["log_prob_batched"],
                                   np.full(3, a["log_prob"]), rtol=1e-6)
        assert all(n_tp * WORLD == n for n, n_tp in a["rows"])
        assert a["fresh_plans"]
    # the grid has a bucket whose slice on one rank is all padding: the sum
    # stays the whole
    assert any(r[n]["all_padding"] for r in res for n in CASES)


@pytest.mark.parametrize("name", CASES)
def test_summed_gradient_shares_are_the_whole_gradient(ranks, name):
    """The replicated terms enter each rank's share scaled by 1/world, so
    the all-reduced shares count them once."""
    _, res = ranks
    for r in res:
        a = r[name]
        assert a["grad_share_differs"]
        for got, want in zip(a["grad_summed"], a["grad_whole"]):
            tol = 1e-5 * (1.0 + np.abs(want).max(initial=0.0))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", CASES)
def test_sharded_fit_equals_unsharded_fit(ranks, name):
    """Five Adam steps on the sharded graph take the unsharded fit's steps,
    on every rank alike."""
    _, res = ranks
    for r in res:
        tr_tp, tr_1 = r[name]["trace"]
        np.testing.assert_allclose(tr_tp, tr_1, rtol=1e-5)
        for got, want in zip(*r[name]["params"]):
            tol = 1e-5 * (1.0 + np.abs(want).max(initial=0.0))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for got, want in zip(res[0][name]["params"][0], res[1][name]["params"][0]):
        np.testing.assert_array_equal(got, want)


def test_bucket_that_does_not_divide_raises_and_samplers_refuse():
    """The reference's refusal (``lhvi_tpu/parallel/mesh.py:144-148``),
    raised before any collective; a sharded graph serves VI and log_prob
    only, so the samplers and BP engines refuse it."""
    sys.path.insert(0, str(REPO))
    import lhvi_tpu_torch as lt
    import lhvi_tpu_torch.models.toy as toy
    from lhvi_tpu_torch.engines import hmc, nuts, smc
    from lhvi_tpu_torch.engines.lbp import HybridLBP
    from lhvi_tpu_torch.parallel import ChainShard, shard_fg_factors

    g, _ = toy.gaussian_grid(5, 5, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu", pad_to=8, fuse_quadratic=False)
    assert any(b.n_factors % 3 for b in fg.buckets)
    with pytest.raises(ValueError, match="not divisible by tp=3; compile "
                       "with pad_to a multiple of it"):
        shard_fg_factors(fg, ChainShard(0, 3))
    fg_tp = shard_fg_factors(fg, ChainShard(1, 2))
    gen = torch.Generator().manual_seed(0)
    for run in (lambda: hmc.run_hmc(fg_tp, gen, n_chains=2, n_warmup=0,
                                    n_samples=1),
                lambda: nuts.run_nuts(fg_tp, gen, n_chains=2, n_warmup=0,
                                      n_samples=1),
                lambda: smc.run_smc(fg_tp, gen, smc.SMCConfig(n_particles=4)),
                lambda: HybridLBP(fg_tp),
                lambda: fg_tp.disc_logits(*fg.init_state_batched(gen, 2))):
        with pytest.raises(ValueError, match="needs the whole graph"):
            run()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
