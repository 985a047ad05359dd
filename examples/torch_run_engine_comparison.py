"""Engine comparison on the PyTorch port: marginal error vs compute across
all engines (the port's counterpart of
``examples/run_engine_comparison.py``, the paper's headline experiment).

One script sweeps a budget ladder per engine on one model, scores every
latent's posterior mean against an exact oracle (the port's own
``utils/oracle.py::ExactPosterior`` and
``engines/gabp.py::dense_gaussian_marginals``), and emits the error-vs-wall
curve as JSONL (``--metrics out.jsonl``) plus a printed table. Each point
is run twice and the SECOND wall time is reported, so the first call's
kernel loads and allocations are not scored; the clock waits on the
device at both ends. Runs on the card unless given ``--cpu``.

    python examples/torch_run_engine_comparison.py --model chain
    python examples/torch_run_engine_comparison.py --model grid --engines vi,lbp
    python examples/torch_run_engine_comparison.py --model chain --quick --cpu

(``--max-budget N`` drops the rungs above N, for a shorter sweep.)
"""

import argparse
import dataclasses
import time

import numpy as np

from torch_common import sync, device_of, run_engine

BUDGETS = {
    # engine -> budget ladder (engine-native units, logged per point)
    "vi": [10, 30, 100, 300, 1000],
    "lbp": [1, 2, 5, 10, 20],
    "epbp": [1, 2, 5, 10, 20],
    "gabp": [1, 2, 5, 10, 20, 50],
    "hmc": [50, 150, 500, 1500],
    "nuts": [50, 150, 500],
    "smc": [10, 20, 50, 100],
}
UNITS = {
    "vi": "adam_steps", "lbp": "bp_iters", "epbp": "bp_iters",
    "gabp": "bp_iters", "hmc": "samples", "nuts": "samples",
    "smc": "temperatures",
}


def build(model: str, seed: int):
    """Returns (graph, latents, oracle_means dict keyed by id(rv),
    oracle_disc_marginals)."""
    from lhvi_tpu_torch.engines import gabp
    from lhvi_tpu_torch.models.toy import gaussian_grid, hybrid_chain
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    if model == "chain":
        g, _ = hybrid_chain()
        exact = ExactPosterior(g, cont_grid=201)
    elif model == "grid":
        g, _ = gaussian_grid(rows=6, cols=6, seed=seed, evidence_frac=0.2)
        oracle, latents = gabp.dense_gaussian_marginals(g)
        return g, latents, {id(rv): oracle[id(rv)][0] for rv in latents}, {}
    elif model == "smokers":
        from lhvi_tpu_torch.models.relational import friends_smokers

        # n_people=2 keeps the exact oracle tractable: 2 continuous
        # latents × 61-point grid + ≤8 boolean latents ≈ 1e6 mesh states
        rg = friends_smokers(n_people=2, hybrid=True)
        rg.observe("smokes", ("p0",), 1)
        g, _ = rg.ground()
        exact = ExactPosterior(g, cont_grid=61)
    else:
        raise ValueError(f"unknown model {model!r} (chain|grid|smokers)")
    latents = [rv for rv in g.rvs if not rv.observed]
    means = {id(rv): exact.mean(rv) for rv in latents
             if rv.domain.continuous}
    disc = {id(rv): exact.disc_marginal(rv) for rv in latents
            if not rv.domain.continuous}
    return g, latents, means, disc


def run_point(engine: str, budget: int, g, fg, seed: int):
    """One (engine, budget) run via ``torch_common.run_engine``; returns
    (result, wall seconds of the second of two identical runs)."""
    import torch

    from lhvi_tpu_torch.config import EngineConfig
    from lhvi_tpu_torch.engines import gabp

    if engine == "gabp":  # object-graph engine, not in run_engine
        gabp.GaBP(g, fg.device).run(budget)
        sync(fg.device)
        t0 = time.perf_counter()
        res = gabp.GaBP(g, fg.device).run(budget)
        sync(fg.device)
        return res, time.perf_counter() - t0

    cfg = EngineConfig(engine=engine, collect="moments", n_chains=64,
                       particles=64)
    if engine == "vi":
        cfg = dataclasses.replace(cfg, vi_iters=budget, vi_k=4)
    elif engine in ("lbp", "epbp"):
        cfg = dataclasses.replace(cfg, bp_iters=budget)
    elif engine in ("hmc", "nuts"):
        cfg = dataclasses.replace(cfg, n_warmup=budget // 2,
                                  n_samples=budget)
    elif engine == "smc":
        cfg = dataclasses.replace(cfg, smc_temps=budget)
    run_engine(fg, cfg, torch.Generator(fg.device).manual_seed(seed))
    res = run_engine(fg, cfg, torch.Generator(fg.device).manual_seed(seed))
    return res, res.wall_s


def score(res, latents, means, disc):
    errs, derrs = [], []
    for rv in latents:
        if id(rv) in means:
            errs.append(abs(float(res.mean(rv)) - means[id(rv)]))
        elif id(rv) in disc:
            try:
                m = np.asarray(res.disc_marginal(rv))
                derrs.append(float(np.abs(m - disc[id(rv)]).max()))
            except (AttributeError, ValueError, NotImplementedError):
                pass  # engine has no discrete marginals (e.g. GaBP)
    return errs, derrs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="chain",
                   choices=("chain", "grid", "smokers"))
    p.add_argument("--engines", default="auto",
                   help="comma list, or 'auto' (every engine the model "
                        "supports)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", default="")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--quick", action="store_true",
                   help="one small budget per engine (CI smoke)")
    p.add_argument("--max-budget", type=int, default=0,
                   help="drop the rungs above this budget (0: keep all)")
    args = p.parse_args(argv)
    if args.quick:
        for k, lad in BUDGETS.items():
            BUDGETS[k] = lad[:1]
    if args.max_budget:
        for k, lad in BUDGETS.items():
            BUDGETS[k] = [b for b in lad if b <= args.max_budget] or lad[:1]

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.utils.metrics import MetricsLogger

    g, latents, means, disc = build(args.model, args.seed)
    fg = compile_graph(g, device_of(args))
    log = MetricsLogger(args.metrics or None, echo=True)

    if args.engines == "auto":
        engines = ["vi", "lbp", "epbp", "hmc", "nuts", "smc"]
        if args.model == "grid":  # GaBP needs an all-Gaussian model
            engines.insert(3, "gabp")
    else:
        engines = [e.strip() for e in args.engines.split(",") if e.strip()]
        for e in list(engines):
            if e not in BUDGETS or (e == "gabp" and args.model != "grid"):
                log.log("skip_engine", engine=e,
                        why=("unknown engine" if e not in BUDGETS
                             else "gabp needs --model grid"))
                engines.remove(e)
    log.log("setup", model=args.model, n_latents=len(latents),
            engines=",".join(engines), device=str(fg.device))

    rows = []
    for engine in engines:
        for budget in BUDGETS[engine]:
            try:
                res, wall = run_point(engine, budget, g, fg, args.seed)
                errs, derrs = score(res, latents, means, disc)
            except Exception as e:  # noqa: BLE001 — sweep survives one engine
                log.log("error", engine=engine, budget=budget,
                        what=repr(e)[:200])
                continue
            # hmc/nuts pay budget//2 warmup transitions on top of the
            # budget samples; log them so curves stay comparable across
            # engines' budget units
            warm = budget // 2 if engine in ("hmc", "nuts") else 0
            rec = log.log(
                "point", engine=engine, budget=budget,
                budget_unit=UNITS[engine], warmup_extra=warm,
                wall_s=round(wall, 3),
                mean_err_avg=(round(float(np.mean(errs)), 5)
                              if errs else None),
                mean_err_max=(round(float(np.max(errs)), 5)
                              if errs else None),
                disc_err_max=(round(float(np.max(derrs)), 5)
                              if derrs else None),
            )
            rows.append(rec)
    log.close()

    print(f"\n{'engine':>6} {'budget':>7} {'wall_s':>8} "
          f"{'mean_err':>9} {'disc_err':>9}")
    for r in rows:
        print(f"{r['engine']:>6} {r['budget']:>7} {r['wall_s']:>8.3f} "
              f"{(r['mean_err_avg'] if r['mean_err_avg'] is not None else float('nan')):>9.5f} "
              f"{(r['disc_err_max'] if r['disc_err_max'] is not None else float('nan')):>9.5f}")
    return rows


if __name__ == "__main__":
    main()
