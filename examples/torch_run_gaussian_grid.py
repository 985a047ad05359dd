"""BASELINE config 2 on the PyTorch port: a grid Gaussian MRF with
evidence, any engine against GaBP and the dense solve (the port's
counterpart of ``examples/run_gaussian_grid.py``). Runs on the card
unless given --cpu.

    python examples/torch_run_gaussian_grid.py --engine hmc --rows 10 --cols 10
"""

import time

import numpy as np

from torch_common import device_of, make_parser, report, run_engine, sync
from lhvi_tpu_torch.config import GridConfig, from_args


def main():
    args = make_parser(GridConfig(), __doc__).parse_args()
    cfg = from_args(GridConfig, args)
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import gabp
    from lhvi_tpu_torch.models.toy import gaussian_grid

    dev = device_of(args)
    g, _ = gaussian_grid(cfg.rows, cfg.cols, seed=cfg.seed,
                         evidence_frac=cfg.evidence_frac)
    oracle, latents = gabp.dense_gaussian_marginals(g)

    if cfg.engine == "gabp":
        sync(dev)
        t0 = time.perf_counter()
        eng = gabp.GaBP(g, dev).run(cfg.bp_iters)
        sync(dev)
        wall = time.perf_counter() - t0
        errs = [abs(eng.mean(rv) - oracle[id(rv)][0]) for rv in latents]
        print(f"GaBP  wall={wall:.2f}s  mean-err mean={np.mean(errs):.2e} "
              f"max={np.max(errs):.2e}")
        report(cfg.metrics_path, engine="gabp", wall_s=wall,
               mean_err_avg=float(np.mean(errs)),
               mean_err_max=float(np.max(errs)))
        return

    fg = compile_graph(g, dev)
    res = run_engine(fg, cfg, torch.Generator(dev).manual_seed(cfg.seed))
    errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in latents]
    vrel = [
        abs(res.var(rv) - oracle[id(rv)][1]) / oracle[id(rv)][1]
        for rv in latents
    ]
    print(
        f"engine={cfg.engine}  wall={res.wall_s:.2f}s  "
        f"|mean err| avg={np.mean(errs):.4f} max={np.max(errs):.4f}  "
        f"var rel-err avg={np.mean(vrel):.3f}"
    )
    report(cfg.metrics_path, engine=cfg.engine, wall_s=res.wall_s,
           mean_err_avg=float(np.mean(errs)),
           mean_err_max=float(np.max(errs)), var_rel_avg=float(np.mean(vrel)))


if __name__ == "__main__":
    main()
