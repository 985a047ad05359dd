"""BASELINE config 1 on the PyTorch port: the 3-variable hybrid chain,
any engine against exact enumeration (the port's counterpart of
``examples/run_hybrid_chain.py``). Runs on the card unless given --cpu.

    python examples/torch_run_hybrid_chain.py --engine nuts
    python examples/torch_run_hybrid_chain.py --engine vi --vi-k 8 --cpu
"""

import numpy as np

from torch_common import device_of, make_parser, report, run_engine
from lhvi_tpu_torch.config import ChainConfig, from_args


def main():
    args = make_parser(ChainConfig(), __doc__).parse_args()
    cfg = from_args(ChainConfig, args)
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.toy import hybrid_chain
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    dev = device_of(args)
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g, dev)
    res = run_engine(fg, cfg, torch.Generator(dev).manual_seed(cfg.seed))

    print(f"engine={cfg.engine}  wall={res.wall_s:.2f}s")
    print(f"{'rv':4s} {'E[x] got':>10s} {'E[x] exact':>10s} {'err':>8s}")
    errs = []
    for rv, nm in [(x1, "x1"), (x2, "x2")]:
        m, me = res.mean(rv), exact.mean(rv)
        errs.append(abs(m - me))
        print(f"{nm:4s} {m:10.4f} {me:10.4f} {abs(m - me):8.4f}")
    d_err = None
    if cfg.engine != "mws":
        pd, pde = res.disc_marginal(d), exact.disc_marginal(d)
        d_err = float(np.abs(pd - pde).max())
        print(f"P(d)  got={pd.round(4)}  exact={pde.round(4)}")
    else:
        print(f"MAP: d*={res.map(d)} x1*={res.map(x1):.3f} x2*={res.map(x2):.3f}")
    report(cfg.metrics_path, engine=cfg.engine, wall_s=res.wall_s,
           mean_err_max=max(errs), disc_err_max=d_err)


if __name__ == "__main__":
    main()
