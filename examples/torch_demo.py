"""All-engine comparison on the hybrid chain on the PyTorch port (the
port's counterpart of ``examples/demo.py``): build the model, run every
engine, compare marginals and wall time against the exact answer. Runs on
the card unless given --cpu; ``--metrics-path out.jsonl`` also writes
each engine's row as a JSONL record.

    python examples/torch_demo.py --cpu
"""

import argparse
import time

from torch_common import device_of, report, sync


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-path", default=None)
    args = p.parse_args()
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, nuts, smc, vi
    from lhvi_tpu_torch.engines.epbp import EPBP, EPBPConfig
    from lhvi_tpu_torch.engines.lbp import HybridLBP
    from lhvi_tpu_torch.engines.map_search import HybridMaxWalkSAT
    from lhvi_tpu_torch.models.toy import hybrid_chain
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    dev = device_of(args)
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g, dev)

    def gen():
        return torch.Generator(dev).manual_seed(args.seed)

    runs = {
        "nuts": lambda: nuts.sample(fg, gen(), n_chains=16, n_warmup=300,
                                    n_samples=600),
        "hmc": lambda: hmc.sample(fg, gen(), n_chains=32, n_warmup=400,
                                  n_samples=1000),
        "vi": lambda: vi.infer(fg, gen(), vi.VIConfig(K=8, n_iters=1500)),
        "smc": lambda: smc.sample(fg, gen(), smc.SMCConfig(n_particles=4096,
                                                           n_temps=40)),
        "lbp": lambda: HybridLBP(fg).run(30),
        "epbp": lambda: EPBP(fg, EPBPConfig(128, 40)).run(gen()),
    }

    print(f"exact:  E[x1]={exact.mean(x1):+.3f}  E[x2]={exact.mean(x2):+.3f}"
          f"  P(d=1)={exact.disc_marginal(d)[1]:.3f}")
    print(f"{'engine':6s} {'E[x1]':>8s} {'E[x2]':>8s} {'P(d=1)':>8s} "
          f"{'max err':>8s} {'wall':>7s}")
    for name, run in runs.items():
        sync(dev)
        t0 = time.perf_counter()
        res = run()
        sync(dev)
        wall = time.perf_counter() - t0
        errs = [
            abs(res.mean(x1) - exact.mean(x1)),
            abs(res.mean(x2) - exact.mean(x2)),
            abs(res.disc_marginal(d)[1] - exact.disc_marginal(d)[1]),
        ]
        print(f"{name:6s} {res.mean(x1):+8.3f} {res.mean(x2):+8.3f} "
              f"{res.disc_marginal(d)[1]:8.3f} {max(errs):8.3f} {wall:6.1f}s")
        report(args.metrics_path, engine=name, wall_s=wall,
               mean_err_max=float(max(errs[:2])), disc_err_max=float(errs[2]))

    sync(dev)
    t0 = time.perf_counter()
    mws = HybridMaxWalkSAT(fg).run(gen())
    want = exact.map_state()
    print(f"mws    MAP: d*={mws.map(d)} (exact {want[d]})  "
          f"x1*={mws.map(x1):+.2f} (exact {want[x1]:+.2f})  "
          f"wall {time.perf_counter() - t0:.1f}s")
    report(args.metrics_path, engine="mws", wall_s=time.perf_counter() - t0,
           map_d_equal=bool(mws.map(d) == want[d]),
           map_x1_err=abs(float(mws.map(x1)) - float(want[x1])))


if __name__ == "__main__":
    main()
