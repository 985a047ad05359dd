"""BASELINE config 3 on the PyTorch port: the hybrid friends-smokers MLN
with lifted compression (the port's counterpart of
``examples/run_friends_smokers.py``). Runs on the card unless given
--cpu. smokes(p0) is observed, so P(cancer(p0) = 1) is σ(1.2) exactly.

    python examples/torch_run_friends_smokers.py --n-people 50 --engine vi
    python examples/torch_run_friends_smokers.py --lifted false  # grounded
"""

import math

from torch_common import device_of, make_parser, report, run_engine
from lhvi_tpu_torch.config import FriendsSmokersConfig, from_args


def main():
    args = make_parser(FriendsSmokersConfig(), __doc__).parse_args()
    cfg = from_args(FriendsSmokersConfig, args)
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.lift import compile_lifted, lifting_report
    from lhvi_tpu_torch.models.relational import friends_smokers

    dev = device_of(args)
    rg = friends_smokers(n_people=cfg.n_people, hybrid=cfg.hybrid)
    rg.observe("smokes", ("p0",), 1)
    g, index = rg.ground()
    rep = lifting_report(g)
    print(
        f"ground |V|={rep['n_rvs']} |F|={rep['n_factors']}  ->  "
        f"orbits: rv={rep['n_rv_orbits']} factor={rep['n_factor_orbits']}"
    )

    fg = compile_lifted(g, dev) if cfg.lifted else compile_graph(g, dev)
    res = run_engine(fg, cfg, torch.Generator(dev).manual_seed(cfg.seed))
    mode = "lifted" if cfg.lifted else "grounded"
    print(f"engine={cfg.engine} ({mode})  wall={res.wall_s:.2f}s")
    for key in [("smokes", ("p1",)), ("cancer", ("p0",)), ("cancer", ("p1",))]:
        rv = index[key]
        print(f"P({key[0]}{key[1]}) = {res.disc_marginal(rv).round(4)}")
    want = 1.0 / (1.0 + math.exp(-1.2))
    err = abs(float(res.disc_marginal(index[("cancer", ("p0",))])[1]) - want)
    print(f"P(cancer(p0) = 1) err vs sigma(1.2) = {want:.4f}: {err:.4f}")
    if cfg.hybrid:
        rv = index[("stress", ("p0",))]
        print(f"E[stress(p0)] = {res.mean(rv):.3f} (smoker)")
        rv = index[("stress", ("p1",))]
        print(f"E[stress(p1)] = {res.mean(rv):.3f} (unknown)")
    report(cfg.metrics_path, engine=cfg.engine, lifted=cfg.lifted,
           wall_s=res.wall_s, n_rv_orbits=rep["n_rv_orbits"],
           cancer_err=err)


if __name__ == "__main__":
    main()
