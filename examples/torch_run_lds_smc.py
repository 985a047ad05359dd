"""BASELINE config 4 on the PyTorch port: a Kalman-like LDS under SMC with
collective resampling, against the smoothed means (GaBP's dense solve)
and the exact log Z of the Gaussian (the port's counterpart of
``examples/run_lds_smc.py``). Runs on the card unless given --cpu.

    python examples/torch_run_lds_smc.py --T 20 --smc-particles 8192
"""

import math

import numpy as np

from torch_common import device_of, make_parser, report, run_engine
from lhvi_tpu_torch.config import LDSConfig, from_args


def exact_log_z(fg) -> float:
    """½hᵀJ⁻¹h + ½(n log 2π − log|J|) + c of the compiled information form."""
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    _, logdet = np.linalg.slogdet(J)
    return float(0.5 * h @ np.linalg.solve(J, h)
                 + 0.5 * (J.shape[0] * math.log(2 * math.pi) - logdet)
                 + float(fg.quad_c))


def main():
    args = make_parser(LDSConfig(), __doc__).parse_args()
    cfg = from_args(LDSConfig, args)
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import gabp
    from lhvi_tpu_torch.models.lds import kalman_lds

    dev = device_of(args)
    g, xs, ys = kalman_lds(T=cfg.T, seed=cfg.seed)
    oracle, _ = gabp.dense_gaussian_marginals(g)
    fg = compile_graph(g, dev)
    res = run_engine(fg, cfg, torch.Generator(dev).manual_seed(cfg.seed))

    errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in xs]
    print(
        f"engine={cfg.engine}  wall={res.wall_s:.2f}s  "
        f"smoothed-mean err avg={np.mean(errs):.4f} max={np.max(errs):.4f}"
    )
    fields = dict(engine=cfg.engine, wall_s=res.wall_s,
                  mean_err_avg=float(np.mean(errs)),
                  mean_err_max=float(np.max(errs)))
    if hasattr(res, "log_z"):
        lz = exact_log_z(fg)
        print(f"log-Z estimate = {res.log_z:.3f}  (exact {lz:.3f}, err "
              f"{abs(res.log_z - lz):.3f})")
        used = int(res.diag["n_temps_used"])
        ess = np.asarray(res.diag["ess"])[:used]
        print(f"min ESS across temperatures = {ess.min():.0f}  "
              f"(temps used: {used}, final step "
              f"{float(res.diag['final_step']):.3f})")
        fields.update(log_z=float(res.log_z), log_z_exact=lz,
                      log_z_err=abs(float(res.log_z) - lz))
        if cfg.metrics_path:
            from lhvi_tpu_torch.utils.metrics import MetricsLogger

            with MetricsLogger(cfg.metrics_path) as log:
                # the (self-chosen, under --smc-adaptive) β schedule, plus
                # per-temperature ESS/accept traces: the structured record
                # of what the anneal actually did
                log.log("smc_run",
                        adaptive=cfg.smc_adaptive,
                        n_temps_used=used,
                        betas=np.asarray(res.diag["betas"])[:used].round(5),
                        ess=ess.round(1),
                        accept=np.asarray(res.diag["accept"])[:used].round(3),
                        final_step=round(float(res.diag["final_step"]), 4),
                        log_z=round(float(res.log_z), 4),
                        err_avg=round(float(np.mean(errs)), 5),
                        err_max=round(float(np.max(errs)), 5))
    report(cfg.metrics_path, **fields)


if __name__ == "__main__":
    main()
