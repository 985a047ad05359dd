"""Image-denoising MRF on the PyTorch port: latent pixels, noisy
observations and a robust truncated edge smoothness (the port's
counterpart of ``examples/run_image_denoise.py``). Runs on the card
unless given --cpu.

    python examples/torch_run_image_denoise.py --engine hmc --cpu
"""

import numpy as np

from torch_common import device_of, make_parser, report, run_engine
from lhvi_tpu_torch.config import EngineConfig, from_args


def main():
    parser = make_parser(EngineConfig(collect="moments"), __doc__)
    parser.add_argument("--rows", type=int, default=16)
    parser.add_argument("--cols", type=int, default=16)
    parser.add_argument("--noise", type=float, default=0.3)
    args = parser.parse_args()
    cfg = from_args(EngineConfig, args)
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.image import denoise_grid

    dev = device_of(args)
    g, rvs, truth, obs = denoise_grid(args.rows, args.cols, noise=args.noise,
                                      seed=cfg.seed)
    fg = compile_graph(g, dev)
    res = run_engine(fg, cfg, torch.Generator(dev).manual_seed(cfg.seed))
    est = np.array(
        [[res.mean(rvs[r][c]) for c in range(args.cols)]
         for r in range(args.rows)]
    )
    mse_est = float(np.mean((est - truth) ** 2))
    mse_obs = float(np.mean((obs - truth) ** 2))
    print(
        f"engine={cfg.engine}  wall={res.wall_s:.2f}s  "
        f"MSE: observed={mse_obs:.4f} -> denoised={mse_est:.4f} "
        f"({mse_obs / max(mse_est, 1e-9):.1f}x)"
    )
    report(cfg.metrics_path, engine=cfg.engine, wall_s=res.wall_s,
           mse_obs=mse_obs, mse_est=mse_est)


if __name__ == "__main__":
    main()
