"""Shared runner for the PyTorch port's example scripts (the port's
counterpart of ``examples/common.py``).

Build model → run engine(s) → query marginals → compare + report. One
``run_engine`` entry drives any engine of ``lhvi_tpu_torch`` from an
``EngineConfig`` (``lhvi_tpu_torch/config.py``). The device is the card
(``cuda``) unless the script is given ``--cpu``; nothing falls back to
the CPU when no GPU is found.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_of(args) -> str:
    """``"cpu"`` with ``--cpu``, else ``"cuda"`` (the engines raise there
    if no card is present)."""
    return "cpu" if getattr(args, "cpu", False) else "cuda"


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_engine(fg, cfg, gen):
    """Dispatch an EngineConfig to the matching engine on ``fg.device``
    (``gen``: a ``torch.Generator`` there); returns a result object
    exposing mean/var/disc_marginal/map plus ``wall_s``, the seconds from
    the call to the answer, the device waited on at both ends."""
    from lhvi_tpu_torch.engines import hmc, nuts, smc, vi
    from lhvi_tpu_torch.engines.epbp import EPBP, EPBPConfig
    from lhvi_tpu_torch.engines.lbp import HybridLBP
    from lhvi_tpu_torch.engines.map_search import HybridMaxWalkSAT

    sync(fg.device)
    t0 = time.perf_counter()
    e = cfg.engine
    if e in ("nuts", "hmc"):
        mod = nuts if e == "nuts" else hmc
        res = mod.sample(fg, gen, n_chains=cfg.n_chains,
                         n_warmup=cfg.n_warmup, n_samples=cfg.n_samples,
                         collect=cfg.collect)
    elif e == "vi":
        res = vi.infer(fg, gen, vi.VIConfig(K=cfg.vi_k, n_iters=cfg.vi_iters,
                                            lr=cfg.vi_lr))
    elif e == "smc":
        res = smc.sample(fg, gen, smc.SMCConfig(
            n_particles=cfg.smc_particles, n_temps=cfg.smc_temps,
            adaptive=getattr(cfg, "smc_adaptive", False)))
    elif e == "lbp":
        res = HybridLBP(fg).run(cfg.bp_iters)
    elif e == "epbp":
        res = EPBP(fg, EPBPConfig(cfg.particles, cfg.bp_iters)).run(gen)
    elif e == "mws":
        res = HybridMaxWalkSAT(fg).run(gen)
    else:
        raise ValueError(f"unknown engine {e!r}")
    sync(fg.device)
    res.wall_s = time.perf_counter() - t0
    return res


def make_parser(cfg, desc: str) -> argparse.ArgumentParser:
    from lhvi_tpu_torch.config import add_args

    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    add_args(p, cfg)
    return p


def report(path, **fields) -> None:
    """Append one ``result`` record (the numbers the script printed) to the
    JSONL file ``path``, where one is given (``--metrics-path``)."""
    if not path:
        return
    from lhvi_tpu_torch.utils.metrics import MetricsLogger

    with MetricsLogger(path) as log:
        log.log("result", **fields)
