"""Hybrid MAP inference by stochastic local search (PyTorch port of
``lhvi_tpu/engines/map_search.py``; MaxWalkSAT-style search over hybrid
states).

``n_walkers`` states run in lockstep as a leading tensor axis: each step
every walker either (greedy) applies the best single discrete reassignment,
from the same ``disc_logits`` pass chromatic Gibbs uses, then gradient
ascent on all continuous vars, or (noise) a random perturbation. Both
branches are computed for all walkers and ``torch.where`` keeps each
walker's own (the reference's per-walker ``lax.cond`` under ``vmap``);
the greedy pick reads the current value's logit with a gather. The best
log-probability each walker has seen is tracked on the device; the
global argmax is the MAP estimate.
"""

from __future__ import annotations

import dataclasses

import torch

from lhvi_tpu_torch.fg.compile import CompiledFG


@dataclasses.dataclass(frozen=True)
class MWSConfig:
    n_walkers: int = 64
    n_steps: int = 300
    p_random: float = 0.2
    grad_step: float = 5e-2
    n_grad: int = 3
    noise_scale: float = 0.5


def _grad_logp(fg: CompiledFG, xc, xd):
    """∇_xc log p per walker, ``[W, n_cont]`` (autograd; NaN → 0)."""
    x = xc.detach().requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(torch.sum(fg.log_prob_batched(x, xd)), x)
    return torch.nan_to_num(g)


def greedy_step(fg: CompiledFG, cfg: MWSConfig, xc, xd):
    """The greedy branch for all walkers: the best single discrete
    reassignment where it gains, then ``cfg.n_grad`` clipped gradient
    ascent steps on the continuous vars → ``(xc, xd)``."""
    if fg.n_disc:
        logits = fg.disc_logits(xc, xd)  # [W, n_disc, V]
        cur = torch.gather(logits, -1, xd[..., None])[..., 0]
        gain = torch.amax(logits, dim=-1) - cur
        v = torch.argmax(gain, dim=1)  # [W]
        rows = torch.arange(xd.shape[0], device=xd.device)
        best_val = torch.argmax(logits[rows, v], dim=-1)
        xd = xd.clone()
        xd[rows, v] = torch.where(gain[rows, v] > 0, best_val, xd[rows, v])
    for _ in range(cfg.n_grad if fg.n_cont else 0):
        xc = torch.clamp(xc + cfg.grad_step * _grad_logp(fg, xc, xd),
                         fg.cont_lo, fg.cont_hi)
    return xc, xd


def noisy_step(fg: CompiledFG, cfg: MWSConfig, gen, xc, xd):
    """The noise branch for all walkers: one uniformly chosen discrete var
    set to a uniform value of its domain, and Gaussian noise on the
    continuous vars, clipped to their domains."""
    W, dev = xd.shape[0], xd.device
    if fg.n_disc:
        v = torch.randint(0, fg.n_disc, (W,), generator=gen, device=dev)
        u = torch.rand((W,), generator=gen, device=dev)
        val = torch.floor(u * fg.disc_sizes[v]).to(xd.dtype)
        xd = xd.clone()
        xd[torch.arange(W, device=dev), v] = val
    noise = torch.randn(xc.shape, generator=gen, device=dev)
    xc = torch.clamp(xc + cfg.noise_scale * noise, fg.cont_lo, fg.cont_hi)
    return xc, xd


def run_mws(fg: CompiledFG, gen: torch.Generator,
            cfg: MWSConfig = MWSConfig()):
    """→ ``(best_xc [n_cont], best_xd [n_disc], best log p)`` over all
    walkers and steps (device tensors; nothing is read back)."""
    W = cfg.n_walkers
    xc, xd = fg.init_state_batched(gen, W, 1.0)
    best_e = fg.log_prob_batched(xc, xd)
    best_xc, best_xd = xc, xd
    for _ in range(cfg.n_steps):
        do_random = torch.rand((W,), generator=gen, device=xc.device) \
            < cfg.p_random
        xc_n, xd_n = noisy_step(fg, cfg, gen, xc, xd)
        xc_g, xd_g = greedy_step(fg, cfg, xc, xd)
        xc = torch.where(do_random[:, None], xc_n, xc_g)
        xd = torch.where(do_random[:, None], xd_n, xd_g)
        e = fg.log_prob_batched(xc, xd)
        better = e > best_e
        best_e = torch.where(better, e, best_e)
        best_xc = torch.where(better[:, None], xc, best_xc)
        best_xd = torch.where(better[:, None], xd, best_xd)
    i = torch.argmax(best_e)
    return best_xc[i], best_xd[i], best_e[i]


class HybridMaxWalkSAT:
    """Engine facade: ``HybridMaxWalkSAT(fg).run(gen)`` then ``map(rv)``;
    runs on ``fg.device`` with draws from ``gen``."""

    def __init__(self, fg: CompiledFG, cfg: MWSConfig = MWSConfig()):
        fg.require_whole("HybridMaxWalkSAT")
        self.fg = fg
        self.cfg = cfg
        self.xc = self.xd = self.energy = None

    def run(self, gen: torch.Generator, cfg: MWSConfig = None):
        xc, xd, e = run_mws(self.fg, gen, cfg or self.cfg)
        self.xc, self.xd = xc.cpu().numpy(), xd.cpu().numpy()
        self.energy = float(e)
        return self

    def map(self, rv):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            return self.fg.meta.obs_value(rv)
        if kind == "c":
            return float(self.xc[i])
        return self.fg.meta.disc_values(rv)[int(self.xd[i])]
