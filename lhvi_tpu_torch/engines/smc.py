"""Annealed Sequential Monte Carlo with systematic resampling (PyTorch port
of ``lhvi_tpu/engines/smc.py``).

Particles start from a broad base q0 and follow the path
``log π_β = (1−β)·log q0 + β·log p`` over a β schedule (a fixed grid, or
the adaptive CESS-targeted one), with

- importance reweighting between temperatures and a running log-Z; the
  normalization, ESS and cumulative weights are ONE launch of kernel K4
  (``ops.resample.weight_pipeline``) per temperature;
- ESS-triggered systematic resampling: the parents are computed every
  temperature and selected with ``torch.where`` on the device-side ESS
  flag, as the reference's ``lax.cond`` — no host read;
- HMC rejuvenation moves on the continuous latents: leapfrog on the
  tempered target (``ops.logpot``: autograd by default, the fused
  log-potential kernel K5 with ``fused_logpot``), the fused dense
  leapfrog (K1, ``quad_moves``), or on sparse quadratic targets the banded
  proposal (K2) or the ELL leapfrog; after each, a tempered Gibbs sweep
  over the discrete latents (the conditionals' logits times β; uniform
  base over the discrete latents): through the color plan
  (``hmc.gibbs_sweep_planned``) where the model has one, else the
  all-rows sweep (``hmc.gibbs_sweep``); with ``mode_swap`` the
  collapsed orbit-flip move at β follows each sweep
  (``engines/modeswap.py``).

On the fixed schedule a temperature reads nothing back to the host. The
adaptive schedule reads one flag per temperature (``β < 1``, the
reference's ``lax.cond``) and stops the loop once β reaches 1.

``shard`` (a ``parallel.ChainShard``) splits the particles over the ranks
of a process group, the collective resampler: each rank moves its own
block with its own generator (K5 or autograd per rank), while the
incremental log-weights are assembled over the ranks (an ``all_reduce``
into zeros) and every rank runs K4 on the whole vector. K4 is bitwise
reproducible, so every rank holds the same normalized weights, cumulative
sum, step log Z and ESS; the systematic offset comes from the generator
all ranks share, so every rank computes the same ancestors. Where the ESS
calls for it (a host read per temperature under ``shard``), the particles
are assembled the same way and each rank takes its ancestors' rows. The
adaptive schedule's bisection runs on the assembled vectors, so every
rank picks the same β, and the acceptance behind the step adaptation is
averaged over the ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from lhvi_tpu_torch.engines.hmc import (
    _ensure_mode_swap_plan,
    _to_numpy,
    gibbs_sweep,
    gibbs_sweep_planned,
)
from lhvi_tpu_torch.fg.compile import CompiledFG
from lhvi_tpu_torch.ops.resample import systematic_parents, weight_pipeline
from lhvi_tpu_torch.parallel.mesh import (all_reduce, assemble_rows,
                                          local_count, split_generator)
from lhvi_tpu_torch.utils.debug import check_nan


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    n_particles: int = 1024
    n_temps: int = 40
    n_moves: int = 2
    n_leapfrog: int = 5
    step_size: float = 0.25
    ess_frac: float = 0.5
    base_scale: float = 2.0
    # fused dense leapfrog (K1) on the blended tempered (J, h) of a
    # pure-quadratic model; sparse (ELL/DIA) models always take their
    # fused move, as in the reference
    quad_moves: bool = False
    # fused log-potential kernel (K5) for non-quadratic tempered moves
    # (as HMCConfig.fused_logpot)
    fused_logpot: bool = False
    # CESS-targeted β schedule (``n_temps`` is the cap) plus deadband
    # Robbins–Monro adaptation of the rejuvenation step size
    adaptive: bool = False
    ess_target: float = 0.9
    target_accept: float = 0.65
    rm_gain: float = 0.5
    # orbit-level mode-swap MH move after each tempered Gibbs stage
    mode_swap: bool = False


class SMCState(NamedTuple):
    xc: torch.Tensor  # [N, n_cont] (this rank's rows under a shard)
    xd: torch.Tensor  # [N, n_disc] (likewise)
    log_w: torch.Tensor  # [N] of all particles, normalized (logsumexp 0)
    log_z: torch.Tensor  # 0-d running evidence estimate


def _base_log_prob(fg: CompiledFG, cfg: SMCConfig, xc):
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    scale = cfg.base_scale * torch.ones_like(mid)
    z = (xc - mid) / scale
    lp = torch.sum(-0.5 * z * z - torch.log(scale)
                   - 0.5 * math.log(2 * math.pi), dim=-1)
    # uniform base over discrete latents (constant, keeps log-Z honest)
    return lp - torch.sum(torch.log(fg.disc_sizes.to(torch.float32)))


def systematic_resample(gen, log_w, n: int):
    """Systematic resampling: i64 [n] parent indices from one uniform
    drawn from ``gen`` (no host read)."""
    cum = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    u0 = torch.rand((), generator=gen, device=log_w.device)
    return systematic_parents(u0, cum, n)


def _choose_beta(log_w, delta_lp, beta, target_log_cess, n_iters: int = 26):
    """Largest β′ ∈ (β, 1] whose conditional ESS stays ≥ the target.

    CESS = N·(Σ W u)² / Σ W u² with u = exp(Δβ·delta_lp) and ``log_w``
    normalized; monotone decreasing in Δβ, so bisection converges. A
    1e-3·(1−β) floor keeps the anneal moving. The reference's
    ``lax.cond(ok(1 − β))`` becomes a ``torch.where`` over both branches,
    so nothing is read back.
    """
    hi0 = 1.0 - beta
    log_n = math.log(1.0 * log_w.shape[0])

    def ok(d):
        lcess = log_n + 2.0 * torch.logsumexp(log_w + d * delta_lp, 0) \
            - torch.logsumexp(log_w + 2.0 * d * delta_lp, 0)
        return lcess >= target_log_cess

    lo = torch.zeros((), device=log_w.device)
    hi = hi0
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        good = ok(mid)
        lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid)
    delta = torch.where(ok(hi0), hi0, lo)
    return beta + torch.maximum(delta, hi0 * 1e-3)


def _delta_lp(fg: CompiledFG, cfg: SMCConfig, state: SMCState, shard=None):
    """log p − log q0 of every particle, ``[N]`` (assembled over the ranks
    under ``shard``)."""
    d = (fg.log_prob_batched(state.xc, state.xd)
         - _base_log_prob(fg, cfg, state.xc))
    return assemble_rows(d, shard)


def _reweight_resample(fg: CompiledFG, cfg: SMCConfig, state: SMCState,
                       beta_prev, beta, u0, delta_lp=None, shard=None):
    """Reweight to β, update log Z, and resample where the ESS fell below
    ``ess_frac·N`` — every step on the device (under ``shard`` the ESS
    flag is read back, and the particles assembled only to resample).
    ``u0`` is the systematic resampler's uniform (a 0-d tensor);
    ``delta_lp`` covers all N particles. Returns ``(state, ess)``."""
    N = state.log_w.shape[0]
    if delta_lp is None:
        delta_lp = _delta_lp(fg, cfg, state, shard)
    lw_norm, cum, step_z, ess = weight_pipeline(
        state.log_w + (beta - beta_prev) * delta_lp)
    idx = systematic_parents(u0, cum, N)
    need = ess < cfg.ess_frac * N
    if shard is None:
        xc = torch.where(need, state.xc[idx], state.xc)
        xd = torch.where(need, state.xd[idx], state.xd)
    elif bool(need):
        lo, hi = shard.rows(N)
        xc = assemble_rows(state.xc, shard)[idx[lo:hi]]
        xd = assemble_rows(state.xd, shard)[idx[lo:hi]]
    else:
        xc, xd = state.xc, state.xd
    log_w = torch.where(need, torch.full_like(lw_norm, -math.log(1.0 * N)),
                        lw_norm)
    return SMCState(xc, xd, log_w, state.log_z + step_z), ess


def _log_acc(h0, h1):
    """min(0, h0 − h1), −inf where the end energy is not finite."""
    return torch.where(torch.isfinite(h1), torch.clamp(h0 - h1, max=0.0),
                       torch.full((), -math.inf, device=h1.device))


def _mh(gen, xc, x1, log_acc):
    """Accept where log u < log_acc (NaN never accepts)."""
    u = torch.rand((xc.shape[0],), generator=gen, device=xc.device)
    ok = torch.log(u) < log_acc
    return torch.where(ok[:, None], x1, xc), ok


def move_batched(fg: CompiledFG, cfg: SMCConfig, gen, xc, xd, beta, step):
    """HMC move on the tempered target through ``ops.logpot``: autograd
    over ``log_prob_cont_batched``, or kernel K5 with ``cfg.fused_logpot``
    (``plan="auto"``); the base-measure constants it drops cancel in
    h0 − h1."""
    from lhvi_tpu_torch.ops.logpot import logpot_leapfrog

    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    scale = cfg.base_scale * torch.ones_like(mid)
    p0 = torch.randn(xc.shape, generator=gen, device=xc.device)
    x1, p1, lp0, lp1 = logpot_leapfrog(
        fg, xc, p0, xd, torch.ones_like(mid), step, cfg.n_leapfrog,
        beta=beta, base_mid=mid, base_inv_s2=1.0 / (scale * scale),
        plan="auto" if cfg.fused_logpot else None)
    h0 = -lp0 + 0.5 * torch.sum(p0 * p0, -1)
    h1 = -lp1 + 0.5 * torch.sum(p1 * p1, -1)
    return _mh(gen, xc, x1, _log_acc(h0, h1))


def move_quad(fg: CompiledFG, cfg: SMCConfig, gen, xc, beta, step):
    """The tempered target of a dense pure-quadratic model is itself
    quadratic — β·(J, h) + (1−β)·(I/s², mid/s²) — so every particle rides
    the fused leapfrog (K1 on CUDA tensors)."""
    from lhvi_tpu_torch.ops.leapfrog import quad_leapfrog

    s2 = cfg.base_scale ** 2
    n = fg.n_cont
    dev = xc.device
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    Jb = (beta * fg.quad_J + (1.0 - beta) * torch.eye(n, device=dev) / s2
          ).contiguous()
    hb = beta * fg.quad_h + (1.0 - beta) * mid / s2

    def lp(X):
        return -0.5 * torch.sum((X @ Jb) * X, -1) + X @ hb

    p0 = torch.randn(xc.shape, generator=gen, device=dev)
    x1, p1 = quad_leapfrog(xc, p0, Jb, hb, torch.ones(n, device=dev), step,
                           cfg.n_leapfrog)
    h0 = -lp(xc) + 0.5 * torch.sum(p0 * p0, -1)
    h1 = -lp(x1) + 0.5 * torch.sum(p1 * p1, -1)
    return _mh(gen, xc, x1, _log_acc(h0, h1))


def move_quad_sparse(fg: CompiledFG, cfg: SMCConfig, gen, xc, beta, step):
    """The tempered target of a sparse quadratic model keeps its neighbour
    table: β·(diag, w, h) + (1−β)·(1/s², 0, mid/s²). Banded targets take
    the whole-trajectory DIA proposal (K2 on CUDA tensors; the β-blend in
    latent space, before the embedding, so the prior's diagonal never lands
    on gap lanes); others the ELL leapfrog."""
    from lhvi_tpu_torch.ops.dia import DIA_MAX_EMB, dia_hmc_proposal
    from lhvi_tpu_torch.ops.leapfrog import ell_quad_leapfrog

    s2 = cfg.base_scale ** 2
    dev = xc.device
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    ones = torch.ones(fg.n_cont, device=dev)
    diag_b = beta * fg.quad_diag + (1.0 - beta) / s2
    hb = beta * fg.quad_h + (1.0 - beta) * mid / s2
    if (fg.quad_dia_offsets is not None
            and fg.quad_dia_w.shape[1] <= DIA_MAX_EMB):
        x1, log_acc = dia_hmc_proposal(
            gen, xc, diag_b, fg.quad_dia_offsets,
            (beta * fg.quad_dia_w).contiguous(), hb, ones, step,
            cfg.n_leapfrog, pos=fg.quad_dia_pos, inv=fg.quad_dia_inv)
        return _mh(gen, xc, x1, log_acc)
    p0 = torch.randn(xc.shape, generator=gen, device=dev)
    x1, p1, g0, g1 = ell_quad_leapfrog(
        xc, p0, diag_b, fg.quad_ell_col, beta * fg.quad_ell_w, hb, ones,
        step, cfg.n_leapfrog)
    lp0 = 0.5 * torch.sum(xc * (hb[None] + g0), -1)
    lp1 = 0.5 * torch.sum(x1 * (hb[None] + g1), -1)
    h0 = -lp0 + 0.5 * torch.sum(p0 * p0, -1)
    h1 = -lp1 + 0.5 * torch.sum(p1 * p1, -1)
    return _mh(gen, xc, x1, _log_acc(h0, h1))


def _rejuvenate(fg: CompiledFG, cfg: SMCConfig, gen, xc, xd, beta, step):
    """cfg.n_moves moves at β, each an HMC move of the continuous latents,
    then a tempered Gibbs sweep of the discrete ones and, with
    ``cfg.mode_swap``, the mode-swap move at β →
    ``(xc, xd, mean acceptance over the moves)``."""
    accs = []
    for _ in range(cfg.n_moves):
        if fg.n_cont and fg.cont_pure_quad and fg.quad_sparse:
            xc, ok = move_quad_sparse(fg, cfg, gen, xc, beta, step)
        elif fg.n_cont and fg.cont_pure_quad and cfg.quad_moves:
            xc, ok = move_quad(fg, cfg, gen, xc, beta, step)
        elif fg.n_cont:
            xc, ok = move_batched(fg, cfg, gen, xc, xd, beta, step)
        else:
            ok = torch.ones((xc.shape[0],), dtype=torch.bool,
                            device=xc.device)
        sweep = (gibbs_sweep_planned if fg.color_plan is not None
                 else gibbs_sweep)
        xd = sweep(fg, gen, xc, xd, beta=beta)  # no-op without n_disc
        if cfg.mode_swap and fg.mode_swap_plan is not None:
            from lhvi_tpu_torch.engines.modeswap import mode_swap_sweep

            xd, _ = mode_swap_sweep(fg, gen, xc, xd, fg.mode_swap_plan,
                                    beta=beta)
        accs.append(torch.mean(ok.to(torch.float32)))
    return xc, xd, torch.mean(torch.stack(accs))


def run_smc(fg: CompiledFG, gen: torch.Generator,
            cfg: SMCConfig = SMCConfig(), shard=None):
    """Returns ``(xc [N, n_cont], xd [N, n_disc], log_w [N], log_z, diag)``
    with ``diag`` holding the per-temperature traces (``ess``, ``accept``,
    ``betas``), ``log_z``, ``n_temps_used`` and ``final_step``.

    ``gen`` (a ``torch.Generator`` on ``fg.device``) drives every draw.
    Under ``shard`` (see the module docstring) this rank moves
    ``n_particles / world`` particles (a count that does not divide
    raises) from ``split_generator(gen, rank)[0]``, and returns its rows of
    ``xc``, ``xd`` and ``log_w`` (normalized over all particles); log Z and
    ``diag`` are the same on every rank.
    """
    fg.require_whole("run_smc")
    fg, cfg = _ensure_mode_swap_plan(fg, cfg)
    N = cfg.n_particles
    n_loc = local_count(N, shard)
    dev = fg.device
    gen, shared = ((gen, gen) if shard is None
                   else split_generator(gen, shard.rank))
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    xc = mid + cfg.base_scale * torch.randn((n_loc, fg.n_cont),
                                            generator=gen, device=dev)
    u = torch.rand((n_loc, fg.n_disc), generator=gen, device=dev)
    xd = torch.floor(u * fg.disc_sizes).to(torch.int64)
    state = SMCState(xc, xd, torch.full((N,), -math.log(1.0 * N), device=dev),
                     torch.zeros((), device=dev))

    def anneal_step(state, beta_prev, beta, step, delta_lp=None):
        u0 = torch.rand((), generator=shared, device=dev)
        state, ess = _reweight_resample(fg, cfg, state, beta_prev, beta, u0,
                                        delta_lp, shard)
        xc, xd, acc = _rejuvenate(fg, cfg, gen, state.xc, state.xd, beta,
                                  step)
        if shard is not None:
            acc = all_reduce(acc, shard) / shard.world
        check_nan("smc temperature", xc=xc, log_w=state.log_w,
                  log_z=state.log_z)
        return state._replace(xc=xc, xd=xd), ess, acc

    ess_tr, acc_tr, beta_tr = [], [], []
    if not cfg.adaptive:
        betas = torch.linspace(0.0, 1.0, cfg.n_temps + 1, device=dev)
        for t in range(cfg.n_temps):
            state, ess, acc = anneal_step(state, betas[t], betas[t + 1],
                                          cfg.step_size)
            ess_tr.append(ess)
            acc_tr.append(acc)
            beta_tr.append(betas[t + 1])
        n_used = torch.full((), cfg.n_temps, dtype=torch.int32, device=dev)
        final_step = torch.full((), cfg.step_size, device=dev)
    else:
        target_log_cess = torch.log(torch.full((), cfg.ess_target * N,
                                               device=dev))
        beta_prev = torch.zeros((), device=dev)
        log_step = torch.log(torch.full((), cfg.step_size, device=dev))
        for t in range(cfg.n_temps):
            # the reference's lax.cond(beta_prev < 1): the one host read
            # of a temperature; once β = 1 the remaining steps are no-ops
            if not bool(beta_prev < 1.0):
                skipped = cfg.n_temps - t
                ess_tr += [torch.full((), 1.0 * N, device=dev)] * skipped
                acc_tr += [torch.ones((), device=dev)] * skipped
                beta_tr += [beta_prev] * skipped
                break
            delta_lp = _delta_lp(fg, cfg, state, shard)
            beta = _choose_beta(state.log_w, delta_lp, beta_prev,
                                target_log_cess)
            # the cap must never truncate the anneal short of β = 1
            if t >= cfg.n_temps - 1:
                beta = torch.ones((), device=dev)
            state, ess, acc = anneal_step(state, beta_prev, beta,
                                          torch.exp(log_step), delta_lp)
            # deadband Robbins–Monro: shrink below target, grow only
            # above 0.95
            delta = torch.where(acc < cfg.target_accept,
                                acc - cfg.target_accept,
                                torch.clamp(acc - 0.95, min=0.0))
            log_step = log_step + cfg.rm_gain * delta
            ess_tr.append(ess)
            acc_tr.append(acc)
            beta_tr.append(beta)
            beta_prev = beta
        bt = torch.stack(beta_tr)
        n_used = torch.sum(torch.cat([torch.zeros((1,), device=dev),
                                      bt[:-1]]) < 1.0).to(torch.int32)
        final_step = torch.exp(log_step)
    diag = {"ess": torch.stack(ess_tr), "accept": torch.stack(acc_tr),
            "log_z": state.log_z, "betas": torch.stack(beta_tr),
            "n_temps_used": n_used, "final_step": final_step}
    log_w = state.log_w
    if shard is not None:
        lo, hi = shard.rows(N)
        log_w = log_w[lo:hi]
    return state.xc, state.xd, log_w, state.log_z, diag


class SMCResult:
    """Weighted-particle queries."""

    def __init__(self, fg: CompiledFG, xc, xd, log_w, log_z, diag):
        self.fg = fg
        self.xc = _to_numpy(xc)
        self.xd = _to_numpy(xd)
        self.w = _to_numpy(torch.softmax(log_w.to(torch.float64), dim=0))
        self.log_z = float(log_z)
        self.diag = {k: _to_numpy(v) for k, v in diag.items()}

    def _loc(self, rv, want):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if kind != want:
            raise ValueError(f"{rv} is {'continuous' if kind == 'c' else 'discrete'}")
        return i

    def mean(self, rv) -> float:
        i = self._loc(rv, "c")
        return float(np.sum(self.w * self.xc[:, i]))

    def var(self, rv) -> float:
        i = self._loc(rv, "c")
        m = self.mean(rv)
        return float(np.sum(self.w * (self.xc[:, i] - m) ** 2))

    def disc_marginal(self, rv) -> np.ndarray:
        i = self._loc(rv, "d")
        out = np.zeros(self.fg.meta.disc_size(rv))
        np.add.at(out, self.xd[:, i], self.w)
        return out

    def map(self, rv):
        kind, _ = self.fg.meta.loc(rv)
        if kind == "c":
            return self.mean(rv)
        p = self.disc_marginal(rv)
        return self.fg.meta.disc_values(rv)[int(p.argmax())]


def sample(fg: CompiledFG, gen, cfg: SMCConfig = SMCConfig(),
           shard=None) -> SMCResult:
    xc, xd, log_w, log_z, diag = run_smc(fg, gen, cfg, shard=shard)
    return SMCResult(fg, xc, xd, log_w, log_z, diag)
