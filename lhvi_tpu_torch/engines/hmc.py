"""HMC-within-Gibbs sampler for hybrid MRFs (PyTorch port of
``lhvi_tpu/engines/hmc.py``).

Each transition is a chromatic Gibbs sweep over the discrete latents, then
one HMC proposal (leapfrog + Metropolis correction) for the continuous
latents, with dual-averaging step-size adaptation and diagonal
mass-matrix adaptation; chains are a leading tensor axis.

- Gibbs: the compiler's per-color plan (``CompiledFG.color_plan``) gives
  each color class exactly its adjacent factor rows; a sweep evaluates
  them for all chains at once and draws every class's new values with one
  Gumbel-max categorical (``gibbs_sweep_planned``). ``gibbs_max_colors >
  0`` keeps the reference's rotated all-rows path (``gibbs_sweep``).
- HMC on models whose continuous energy is entirely the fused quadratic
  form (``CompiledFG.cont_pure_quad``): one fused proposal, routed in the
  reference's order: banded DIA (kernel K2), sparse ELL (torch ops), dense
  (kernel K1).
- HMC on other (non-quadratic) targets: ``ops.logpot.logpot_leapfrog``,
  by autograd over ``log_prob_cont_batched`` by default, or through the
  fused log-potential kernel K5 with ``fused_logpot=True``.

The reference's ``lax.scan``/``fori_loop``/``vmap`` become Python loops
over static colors and steps and a written-out chain axis. Nothing in a
transition reads a device value back: the step size ``exp(log_eps)``
stays a 0-d device tensor that the kernels read through a pointer, and
K2's per-proposal momentum stream is keyed on the host by the generator's
seed and its Philox offset, which each proposal advances.

``mode_swap=True`` adds the collapsed orbit-flip move
(``engines/modeswap.py``) after the Gibbs stage; its plan is built on the
host at the run's start, and ``mode_swap_every > 1`` gates the move on a
host generator seeded once from the run's generator.

``shard`` (a ``parallel.ChainShard``) splits the chains over the ranks of
a process group: each rank runs its block of chains with its own
generator and its own kernel launches, and the cross-chain quantities
(the acceptance behind dual averaging, the batched Welford update, the
moment sums, the streamed diagnostics) go through the collectives of
``parallel/mesh.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from lhvi_tpu_torch.fg.compile import _NEG_BIG, CompiledFG
from lhvi_tpu_torch.ops import moments as _moments
from lhvi_tpu_torch.ops.dia import _kinetic
from lhvi_tpu_torch.ops.nuts_traj import momentum_std
from lhvi_tpu_torch.parallel.mesh import (all_reduce, assemble_rows,
                                          local_count, n_chain_shards,
                                          split_generator)
from lhvi_tpu_torch.utils.debug import check_nan
from lhvi_tpu_torch.utils.metrics import count, span


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    n_leapfrog: int = 8
    init_step_size: float = 0.1
    target_accept: float = 0.8
    gibbs_sweeps: int = 1
    gibbs_max_colors: int = 0
    adapt_mass: bool = True
    jitter: float = 1.0
    # fused log-potential kernel for non-quadratic targets (K5; on CUDA
    # tensors it raises where K5 cannot run the graph, see
    # ops.logpot.kernel_plan; on CPU tensors the autograd path runs)
    fused_logpot: bool = False
    # the reference's lax.scan unroll factor of the planned sweep; a
    # Python loop has no counterpart, so it is accepted and ignored
    gibbs_unroll: int = 1
    # banded (DIA) fused proposal (K2) on ELL targets whose offsets form a
    # small static set; False keeps the ELL gather·FMA path
    dia_kernel: bool = True
    # orbit-level mode-swap MH move after each Gibbs stage
    # (engines/modeswap.py); the plan is built on demand
    mode_swap: bool = False
    # apply the move with probability 1/every per transition (a
    # random-scan mixture: exact)
    mode_swap_every: int = 1


class HMCState(NamedTuple):
    xc: torch.Tensor  # [C, n_cont]
    xd: torch.Tensor  # [C, n_disc]
    log_eps: torch.Tensor  # dual-averaging state (0-d tensors)
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor
    welford_mean: torch.Tensor  # [n_cont]
    welford_m2: torch.Tensor
    welford_n: torch.Tensor
    inv_mass: torch.Tensor  # [n_cont] diagonal
    # the mode-swap move's acceptance accumulators (0-d; stay 0 while the
    # move is off)
    ms_acc_sum: torch.Tensor
    ms_acc_n: torch.Tensor


# ---- chromatic Gibbs over the discrete latents ---------------------------


def categorical(gen, logits):
    """One draw per row of ``logits [..., V]`` by Gumbel-max (the
    reference's ``jax.random.categorical``; uniforms floored at the
    smallest normal f32, as its ``gumbel``)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _values_of(vals, idx):
    """``vals[i, idx[..., i]]``: the domain VALUES ``[C, m]`` of index
    states ``idx [C, m]`` from a per-var value table ``vals [m, V]``, in
    one gather."""
    return torch.gather(vals.expand((idx.shape[0],) + vals.shape), 2,
                        idx[..., None])[..., 0]


def state_values(fg: CompiledFG, xd):
    """Discrete index state ``[C, n_disc]`` → domain VALUES ``[C, n_disc]``
    (one gather from the per-var value table)."""
    return _values_of(fg.disc_vals, xd)


def gibbs_sweep(fg: CompiledFG, gen, xc, xd, max_colors: int = 0,
                beta=1.0):
    """Chromatic-Gibbs sweep over the discrete latents of all chains
    through the all-rows ``disc_logits``. ``max_colors > 0`` processes
    only that many color classes, starting at a random rotation per chain
    (random-scan Gibbs with capped per-sweep cost). ``beta`` tempers the
    conditionals, one categorical over ``beta · disc_logits`` per color
    (SMC's tempered Gibbs on models without a color plan)."""
    if fg.n_disc == 0:
        return xd
    C, dev = xd.shape[0], xd.device
    n = fg.n_colors
    if 0 < max_colors < n:
        off = torch.randint(0, n, (C,), generator=gen, device=dev)
        n = max_colors
    else:
        off = torch.zeros((C,), dtype=torch.int64, device=dev)
    for s in range(n):
        color = (off + s) % fg.n_colors
        new = categorical(gen, beta * fg.disc_logits(xc, xd))
        xd = torch.where(fg.color_of[None, :] == color[:, None], new, xd)
    return xd


def _color_tabs(grp, j: int):
    """The group's bucket tables at color ``j`` (leading axis removed)."""
    out = []
    for t in grp.bucket_tabs:
        if t is None:
            out.append(None)
            continue
        out.append({k: (None if v is None
                        else {pk: pv[j] for pk, pv in v.items()}
                        if isinstance(v, dict) else v[j])
                    for k, v in t.items()})
    return out


def _color_class_logits(fg: CompiledFG, grp, tabs, xc, xd, xv):
    """Full-conditional logits ``[C, M, V]`` of one color class of a
    ``GibbsColorPlan`` group for all chains; ``tabs`` are the group's
    tables at one color; ``xv`` is the value state ``state_values(fg,
    xd)`` (``None`` when values are indices). Value lookups stay in value
    space through the plan's ``disc_cval``/``sub_vals`` tables."""
    V, M, C = fg.max_v, grp.n_vars, xc.shape[0]
    dev = xc.device
    logits = torch.zeros((C, M, V), device=dev)
    cand = torch.arange(V, device=dev)
    for b, t in zip(fg.buckets, tabs):
        if t is None:
            continue
        R, ad = t["disc_idx"].shape
        if xc.shape[1]:
            xcs = torch.where(t["cont_mask"][None] > 0, xc[:, t["cont_idx"]],
                              t["cont_const"][None])
        else:
            xcs = t["cont_const"][None].expand((C,) + t["cont_const"].shape)
        lat = (t["disc_mask"] > 0)[None]
        cval = (t["disc_const"].to(torch.float32) if t["disc_cval"] is None
                else t["disc_cval"])[None]
        if xd.shape[1]:
            xdi = torch.where(lat, xd[:, t["disc_idx"]], t["disc_const"][None])
            xdv = torch.where(lat, xdi.to(torch.float32) if xv is None
                              else xv[:, t["disc_idx"]], cval)
        else:
            xdi = t["disc_const"][None].expand(C, R, ad)
            xdv = cval.expand(C, R, ad)
        sub = t["sub"][None, :, None, :]
        # [C, R, V, ad]: all slots of the target var move jointly
        xdi_p = torch.where(sub, cand[None, None, :, None], xdi[:, :, None, :])
        sub_vals = (cand.to(torch.float32)[None, :] if t["sub_vals"] is None
                    else t["sub_vals"])
        xdv_p = torch.where(sub, sub_vals[None, :, :, None],
                            xdv[:, :, None, :])
        params = {k: v.reshape((1, R, 1) + v.shape[1:])
                  for k, v in t["params"].items()}
        lp = b.kernel(params, xcs[:, :, None, :], xdi_p, xdv_p)  # [C, R, V]
        contrib = (torch.nan_to_num(lp, neginf=_NEG_BIG)
                   * t["w"][None, :, None])
        # scatter-free per-var reduction: vidx [M, D] indexes this color's
        # rows (R = appended zero row)
        contrib = torch.cat([contrib, torch.zeros((C, 1, V), device=dev)], 1)
        logits = logits + torch.sum(contrib[:, t["vidx"]], dim=2)
    return logits


def gibbs_sweep_planned(fg: CompiledFG, gen, xc, xd, beta=1.0):
    """One full exact chromatic sweep of all chains through the per-color
    plan: each color step evaluates only the factor rows adjacent to that
    color's variables; ``beta`` tempers the conditionals. Padded class
    slots (var id ``n_disc``) write to a spare column that is dropped at
    the end."""
    if fg.n_disc == 0:
        return xd
    V, C = fg.max_v, xd.shape[0]
    dev = xd.device
    spare = torch.zeros((C, 1), dtype=xd.dtype, device=dev)
    xd = torch.cat([xd, spare], dim=1)
    vai = fg.color_plan.values_are_indices
    xv = None if vai else torch.cat(
        [state_values(fg, xd[:, :-1]), spare.to(torch.float32)], dim=1)
    cand = torch.arange(V, device=dev)
    for grp in fg.color_plan.groups:
        for j in range(grp.n_colors):
            logits = _color_class_logits(fg, grp, _color_tabs(grp, j), xc,
                                         xd, xv)
            valid = cand[None, :] < grp.sizes[j][:, None]
            logits = torch.where(valid[None], beta * logits,
                                 torch.full((), _NEG_BIG, device=dev))
            new = categorical(gen, logits)  # [C, M]
            xd[:, grp.vars_[j]] = new
            if xv is not None:
                xv[:, grp.vars_[j]] = _values_of(grp.vals_[j], new)
    return xd[:, :-1]


def planned_logits(fg: CompiledFG, xc, xd, cells=None):
    """``disc_logits``-shaped logits ``[C, n_disc, V]`` (or ``[n_disc, V]``
    for one state) assembled from the color plan at a FIXED state: the
    exact-identity hook that proves the plan matches ``disc_logits``.
    ``cells`` (``(group, colour)`` pairs of the plan) restricts the pass
    to those colour classes; the other variables' valid entries stay 0."""
    if xc.dim() == 1:
        return planned_logits(fg, xc[None], xd[None], cells)[0]
    V, C = fg.max_v, xc.shape[0]
    dev = xc.device
    out = torch.zeros((C, fg.n_disc + 1, V), device=dev)
    xv = (None if fg.color_plan.values_are_indices
          else state_values(fg, xd))
    groups = fg.color_plan.groups
    if cells is None:
        cells = [(gi, j) for gi, grp in enumerate(groups)
                 for j in range(grp.n_colors)]
    for gi, j in cells:
        grp = groups[gi]
        out[:, grp.vars_[j]] = _color_class_logits(
            fg, grp, _color_tabs(grp, j), xc, xd, xv)
    valid = torch.arange(V, device=dev)[None, :] < fg.disc_sizes[:, None]
    return torch.where(valid[None], out[:, : fg.n_disc],
                       torch.full((), _NEG_BIG, device=dev))


def _sweep_work(fg: CompiledFG, planned: bool, max_colors: int) -> tuple:
    """(colour classes, factor rows × candidate values) one sweep
    evaluates, from the plan's table shapes on the host: on the planned
    path each class's (padded) adjacent rows, on the all-rows path every
    discrete slot of every row of a bucket with one, for each class
    processed."""
    V = fg.max_v
    if planned:
        classes = rows = 0
        for grp in fg.color_plan.groups:
            classes += grp.n_colors
            rows += grp.n_colors * V * sum(t["w"].shape[1]
                                           for t in grp.bucket_tabs
                                           if t is not None)
        return classes, rows
    classes = (max_colors if 0 < max_colors < fg.n_colors
               else fg.n_colors)
    return classes, classes * V * sum(b.ad * b.n_factors
                                      for b in fg.buckets)


def sweep_all(fg: CompiledFG, cfg: HMCConfig, gen, xc, xd):
    """cfg.gibbs_sweeps chromatic sweeps over all chains: through the
    per-color plan when the model has one, else (or with
    ``gibbs_max_colors > 0``) through the rotated all-rows path. Counted
    as ``hmc.sweep_classes`` (colour classes drawn, all chains at once)
    and ``hmc.sweep_rows`` (factor rows × candidate values evaluated);
    timed as span ``hmc.sweep``. A model without discrete latents
    returns at once, counting and timing nothing."""
    if fg.n_disc == 0:
        return xd
    planned = fg.color_plan is not None and cfg.gibbs_max_colors == 0
    classes, rows = _sweep_work(fg, planned, cfg.gibbs_max_colors)
    count("hmc.sweep_classes", classes * cfg.gibbs_sweeps)
    count("hmc.sweep_rows", rows * cfg.gibbs_sweeps)
    with span("hmc.sweep"):
        for _ in range(cfg.gibbs_sweeps):
            if planned:
                xd = gibbs_sweep_planned(fg, gen, xc, xd)
            else:
                xd = gibbs_sweep(fg, gen, xc, xd, cfg.gibbs_max_colors)
    return xd


def _use_dia(fg: CompiledFG, cfg: HMCConfig) -> bool:
    from lhvi_tpu_torch.ops.dia import DIA_MAX_EMB

    return (fg.quad_sparse and fg.quad_dia_offsets is not None
            and cfg.dia_kernel and fg.quad_dia_w.shape[1] <= DIA_MAX_EMB)


def _quad_proposal(fg: CompiledFG, cfg: HMCConfig, xc, p0, eps, inv_mass):
    """Dense or ELL trajectory from momenta ``p0`` →
    ``(x1, log_acc)`` with non-finite log-accepts mapped to −inf."""
    from lhvi_tpu_torch.ops.leapfrog import ell_quad_leapfrog, quad_leapfrog

    if fg.quad_sparse:
        x1, p1, g0, g1 = ell_quad_leapfrog(
            xc, p0, fg.quad_diag, fg.quad_ell_col, fg.quad_ell_w,
            fg.quad_h, inv_mass, eps, cfg.n_leapfrog,
        )
        hq = fg.quad_h[None, :]
        lp0 = fg.quad_c + 0.5 * torch.sum(xc * (hq + g0), dim=-1)
        lp1 = fg.quad_c + 0.5 * torch.sum(x1 * (hq + g1), dim=-1)
    else:
        x1, p1 = quad_leapfrog(xc, p0, fg.quad_J, fg.quad_h, inv_mass, eps,
                               cfg.n_leapfrog)
        lp0 = fg.quad_log_prob_batched(xc)
        lp1 = fg.quad_log_prob_batched(x1)
    return x1, _log_accept(lp0, lp1, p0, p1, inv_mass)


def _log_accept(lp0, lp1, p0, p1, inv_mass):
    """The Metropolis log-accept ``min(0, H0 − H1)`` of a trajectory from
    its end log-probs and momenta, non-finite values mapped to −inf."""
    h0 = -lp0 + _kinetic(inv_mass, p0)
    h1 = -lp1 + _kinetic(inv_mass, p1)
    log_acc = torch.clamp(h0 - h1, max=0.0)
    return torch.where(torch.isfinite(log_acc), log_acc,
                       torch.full((), -math.inf, device=lp0.device))


def _mh_accept(xc, x1, log_acc, u):
    """Metropolis step given uniforms ``u`` [C] → (xc', accept prob)."""
    accept = torch.log(u) < log_acc
    return torch.where(accept[:, None], x1, xc), torch.exp(log_acc)


def _hmc_step_batched(fg: CompiledFG, cfg: HMCConfig, gen, xc, xd, eps,
                      inv_mass):
    """One HMC proposal for ALL chains → ``(xc', accept prob [C])``.

    Purely-quadratic targets take the fused proposals; others one
    lockstep batched leapfrog through ``ops.logpot.logpot_leapfrog``
    (autograd over ``log_prob_cont_batched``, or kernel K5 with
    ``cfg.fused_logpot``), whose energies come back with the endpoint.
    Purely-discrete buckets are constant in xc at the chain's fixed xd and
    drop out of the Hamiltonian exactly. The banded proposal makes the
    Metropolis step itself (K2 selects in its write-back); the other
    routes end in ``_mh_accept``. Every route draws the uniforms from
    ``gen`` after the momenta."""
    C = xc.shape[0]
    if fg.n_cont == 0:
        # nothing moves; the reference's empty trajectory accepts
        return xc, torch.ones((C,), device=xc.device)
    if fg.cont_pure_quad and _use_dia(fg, cfg):
        from lhvi_tpu_torch.ops.dia import dia_hmc_proposal

        x, log_acc = dia_hmc_proposal(
            gen, xc, fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w,
            fg.quad_h, inv_mass, eps, cfg.n_leapfrog,
            pos=fg.quad_dia_pos, inv=fg.quad_dia_inv, select=True,
        )
        return x, torch.exp(log_acc)
    p0 = momentum_std(inv_mass)[None, :] * torch.randn(
        xc.shape, generator=gen, device=xc.device)
    if fg.cont_pure_quad:
        x1, log_acc = _quad_proposal(fg, cfg, xc, p0, eps, inv_mass)
    else:
        from lhvi_tpu_torch.ops.logpot import logpot_leapfrog

        x1, p1, lp0, lp1 = logpot_leapfrog(
            fg, xc, p0, xd, inv_mass, eps, cfg.n_leapfrog,
            plan="auto" if cfg.fused_logpot else None)
        log_acc = _log_accept(lp0, lp1, p0, p1, inv_mass)
    u = torch.rand((C,), generator=gen, device=xc.device)
    return _mh_accept(xc, x1, log_acc, u)


def mode_swap_stage(fg: CompiledFG, cfg, state: HMCState, gen, gate, xd):
    """The mode-swap move after the Gibbs stage, where it is on and the
    graph has a plan → ``(state with its accumulators, xd)``."""
    if not (cfg.mode_swap and fg.mode_swap_plan is not None):
        return state, xd
    from lhvi_tpu_torch.engines.modeswap import maybe_mode_swap

    xd, acc, n_inc = maybe_mode_swap(fg, cfg, gen, gate, state.xc, xd)
    return state._replace(ms_acc_sum=state.ms_acc_sum + acc,
                          ms_acc_n=state.ms_acc_n + n_inc), xd


def hmc_transition(fg: CompiledFG, cfg: HMCConfig, state: HMCState, gen,
                   adapt: bool, gate=None, shard=None):
    """One full HMC-within-Gibbs transition for all chains: the Gibbs
    sweep(s), the mode-swap move where it is on (``gate``: the host
    generator of ``modeswap.maybe_mode_swap``), then one HMC proposal at
    the new discrete state. Under ``shard`` the adaptation reads the
    acceptance and the Welford batch over all ranks' chains. Counted as
    ``hmc.transitions``; timed as span ``hmc.transition`` (the sweep
    inside it as ``sweep_all``'s span ``hmc.sweep``)."""
    count("hmc.transitions")
    with span("hmc.transition"):
        xd = sweep_all(fg, cfg, gen, state.xc, state.xd)
        state, xd = mode_swap_stage(fg, cfg, state, gen, gate, xd)
        eps = torch.exp(state.log_eps)
        xc, acc = _hmc_step_batched(fg, cfg, gen, state.xc, xd, eps,
                                    state.inv_mass)
        check_nan("hmc_transition", xc=xc, acc=acc)
        state = state._replace(xc=xc, xd=xd)
        if adapt:
            state = _da_update(state, chain_mean(acc, shard), cfg)
            state = _welford_update(state, xc, shard)
    return state, acc


def chain_mean(v, shard=None):
    """Mean of a per-chain ``[C]`` tensor over all ranks' chains (one
    ``all_reduce`` under ``shard``)."""
    if shard is None:
        return torch.mean(v)
    return all_reduce(torch.sum(v), shard) / (v.shape[0] * shard.world)


def _scalar(v, device) -> torch.Tensor:
    """A 0-d f32 tensor filled on the device (no host-to-device copy)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def init_hmc_state(fg: CompiledFG, gen, cfg: HMCConfig,
                   n_chains: int) -> HMCState:
    """Fresh batched sampler state (pre-warmup)."""
    dev = fg.device
    xc, xd = fg.init_state_batched(gen, n_chains, cfg.jitter)
    log_eps0 = _scalar(math.log(cfg.init_step_size), dev)
    zeros = torch.zeros(fg.n_cont, device=dev)
    return HMCState(
        xc=xc, xd=xd,
        log_eps=log_eps0, log_eps_bar=log_eps0.clone(),
        h_bar=_scalar(0.0, dev), t=_scalar(0.0, dev),
        welford_mean=zeros, welford_m2=zeros.clone(),
        welford_n=_scalar(0.0, dev),
        inv_mass=torch.ones(fg.n_cont, device=dev),
        ms_acc_sum=_scalar(0.0, dev), ms_acc_n=_scalar(0.0, dev),
    )


def _mass_refresh(fg: CompiledFG, cfg, state: HMCState) -> HMCState:
    if not cfg.adapt_mass or fg.n_cont == 0:
        return state
    var = state.welford_m2 / torch.clamp(state.welford_n - 1.0, min=1.0)
    inv_mass = torch.where(state.welford_n > 10.0,
                           torch.clamp(var, min=1e-6),
                           torch.ones_like(var))
    return state._replace(inv_mass=inv_mass)


def _warmup_boundary(fg: CompiledFG, cfg, state: HMCState,
                     final: bool) -> HMCState:
    """The warmup's phase boundary: the mass refresh, then at the half
    (``final`` False) a fresh start of dual averaging and Welford, at the
    end the step size frozen at ``log_eps_bar`` and the mode-swap
    accumulators zeroed (the move's acceptance is reported for the
    sampling window only)."""
    dev = state.xc.device
    state = _mass_refresh(fg, cfg, state)
    if final:
        return state._replace(log_eps=state.log_eps_bar,
                              ms_acc_sum=_scalar(0.0, dev),
                              ms_acc_n=_scalar(0.0, dev))
    return state._replace(
        h_bar=_scalar(0.0, dev), t=_scalar(0.0, dev),
        welford_mean=torch.zeros(fg.n_cont, device=dev),
        welford_m2=torch.zeros(fg.n_cont, device=dev),
        welford_n=_scalar(0.0, dev),
    )


def run_warmup(fg: CompiledFG, cfg, state: HMCState, n_warmup: int,
               transition):
    """Two-phase warmup (dual averaging; mass refresh between phases).
    ``transition(state, adapt) -> (state, stats)``."""
    if n_warmup <= 0:
        return state
    half = max(n_warmup // 2, 1)
    for _ in range(half):
        state, _ = transition(state, True)
    state = _warmup_boundary(fg, cfg, state, final=False)
    for _ in range(n_warmup - half):
        state, _ = transition(state, True)
    return _warmup_boundary(fg, cfg, state, final=True)


def _da_update(state: HMCState, accept_mean, cfg: HMCConfig):
    """Nesterov dual averaging on log step size (Hoffman–Gelman 2014)."""
    gamma, t0, kappa = 0.05, 10.0, 0.75
    mu = math.log(10.0 * cfg.init_step_size)
    t = state.t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * state.h_bar + (
        cfg.target_accept - accept_mean
    ) / (t + t0)
    log_eps = mu - torch.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return state._replace(
        log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t=t
    )


def _welford_update(state: HMCState, xc, shard=None):
    """Chan et al. batched Welford: fold all C chain states in at once (the
    estimand is the cross-chain posterior variance); under ``shard`` the
    batch is every rank's chains (two ``all_reduce``s)."""
    C = xc.shape[0] * n_chain_shards(shard)
    n_new = state.welford_n + C
    if shard is None:
        batch_mean = torch.mean(xc, dim=0)
        batch_m2 = torch.sum((xc - batch_mean) ** 2, dim=0)
    else:
        batch_mean = all_reduce(torch.sum(xc, dim=0), shard) / C
        batch_m2 = all_reduce(torch.sum((xc - batch_mean) ** 2, dim=0),
                              shard)
    delta = batch_mean - state.welford_mean
    mean = state.welford_mean + delta * (C / n_new)
    m2 = state.welford_m2 + batch_m2 + delta**2 * (state.welford_n * C / n_new)
    return state._replace(welford_mean=mean, welford_m2=m2, welford_n=n_new)


# ---- streamed convergence diagnostics (collect="moments") ---------------


class _StreamDiag(NamedTuple):
    """Per-chain streaming accumulators, all [C, n_cont]: two split-half
    Welford pairs (split-R̂), a lag-1 cross-product (AR(1) ESS proxy) and a
    batch-means block (current-batch sum + Welford over completed batch
    means) for the batch-means ESS."""

    h1_mean: torch.Tensor
    h1_m2: torch.Tensor
    h2_mean: torch.Tensor
    h2_m2: torch.Tensor
    cross: torch.Tensor
    prev: torch.Tensor
    bm_cur: torch.Tensor
    bm_mean: torch.Tensor
    bm_m2: torch.Tensor


def _stream_diag_init(C: int, n: int, device) -> _StreamDiag:
    return _StreamDiag(*(torch.zeros((C, n), device=device)
                         for _ in range(9)))


def _split_welford_update(h1_mean, h1_m2, h2_mean, h2_m2, t: int, x,
                          half: int):
    """Fold draw ``t`` (0-based) into the split-half Welford pairs; the
    odd-S tail draw belongs to neither half."""

    def welford(mean, m2, cnt_new):
        delta = x - mean
        mean2 = mean + delta / max(cnt_new, 1.0)
        return mean2, m2 + delta * (x - mean2)

    if t < half:
        h1_mean, h1_m2 = welford(h1_mean, h1_m2, t + 1.0)
    elif t < 2 * half:
        h2_mean, h2_m2 = welford(h2_mean, h2_m2, t + 1.0 - half)
    return h1_mean, h1_m2, h2_mean, h2_m2


def _stream_diag_update(sd: _StreamDiag, t: int, xc, half: int,
                        bm_len: int = 0, n_batches: int = 0) -> _StreamDiag:
    """Fold draw ``t`` (0-based) of every chain into the accumulators;
    every ``bm_len`` draws the batch mean is folded into its Welford pair.
    On a CUDA tensor one launch of K7 (``_fused_stream_diag_update``),
    bitwise equal to the plain version ``_plain_stream_diag_update``,
    which CPU tensors take."""
    if xc.is_cuda:
        return _fused_stream_diag_update(sd, t, xc, half, bm_len, n_batches)
    return _plain_stream_diag_update(sd, t, xc, half, bm_len, n_batches)


def _fused_stream_diag_update(sd: _StreamDiag, t: int, xc, half: int,
                              bm_len: int = 0,
                              n_batches: int = 0) -> _StreamDiag:
    """The plain version's branch, with its arithmetic in one pass of
    ``ops.moments.stream_diag_update``: the draw's split half (none for the
    odd-S tail draw), ``cross`` from the second draw on, the batch sum
    while the batch stream runs and the batch-means pair at a boundary are
    written anew, the rest kept, and ``prev`` is ``xc``."""
    first, second = t < half, half <= t < 2 * half
    cnt = t + 1 - (half if second else 0)
    pair = ((sd.h1_mean, sd.h1_m2) if first
            else (sd.h2_mean, sd.h2_m2) if second else (None, None))
    lag = t > 0
    bm = bm_len > 0 and n_batches >= 2
    t1 = t + 1
    edge = bm and t1 % bm_len == 0 and t1 // bm_len <= n_batches
    mean, m2, cross, bm_cur, bm_mean, bm_m2 = _moments.stream_diag_update(
        xc, *pair, *((sd.prev, sd.cross) if lag else (None, None)),
        sd.bm_cur if bm else None,
        *((sd.bm_mean, sd.bm_m2) if edge else (None, None)),
        cnt=cnt, bm_len=bm_len, batch_no=t1 // bm_len if edge else 0)
    h1 = (mean, m2) if first else (sd.h1_mean, sd.h1_m2)
    h2 = (mean, m2) if second else (sd.h2_mean, sd.h2_m2)
    return _StreamDiag(*h1, *h2, cross if lag else sd.cross, xc,
                       bm_cur if bm else sd.bm_cur,
                       *((bm_mean, bm_m2) if edge else (sd.bm_mean, sd.bm_m2)))


def _plain_stream_diag_update(sd: _StreamDiag, t: int, xc, half: int,
                              bm_len: int = 0,
                              n_batches: int = 0) -> _StreamDiag:
    """Plain version of K7: the accumulators the draw changes anew, the
    others as they are, and ``prev`` is ``xc``."""
    h1_mean, h1_m2, h2_mean, h2_m2 = _split_welford_update(
        sd.h1_mean, sd.h1_m2, sd.h2_mean, sd.h2_m2, t, xc, half
    )
    cross = sd.cross + xc * sd.prev if t > 0 else sd.cross
    bm_cur, bm_mean, bm_m2 = sd.bm_cur, sd.bm_mean, sd.bm_m2
    if bm_len > 0 and n_batches >= 2:
        bm_cur = bm_cur + xc
        t1 = t + 1
        batch_no = t1 // bm_len  # 1-based count AT a boundary
        if t1 % bm_len == 0 and batch_no <= n_batches:
            bmean = bm_cur / bm_len
            delta = bmean - bm_mean
            bm_mean = bm_mean + delta / max(float(batch_no), 1.0)
            bm_m2 = bm_m2 + delta * (bmean - bm_mean)
            bm_cur = torch.zeros_like(bm_cur)
    return _StreamDiag(h1_mean, h1_m2, h2_mean, h2_m2, cross, xc,
                       bm_cur, bm_mean, bm_m2)


def _split_rhat(pairs, half: int):
    """``(rhat, B, W)``: exact split-R̂ from the split halves' Welford pairs
    (the first four fields of ``pairs``, ``[C, n]`` each, ``half`` ≥ 2
    draws a half), with the between- and within-chain variances behind
    it."""
    h1_mean, h1_m2, h2_mean, h2_m2 = pairs[:4]
    chain_mean = torch.cat([h1_mean, h2_mean], dim=0)
    chain_var = torch.cat([h1_m2, h2_m2], dim=0) / (half - 1)
    B = half * torch.var(chain_mean, dim=0, correction=1)
    W = torch.mean(chain_var, dim=0)
    var_hat = (half - 1) / half * W + B / half
    return torch.sqrt(var_hat / torch.clamp(W, min=1e-12)), B, W


def _stream_diag_finalize(sd: _StreamDiag, n_samples: int,
                          bm_len: int = 0) -> dict:
    """{'rhat', 'ess_proxy', 'ess_bm'} ([n] each) from the accumulators.

    ``rhat`` is exact split-R̂ (the per-half Welford pairs are the split
    chains' means/variances); ``ess_proxy`` the AR(1) approximation
    S·C·(1−ρ̂₁)/(1+ρ̂₁); ``ess_bm`` the batch-means estimator
    Σ_c min(S/τ̂_c, S) with τ̂ = b·s²_bm/s² (NaN without two batches)."""
    C, n = sd.h1_mean.shape
    dev = sd.h1_mean.device
    half = n_samples // 2
    if half < 2:
        nanv = torch.full((n,), math.nan, device=dev)
        return {"rhat": nanv, "ess_proxy": nanv, "ess_bm": nanv}
    rhat, _, _ = _split_rhat(sd, half)
    S = n_samples
    # Chan merge of the equal-count halves → per-chain full-window moments
    f_mean = 0.5 * (sd.h1_mean + sd.h2_mean)
    f_m2 = sd.h1_m2 + sd.h2_m2 + 0.5 * half * (sd.h1_mean - sd.h2_mean) ** 2
    var_c = f_m2 / max(2 * half - 1, 1)
    rho1 = (sd.cross / max(S - 1, 1) - f_mean * f_mean) / torch.clamp(
        var_c, min=1e-12)
    rho1 = torch.clamp(torch.mean(rho1, dim=0), 0.0, 0.999)
    ess = S * C * (1.0 - rho1) / (1.0 + rho1)
    n_batches = S // bm_len if bm_len else 0
    if n_batches >= 2:
        s2_bm = sd.bm_m2 / (n_batches - 1)
        tau = bm_len * s2_bm / torch.clamp(var_c, min=1e-12)
        ess_c = torch.clamp(S / torch.clamp(tau, min=1e-12), max=float(S))
        # a frozen dimension has no defined autocorrelation: report S
        ess_c = torch.where(var_c <= 0.0, torch.full_like(ess_c, float(S)),
                            ess_c)
        ess_bm = torch.sum(ess_c, dim=0)
    else:
        ess_bm = torch.full((n,), math.nan, device=dev)
    return {"rhat": rhat, "ess_proxy": ess, "ess_bm": ess_bm}


class _StreamDiagDisc(NamedTuple):
    """Split-half Welford pairs over the VALUE states of the monitored
    discrete latents (``disc_diag_select``): the streamed split-R̂ of the
    Gibbs half. All ``[C, n_sel]`` f32."""

    h1_mean: torch.Tensor
    h1_m2: torch.Tensor
    h2_mean: torch.Tensor
    h2_m2: torch.Tensor


def _stream_diag_disc_init(C: int, n_sel: int, device) -> _StreamDiagDisc:
    return _StreamDiagDisc(*(torch.zeros((C, n_sel), device=device)
                             for _ in range(4)))


def disc_diag_select(fg: CompiledFG, cap: int, seed: int = 0) -> np.ndarray:
    """Deterministic host-side selection of the discrete latents whose
    value traces carry streamed split-R̂: all ``n_disc`` when ``n_disc <=
    cap``, else ``cap`` of them stratified over the chromatic color
    classes by largest-remainder allocation (≥1 per class while the
    budget allows), drawn with ``numpy.random.default_rng(seed)``."""
    n = fg.n_disc
    if n <= cap:
        return np.arange(n, dtype=np.int32)
    colors = np.asarray(fg.meta.np_global["color_of"])
    rng = np.random.default_rng(seed)
    uniq, counts = np.unique(colors, return_counts=True)
    quota = np.floor(cap * counts / n).astype(np.int64)
    if len(uniq) <= cap:
        quota = np.maximum(quota, 1)
    rem = cap * counts / n - np.floor(cap * counts / n)
    while quota.sum() < cap:
        i = int(np.argmax(rem))
        quota[i] += 1
        rem[i] = -1.0
    while quota.sum() > cap:
        i = int(np.argmax(quota))
        quota[i] -= 1
    sel = []
    for c, q in zip(uniq, quota):
        if q <= 0:
            continue
        idx = np.flatnonzero(colors == c)
        sel.append(rng.choice(idx, size=min(int(q), idx.size),
                              replace=False))
    return np.sort(np.concatenate(sel)).astype(np.int32)


def _disc_sel_values(fg: CompiledFG, sel, xd):
    """``[C, n_sel]`` f32 domain VALUES of the selected discrete latents."""
    return _values_of(fg.disc_vals[sel], xd[:, sel])


def _stream_diag_disc_update(sdd: _StreamDiagDisc, t: int, xv,
                             half: int) -> _StreamDiagDisc:
    """Fold draw ``t``'s selected discrete VALUES into the accumulators."""
    return _StreamDiagDisc(*_split_welford_update(
        sdd.h1_mean, sdd.h1_m2, sdd.h2_mean, sdd.h2_m2, t, xv, half))


def _stream_diag_disc_finalize(sdd: _StreamDiagDisc, n_samples: int) -> dict:
    """{'rhat_disc': [n_sel]}: exact split-R̂ over the selected value
    traces. A latent frozen at one value across all chains and halves
    (B = W = 0) reports 1.0; B > 0 with W = 0 still blows up."""
    half = n_samples // 2
    n = sdd.h1_mean.shape[1]
    dev = sdd.h1_mean.device
    if half < 2:
        return {"rhat_disc": torch.full((n,), math.nan, device=dev)}
    rhat, B, W = _split_rhat(sdd, half)
    frozen = (W <= 0.0) & (B <= 1e-12)
    return {"rhat_disc": torch.where(frozen, torch.ones_like(rhat), rhat)}


def _moment_sums(s1, s2, xc) -> tuple:
    """``(s1 + Σ_c xc, s2 + Σ_c xc²)``, the running sums of the moments:
    on a CUDA tensor one launch of K8 (``ops/moments.py``), on a CPU
    tensor the plain version ``_plain_moment_sums``."""
    if xc.is_cuda:
        return _moments.moment_sums(s1, s2, xc)
    return _plain_moment_sums(s1, s2, xc)


def _plain_moment_sums(s1, s2, xc) -> tuple:
    """Plain version of K8."""
    return s1 + torch.sum(xc, dim=0), s2 + torch.sum(xc * xc, dim=0)


def _bm_schedule(n_samples: int) -> tuple:
    """(batch length, batch count) for the batch-means stream: b = ⌊√S⌋;
    (0, 0) when fewer than two complete batches fit."""
    b = max(1, int(n_samples ** 0.5))
    nb = n_samples // b
    return (b, nb) if nb >= 2 else (0, 0)


class _MomentStream:
    """The moments-mode accumulators of ``run_chains``: sums for the mean
    and variance, per-value counts of the discrete latents, and with
    ``stream_diag`` the streamed split-R̂/ESS of the continuous draws and
    the split-R̂ of the value traces of up to ``disc_diag_cap`` discrete
    latents (``disc_diag_select``).

    ``n_chains`` counts every rank's chains; under ``shard`` this rank
    folds in its own block, and ``finalize`` reduces the sums and
    assembles the per-chain accumulators over the ranks once."""

    def __init__(self, fg: CompiledFG, n_chains: int, n_samples: int,
                 stream_diag: bool, disc_diag_cap: int, shard=None):
        dev = fg.device
        self.fg, self.n_chains, self.n_samples = fg, n_chains, n_samples
        self.shard = shard
        C = local_count(n_chains, shard)
        self.half = n_samples // 2
        self.bm_len, self.n_batches = _bm_schedule(n_samples)
        self.s1 = torch.zeros(fg.n_cont, device=dev)
        self.s2 = torch.zeros(fg.n_cont, device=dev)
        self.cnt = torch.zeros((max(fg.n_disc, 1), fg.max_v), device=dev)
        self.sd = (_stream_diag_init(C, fg.n_cont, dev)
                   if stream_diag else None)
        self.sel = self.sdd = None
        if stream_diag and fg.n_disc > 0 and disc_diag_cap > 0:
            sel_np = disc_diag_select(fg, disc_diag_cap)
            self.sel = torch.as_tensor(sel_np, dtype=torch.int64, device=dev)
            self.sdd = _stream_diag_disc_init(C, len(sel_np), dev)

    def update(self, t: int, xc, xd):
        """Fold draw ``t`` (0-based) of every chain in. Counted as
        ``hmc.draws``; timed as span ``hmc.moments``."""
        fg = self.fg
        count("hmc.draws")
        with span("hmc.moments"):
            self.s1, self.s2 = _moment_sums(self.s1, self.s2, xc)
            if fg.n_disc:
                self.cnt = self.cnt + torch.nn.functional.one_hot(
                    xd, fg.max_v).sum(dim=0)
            if self.sd is not None:
                self.sd = _stream_diag_update(self.sd, t, xc, self.half,
                                              self.bm_len, self.n_batches)
            if self.sel is not None:
                self.sdd = _stream_diag_disc_update(
                    self.sdd, t, _disc_sel_values(fg, self.sel, xd),
                    self.half)

    def finalize(self):
        """``(moments, diag)``: the moments dict and the streamed
        diagnostics' entries of ``diag`` (over every rank's chains)."""
        sh = self.shard
        n_obs = self.n_samples * self.n_chains
        s1, s2, cnt = (all_reduce(a, sh) for a in (self.s1, self.s2,
                                                   self.cnt))
        mean = s1 / n_obs
        moments = {
            "mean": mean,
            "var": torch.clamp(s2 / n_obs - mean**2, min=0.0),
            "disc_probs": cnt / n_obs,
            "n_obs": n_obs,
        }
        diag = {}
        if self.sd is not None:
            sd = _StreamDiag(*(assemble_rows(a, sh) for a in self.sd))
            diag.update(_stream_diag_finalize(sd, self.n_samples,
                                              self.bm_len))
        if self.sel is not None:
            sdd = _StreamDiagDisc(*(assemble_rows(a, sh) for a in self.sdd))
            diag.update(_stream_diag_disc_finalize(sdd, self.n_samples))
            diag["disc_diag_idx"] = self.sel
        return moments, diag


def _ensure_mode_swap_plan(fg: CompiledFG, cfg):
    """Attach the mode-swap plan when the move is on (host-side, once per
    graph: ``modeswap.plan_for`` caches it). Where no discrete class
    qualifies, warn and run plain chromatic Gibbs."""
    if not getattr(cfg, "mode_swap", False) or fg.mode_swap_plan is not None:
        return fg, cfg
    from lhvi_tpu_torch.engines.modeswap import plan_for

    plan = plan_for(fg)
    if plan is None:
        import warnings

        warnings.warn(
            "mode_swap=True but color refinement found no discrete class "
            "with >=2 members — the move is a no-op on this model; "
            "running plain chromatic Gibbs.", stacklevel=3)
        return fg, dataclasses.replace(cfg, mode_swap=False)
    return dataclasses.replace(fg, mode_swap_plan=plan), cfg


def _gate(cfg, gen):
    """The mode-swap gate's host generator, where the move is gated."""
    if not (cfg.mode_swap and cfg.mode_swap_every > 1):
        return None
    from lhvi_tpu_torch.engines.modeswap import gate_generator

    return gate_generator(gen)


def _window_diag(state: HMCState, sums: dict, n_samples: int,
                 mode_swap: bool, shard=None) -> dict:
    """The sampling window's diagnostics over every rank's chains: each
    statistic's window sum in ``sums`` as its mean over the draws, the
    step size, the mass and, where the move is on, ``mode_swap_accept``
    per application (the ranks' means are over equal chain counts, and
    the shared gate gives them equal application counts)."""
    k = n_chain_shards(shard)
    diag = {name: all_reduce(v, shard) / (k * max(n_samples, 1))
            for name, v in sums.items()}
    diag.update(step_size=torch.exp(state.log_eps), inv_mass=state.inv_mass)
    if mode_swap:
        acc = all_reduce(state.ms_acc_sum, shard) / k
        diag["mode_swap_accept"] = acc / torch.clamp(state.ms_acc_n, min=1.0)
    return diag


def run_chains(fg: CompiledFG, gen, cfg: HMCConfig, step, stats: tuple, *,
               who: str, n_chains: int, n_warmup: int, n_samples: int,
               thin: int, collect: str, stream_diag: bool,
               disc_diag_cap: int, shard=None):
    """The chain loop of ``run_hmc`` and ``nuts.run_nuts``, with
    ``run_hmc``'s contract (``who`` names the caller in a refusal): a fresh
    state, ``run_warmup`` (reading ``cfg``), the sampling window and its
    diagnostics. ``step(state, gen, gate, adapt) -> (state, stats)`` is
    one transition of this rank's chains, ``stats`` a dict of per-chain
    ``[C]`` tensors. A kept draw reports the LAST transition of its
    ``thin`` block, as the reference's ``fori_loop`` carry (reference
    hmc.py:900-910): ``diag`` holds each entry named in ``stats`` as its
    mean over the kept draws and every rank's chains."""
    if collect not in ("samples", "moments"):
        raise ValueError(f"collect must be 'samples' or 'moments': {collect}")
    fg.require_whole(who)
    dev = fg.device
    C = local_count(n_chains, shard)
    gen, shared = ((gen, gen) if shard is None
                   else split_generator(gen, shard.rank))
    state = init_hmc_state(fg, gen, cfg, C)
    gate = _gate(cfg, shared)

    def trans(s, adapt):
        return step(s, gen, gate, adapt)

    state = run_warmup(fg, cfg, state, n_warmup, trans)
    sums = {name: torch.zeros((), device=dev) for name in stats}
    ms = (_MomentStream(fg, n_chains, n_samples, stream_diag, disc_diag_cap,
                        shard) if collect == "moments" else None)
    s_xc, s_xd = [], []
    for t in range(n_samples):
        for _ in range(thin):
            state, last = trans(state, False)
        means = [torch.mean(last[name].to(torch.float32)) for name in stats]
        for name, m in zip(stats, means):
            sums[name] = sums[name] + m
        if ms is not None:
            ms.update(t, state.xc, state.xd)
        else:
            s_xc.append(state.xc)
            s_xd.append(state.xd)
    moments, stream = ms.finalize() if ms is not None else (None, {})
    diag = {**_window_diag(state, sums, n_samples, cfg.mode_swap, shard),
            **stream}
    if ms is not None:
        return moments, None, diag
    if not s_xc:
        return (torch.zeros((0, C, fg.n_cont), device=dev),
                torch.zeros((0, C, fg.n_disc), dtype=torch.int64,
                            device=dev), diag)
    return torch.stack(s_xc), torch.stack(s_xd), diag


def chain_step(fg: CompiledFG, cfg: HMCConfig, shard=None):
    """``run_chains``'s step of HMC: one ``hmc_transition`` (looked up at
    call time), reporting ``accept_rate``."""

    def step(state, gen, gate, adapt):
        state, acc = hmc_transition(fg, cfg, state, gen, adapt, gate, shard)
        return state, {"accept_rate": acc}

    return step


def run_hmc(
    fg: CompiledFG,
    gen: torch.Generator,
    cfg: HMCConfig = HMCConfig(),
    n_chains: int = 8,
    n_warmup: int = 500,
    n_samples: int = 1000,
    thin: int = 1,
    collect: str = "samples",
    stream_diag: bool = True,
    disc_diag_cap: int = 4096,
    shard=None,
):
    """Run the sampler.

    ``gen`` is a ``torch.Generator`` on ``fg.device``; it drives every draw
    (initial state, Gibbs, momenta, accept uniforms); on the banded CUDA
    path its seed and Philox offset key K2's in-kernel momenta.

    ``shard`` (a ``parallel.ChainShard``): this rank runs
    ``n_chains / world`` chains (a count that does not divide raises) from
    its own generator, ``split_generator(gen, rank)[0]``; the mode-swap
    gate draws from the generator all ranks share. Every rank gets the
    moments and diagnostics of all chains; ``collect="samples"`` returns
    this rank's chains.

    collect="samples": returns (samples_xc [S,C,n_cont], samples_xd
    [S,C,n_disc], diag). collect="moments": streams sufficient statistics
    on the device instead of materializing the sample array; returns
    (moments dict, None, diag). ``stream_diag`` (moments mode) carries the
    streamed split-R̂/ESS accumulators; False for pure-throughput runs.
    ``disc_diag_cap`` (moments mode, with ``stream_diag``): how many
    discrete latents carry streamed split-R̂ over their value traces
    (``diag["rhat_disc"]``, ``diag["disc_diag_idx"]`` naming them; see
    ``disc_diag_select``); 0 disables it. With ``cfg.mode_swap``,
    ``diag`` also holds ``mode_swap_accept`` (per application, over the
    sampling window). The call is span ``hmc.query``, which opens a new
    query id (``utils.metrics.span``), around ``run_chains``.
    """
    with span("hmc.query", new_query=True):
        fg, cfg = _ensure_mode_swap_plan(fg, cfg)
        return run_chains(
            fg, gen, cfg, chain_step(fg, cfg, shard), ("accept_rate",),
            who="run_hmc", n_chains=n_chains, n_warmup=n_warmup,
            n_samples=n_samples, thin=thin, collect=collect,
            stream_diag=stream_diag, disc_diag_cap=disc_diag_cap,
            shard=shard)


def _to_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class _Queries:
    """Shared RV-level query plumbing (reference ``belief/map`` parity)."""

    def _loc(self, rv, want):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if kind != want:
            raise ValueError(
                f"{rv} is {'continuous' if kind == 'c' else 'discrete'}")
        return i

    def map(self, rv):
        kind, _ = self.fg.meta.loc(rv)
        if kind == "c":
            return self.mean(rv)
        p = self.disc_marginal(rv)
        return self.fg.meta.disc_values(rv)[int(p.argmax())]


class HMCResult(_Queries):
    """Query wrapper over materialized samples (collect="samples")."""

    def __init__(self, fg: CompiledFG, s_xc, s_xd, diag):
        self.fg = fg
        s_xc, s_xd = _to_numpy(s_xc), _to_numpy(s_xd)
        n_draws = s_xc.shape[0] * s_xc.shape[1]
        self.xc = s_xc.reshape(n_draws, fg.n_cont)  # [S*C, n]
        self.xd = s_xd.reshape(n_draws, fg.n_disc)
        self.diag = {k: _to_numpy(v) for k, v in diag.items()}

    def mean(self, rv) -> float:
        return float(self.xc[:, self._loc(rv, "c")].mean())

    def var(self, rv) -> float:
        return float(self.xc[:, self._loc(rv, "c")].var())

    def disc_marginal(self, rv):
        i = self._loc(rv, "d")
        size = self.fg.meta.disc_size(rv)
        counts = np.bincount(self.xd[:, i], minlength=size)[:size]
        return counts / counts.sum()


class HMCMoments(_Queries):
    """Query wrapper over streamed sufficient statistics (collect="moments")."""

    def __init__(self, fg: CompiledFG, moments, diag):
        self.fg = fg
        self.moments = {k: _to_numpy(v) for k, v in moments.items()}
        self.diag = {k: _to_numpy(v) for k, v in diag.items()}

    def mean(self, rv) -> float:
        return float(self.moments["mean"][self._loc(rv, "c")])

    def var(self, rv) -> float:
        return float(self.moments["var"][self._loc(rv, "c")])

    def disc_marginal(self, rv):
        i = self._loc(rv, "d")
        return self.moments["disc_probs"][i, : self.fg.meta.disc_size(rv)]


def _result(fg: CompiledFG, out) -> _Queries:
    """The query wrapper of a run's ``(moments, None, diag)`` or
    ``(samples_xc, samples_xd, diag)``."""
    a, b, diag = out
    return HMCMoments(fg, a, diag) if b is None else HMCResult(fg, a, b, diag)


def sample(fg: CompiledFG, gen, **kw):
    """Convenience wrapper: run and wrap results for RV-level queries."""
    return _result(fg, run_hmc(fg, gen, kw.pop("cfg", HMCConfig()), **kw))
