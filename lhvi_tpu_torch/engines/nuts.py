"""No-U-Turn Sampler (iterative, multinomial) for compiled factor graphs
(PyTorch port of ``lhvi_tpu/engines/nuts.py``).

The recursive tree doubling is an iterative state machine over a shared
leaf schedule: depth d = 0, 1, …; leaf j = 0 … 2^d−1 within each doubling;
global leaf counter ``step = 2^d − 1 + j``. Even leaves are checkpointed at
slot popcount(j); odd leaf j is checked for a U-turn against the boundaries
j+1−2^l, l = 1..ctz(j+1). Proposals are multinomial (streaming logsumexp
weights) with biased progressive sampling at merges; a leaf whose energy
error exceeds 1000 diverges.

On dense pure-quadratic targets every transition is ONE launch of kernel
K3 (``ops.nuts_traj``), in which each chain stops at its own depth. The
lockstep loop ``_nuts_lockstep`` — every chain advances through the same
leaves behind masks, one batched gradient per leaf — is K3's plain version
and the path for sparse and non-quadratic targets, as in the reference;
on the latter each leaf's gradient is autograd over
``log_prob_cont_batched`` at the chains' discrete states. Discrete latents
move by the chromatic Gibbs sweeps of ``engines.hmc`` before each
transition (NUTS-within-Gibbs).

``run_nuts`` runs through ``hmc.run_chains``, the chain loop of
``hmc.run_hmc``, and so has its contract (``shard`` included: each rank
runs its chains' K3 launches).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lhvi_tpu_torch.engines import hmc as _hmc
from lhvi_tpu_torch.fg.compile import CompiledFG
from lhvi_tpu_torch.utils.debug import check_nan
from lhvi_tpu_torch.utils.metrics import count, span

_DIVERGENCE = 1000.0
# transitions whose per-chain leaf counts ``run_nuts`` holds before it folds
# them into its running sum (three launches a fold, none a transition)
_LEAF_FOLD = 32
# the statistics of ``chain_step`` that ``hmc.run_chains`` reports in diag
_STATS = ("accept_rate", "mean_depth", "divergence_rate")


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    max_depth: int = 8
    init_step_size: float = 0.1
    target_accept: float = 0.8
    gibbs_sweeps: int = 1
    gibbs_max_colors: int = 0
    adapt_mass: bool = True
    jitter: float = 1.0
    gibbs_unroll: int = 1
    # orbit-level mode-swap MH move after the Gibbs stage
    mode_swap: bool = False
    mode_swap_every: int = 1

    def to_hmc(self) -> _hmc.HMCConfig:
        """The HMCConfig sharing this config's warmup/Gibbs fields — the
        single mapping point (init and warmup route through it)."""
        return _hmc.HMCConfig(
            init_step_size=self.init_step_size,
            target_accept=self.target_accept,
            gibbs_sweeps=self.gibbs_sweeps,
            gibbs_max_colors=self.gibbs_max_colors,
            adapt_mass=self.adapt_mass,
            jitter=self.jitter,
            gibbs_unroll=self.gibbs_unroll,
            mode_swap=self.mode_swap,
            mode_swap_every=self.mode_swap_every,
        )


def _popcount(n):
    """Set bits of a Python int or of each element of an integer tensor
    (as the reference, on the low 32 bits)."""
    if isinstance(n, int):
        return bin(n & 0xFFFFFFFF).count("1")
    u = n.to(torch.int64) & 0xFFFFFFFF
    c = torch.zeros_like(u)
    for b in range(32):
        c = c + ((u >> b) & 1)
    return c.to(torch.int32)


def _ctz(n):
    """Count trailing zeros (n > 0; 32 at n = 0, as the reference)."""
    u = n & 0xFFFFFFFF if isinstance(n, int) else n.to(torch.int64) & 0xFFFFFFFF
    return _popcount(((u & -u) - 1) & 0xFFFFFFFF)


def _make_grad_lp(fg: CompiledFG, xd):
    """Batched (grad, logp) closure: [C, n] → ([C, n], [C]).

    Pure-quadratic continuous energy: one product serves both
    (``g = h − qJ`` and ``lp = c + ½ q·(h + g)``); sparse targets use the
    ELL matvec. Otherwise autograd over ``fg.log_prob_cont_batched`` at
    the chains' discrete states ``xd`` (the reference's ``jax.vjp``):
    purely-discrete buckets are constant in q per chain, so they shift
    every leaf's Hamiltonian of that chain equally and ∇_q is the full
    log-prob's.
    """
    if fg.cont_pure_quad:
        h, c = fg.quad_h, fg.quad_c
        if fg.quad_sparse:
            def grad_lp(q):
                g = h[None, :] - fg.quad_matvec_batched(q)
                lp = c + 0.5 * torch.sum(q * (h[None, :] + g), dim=-1)
                return g, lp

            return grad_lp
        J = fg.quad_J

        def grad_lp(q):
            g = h[None, :] - q @ J
            lp = c + 0.5 * torch.sum(q * (h[None, :] + g), dim=-1)
            return g, lp

        return grad_lp

    def grad_lp(q):
        with torch.enable_grad():
            qr = q.detach().requires_grad_(True)
            lp = fg.log_prob_cont_batched(qr, xd)
            g = torch.autograd.grad(torch.sum(lp), qr, allow_unused=True)[0]
        return (torch.zeros_like(q) if g is None else g), lp.detach()

    return grad_lp


def _uturn_batched(dq, p_a, p_b, inv_mass):
    """Generalized U-turn test, batched over chains: [C, n] → [C] bool."""
    im = inv_mass[None, :]
    return (torch.sum(dq * im * p_a, dim=-1) < 0.0) | (
        torch.sum(dq * im * p_b, dim=-1) < 0.0)


class _NUTS:
    """Batched trajectory state of the lockstep loop ([C]-shaped unless
    noted); the reference's NamedTuple, updated in place."""

    def __init__(self, xc, p0, g0, h0, max_depth: int):
        C, n = xc.shape
        dev, dt = xc.device, xc.dtype
        self.q_l, self.p_l, self.g_l = xc, p0, g0
        self.q_r, self.p_r, self.g_r = xc, p0, g0
        self.q, self.p, self.g = xc, p0, g0
        self.q_prop, self.sub_q_prop = xc, xc
        self.h0 = h0
        self.log_w = torch.zeros((C,), dtype=dt, device=dev)
        self.sub_log_w = torch.full((C,), -math.inf, dtype=dt, device=dev)
        self.sum_acc = torch.zeros((C,), dtype=dt, device=dev)
        self.n_leaf = torch.zeros((C,), dtype=torch.int32, device=dev)
        self.dir = torch.ones((C,), dtype=dt, device=dev)  # ±1.0 per chain
        self.done = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.sub_bad = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.diverged = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.depth_c = torch.zeros((C,), dtype=torch.int32, device=dev)
        # [max_depth+1, C, n] checkpoint stacks
        self.q_ck = torch.zeros((max_depth + 1, C, n), dtype=dt, device=dev)
        self.p_ck = torch.zeros((max_depth + 1, C, n), dtype=dt, device=dev)


def _nuts_lockstep(fg: CompiledFG, gen, xc, xd, eps, inv_mass,
                   max_depth: int, uniforms=None, p0=None):
    """One NUTS transition for ALL chains in lockstep (the plain version of
    K3). Returns ``(q_prop, sum_acc, n_leaf, depth, diverged)``.

    ``p0`` defaults to ``std·N(0, 1)`` drawn from ``gen``. ``uniforms``
    ([3, 2^max_depth, C]) replaces the uniform draws: the direction draw of
    depth d reads step 2^d − 1 of row 0, a leaf reads its own step of row 1
    and a merge the step after the subtree's last leaf of row 2 (the
    reference's ``fold_in`` steps); the direction is forward where
    ``u < 0.5``. Otherwise each is one fresh ``torch.rand`` from ``gen``.

    The loop stops when every chain is done: it reads ``any(~done)`` back
    to the host once per doubling, so on CUDA tensors this path syncs at
    most ``max_depth`` times per transition (K3 does not).
    """
    C, n = xc.shape
    dev = xc.device
    grad_lp = _make_grad_lp(fg, xd)
    if p0 is None:
        from lhvi_tpu_torch.ops.nuts_traj import momentum_std

        p0 = momentum_std(inv_mass)[None, :] * torch.randn(
            (C, n), generator=gen, device=dev)
    if uniforms is not None:
        from lhvi_tpu_torch.ops.nuts_traj import _check_uniforms

        _check_uniforms(uniforms, max_depth, C, dev)

    def draw(kind: int, step: int):
        if uniforms is not None:
            return uniforms[kind, step]
        return torch.rand((C,), generator=gen, device=dev)

    im = inv_mass[None, :]
    neg_inf = torch.full((), -math.inf, device=dev)
    g0, lp0 = grad_lp(xc)
    s = _NUTS(xc, p0, g0, -lp0 + 0.5 * torch.sum(im * p0 * p0, dim=-1),
              max_depth)

    for d in range(max_depth):
        if not bool(torch.any(~s.done)):
            break
        # --- start of subtree: per-chain directions, move to that end ----
        fwd = draw(0, (1 << d) - 1) < 0.5
        go = ~s.done
        s.dir = torch.where(go, torch.where(fwd, 1.0, -1.0), s.dir)
        gm = go[:, None]
        fm = fwd[:, None]
        s.sub_q_prop = s.q
        s.q = torch.where(gm, torch.where(fm, s.q_r, s.q_l), s.q)
        s.p = torch.where(gm, torch.where(fm, s.p_r, s.p_l), s.p)
        s.g = torch.where(gm, torch.where(fm, s.g_r, s.g_l), s.g)
        s.sub_log_w = torch.full((C,), -math.inf, dtype=xc.dtype, device=dev)
        s.sub_bad = torch.zeros((C,), dtype=torch.bool, device=dev)

        for j in range(1 << d):
            step = (1 << d) - 1 + j
            # --- one leapfrog leaf for every active chain ----------------
            active = ~s.done & ~s.sub_bad
            e = (s.dir * eps)[:, None]
            p_half = s.p + 0.5 * e * s.g
            q_new = s.q + e * im * p_half
            g_new, lp_new = grad_lp(q_new)
            p_new = p_half + 0.5 * e * g_new
            hh = -lp_new + 0.5 * torch.sum(im * p_new * p_new, dim=-1)
            dh = hh - s.h0
            div = ~torch.isfinite(dh) | (dh > _DIVERGENCE)
            lw = torch.where(div, neg_inf, -dh)
            acc_term = torch.where(torch.isfinite(dh),
                                   torch.clamp(torch.exp(-dh), max=1.0),
                                   torch.zeros((), device=dev))
            u = draw(1, step)
            s.sub_log_w = torch.logaddexp(s.sub_log_w,
                                          torch.where(active, lw, neg_inf))
            take = active & (torch.log(u) < (lw - s.sub_log_w)) & ~div
            s.sub_q_prop = torch.where(take[:, None], q_new, s.sub_q_prop)
            am = active[:, None]
            s.q = torch.where(am, q_new, s.q)
            s.p = torch.where(am, p_new, s.p)
            s.g = torch.where(am, g_new, s.g)
            turned = torch.zeros((C,), dtype=torch.bool, device=dev)
            if j % 2 == 0:  # checkpoint even leaves at slot popcount(j)
                slot = _popcount(j)
                s.q_ck[slot] = torch.where(am, q_new, s.q_ck[slot])
                s.p_ck[slot] = torch.where(am, p_new, s.p_ck[slot])
            else:  # odd leaves: U-turn against the stored boundaries
                dr = s.dir[:, None]
                for l in range(_ctz(j + 1)):
                    sl = _popcount(j + 1 - (1 << (l + 1)))
                    dq = (q_new - s.q_ck[sl]) * dr
                    turned = turned | (active & _uturn_batched(
                        dq, s.p_ck[sl] * dr, p_new * dr, inv_mass))
            s.sub_bad = s.sub_bad | (active & (div | turned))
            s.sum_acc = s.sum_acc + torch.where(active, acc_term,
                                                torch.zeros((), device=dev))
            s.n_leaf = s.n_leaf + active.to(torch.int32)
            s.diverged = s.diverged | (active & div)

        # --- merge the completed subtree (biased progressive sampling) ---
        going = ~s.done
        ok1 = going & ~s.sub_bad
        um = draw(2, (2 << d) - 1)
        take_new = ok1 & (torch.log(um) < (s.sub_log_w - s.log_w))
        s.q_prop = torch.where(take_new[:, None], s.sub_q_prop, s.q_prop)
        s.log_w = torch.where(ok1, torch.logaddexp(s.log_w, s.sub_log_w),
                              s.log_w)
        ok = ok1[:, None]
        fwd_m = s.dir[:, None] > 0
        s.q_l = torch.where(ok & ~fwd_m, s.q, s.q_l)
        s.p_l = torch.where(ok & ~fwd_m, s.p, s.p_l)
        s.g_l = torch.where(ok & ~fwd_m, s.g, s.g_l)
        s.q_r = torch.where(ok & fwd_m, s.q, s.q_r)
        s.p_r = torch.where(ok & fwd_m, s.p, s.p_r)
        s.g_r = torch.where(ok & fwd_m, s.g, s.g_r)
        turn_glob = _uturn_batched(s.q_r - s.q_l, s.p_l, s.p_r, inv_mass)
        s.done = s.done | s.sub_bad | (going & turn_glob)
        s.depth_c = torch.where(going, torch.full((), d + 1, dtype=torch.int32,
                                                  device=dev), s.depth_c)
    return s.q_prop, s.sum_acc, s.n_leaf, s.depth_c, s.diverged


def _nuts_sweep_batched(fg: CompiledFG, gen, xc, xd, eps, inv_mass,
                        max_depth: int, uniforms=None):
    """One NUTS transition for ALL chains →
    ``(xc', accept_stat [C], depth [C], diverged [C], n_leaf [C] i32)``,
    ``n_leaf`` the leapfrog leaves each chain integrated until its tree
    stopped (on both routes).

    The one place NUTS's route is chosen: dense pure-quadratic targets on
    CUDA tensors take the fused trajectory (``ops.nuts_traj.
    nuts_trajectory``, kernel K3); everything else takes the lockstep loop,
    K3's plain version, as the reference's XLA path. ``uniforms`` (see
    :func:`_nuts_lockstep`) fixes the tree's uniforms on either route.
    """
    if xc.is_cuda and fg.cont_pure_quad and not fg.quad_sparse:
        from lhvi_tpu_torch.ops.nuts_traj import nuts_trajectory

        return nuts_trajectory(fg, gen, xc, eps, inv_mass, max_depth,
                               uniforms=uniforms)
    q_prop, sum_acc, n_leaf, depth, div = _nuts_lockstep(
        fg, gen, xc, xd, eps, inv_mass, max_depth, uniforms=uniforms)
    accept = sum_acc / torch.clamp(n_leaf, min=1).to(torch.float32)
    return q_prop, accept, depth, div, n_leaf


def nuts_transition(fg: CompiledFG, cfg: NUTSConfig, state: _hmc.HMCState,
                    gen, adapt: bool, gate=None, shard=None):
    """One NUTS-within-Gibbs transition for all chains (the mode-swap move
    after the Gibbs stage where it is on; ``gate`` and ``shard`` as in
    ``hmc.hmc_transition``). Returns ``(state, (acc [C], depth [C],
    div [C], n_leaf [C]))``, ``n_leaf`` the leaves each chain's tree
    integrated. Counted as ``nuts.transitions``; timed as span
    ``nuts.transition``."""
    count("nuts.transitions")
    with span("nuts.transition"):
        hcfg = cfg.to_hmc()
        xd = _hmc.sweep_all(fg, hcfg, gen, state.xc, state.xd)
        state, xd = _hmc.mode_swap_stage(fg, cfg, state, gen, gate, xd)
        if fg.n_cont == 0:
            C = state.xc.shape[0]
            dev = state.xc.device
            zeros = torch.zeros((C,), dtype=torch.int32, device=dev)
            return state._replace(xd=xd), (
                torch.ones((C,), device=dev), zeros,
                torch.zeros((C,), dtype=torch.bool, device=dev), zeros)
        eps = torch.exp(state.log_eps)
        xc, acc, depth, div, n_leaf = _nuts_sweep_batched(
            fg, gen, state.xc, xd, eps, state.inv_mass, cfg.max_depth)
        check_nan("nuts_transition", xc=xc, acc=acc)
        state = state._replace(xc=xc, xd=xd)
        if adapt:
            state = _hmc._da_update(state, _hmc.chain_mean(acc, shard), hcfg)
            state = _hmc._welford_update(state, xc, shard)
    return state, (acc, depth, div, n_leaf)


def chain_step(fg: CompiledFG, cfg: NUTSConfig, shard=None):
    """``hmc.run_chains``'s step of NUTS: one ``nuts_transition`` (looked
    up at call time), reporting ``_STATS`` and each chain's leaves as
    ``n_leaf``."""

    def step(state, gen, gate, adapt):
        state, (acc, depth, div, n_leaf) = nuts_transition(
            fg, cfg, state, gen, adapt, gate, shard)
        return state, {"accept_rate": acc, "mean_depth": depth,
                       "divergence_rate": div, "n_leaf": n_leaf}

    return step


def run_nuts(
    fg: CompiledFG,
    gen: torch.Generator,
    cfg: NUTSConfig = NUTSConfig(),
    n_chains: int = 8,
    n_warmup: int = 500,
    n_samples: int = 1000,
    thin: int = 1,
    collect: str = "samples",
    stream_diag: bool = True,
    disc_diag_cap: int = 4096,
    shard=None,
):
    """NUTS-within-Gibbs over the compiled graph through
    ``hmc.run_chains``, with the contract of ``hmc.run_hmc`` (``shard``
    included); ``diag`` adds ``mean_depth`` and ``divergence_rate``, read
    as the acceptance is.

    The call is span ``nuts.query``, which opens a new query id. The
    leaves every chain integrated, over all transitions, are summed on the
    device (``_LEAF_FOLD`` transitions at a time, so a transition adds no
    launch) and added to the counter ``nuts.leaves`` once, at the end (one
    read to the host a call, none a transition).
    """
    with span("nuts.query", new_query=True):
        fg, cfg = _hmc._ensure_mode_swap_plan(fg, cfg)
        base = chain_step(fg, cfg, shard)
        leaves = torch.zeros((), dtype=torch.int64, device=fg.device)
        pending = []  # per-chain leaf counts not yet in ``leaves``

        def fold_leaves():
            nonlocal leaves
            if pending:
                leaves = leaves + torch.sum(torch.stack(pending))
                pending.clear()

        def step(state, g, gate, adapt):
            state, stats = base(state, g, gate, adapt)
            pending.append(stats["n_leaf"])
            if len(pending) == _LEAF_FOLD:
                fold_leaves()
            return state, stats

        out = _hmc.run_chains(
            fg, gen, cfg.to_hmc(), step, _STATS, who="run_nuts",
            n_chains=n_chains, n_warmup=n_warmup, n_samples=n_samples,
            thin=thin, collect=collect, stream_diag=stream_diag,
            disc_diag_cap=disc_diag_cap, shard=shard)
        fold_leaves()
        count("nuts.leaves", int(leaves))
        return out


def sample(fg: CompiledFG, gen, **kw):
    """Convenience wrapper: run and wrap results for RV-level queries."""
    return _hmc._result(fg, run_nuts(fg, gen, kw.pop("cfg", NUTSConfig()),
                                     **kw))
