"""Collapsed orbit-flip MH move: unlocks mode-locked discrete blocks
(PyTorch port of ``lhvi_tpu/engines/modeswap.py``).

On the pod flagship (friends-smokers MLN) the ``friends(X,Y) ⇒
(smokes(X) ⇔ smokes(Y))`` couplings ground to a ferromagnetic clique over
the free ``smokes`` latents: a single-site flip against it faces a barrier
of roughly ``w · degree``, so every chain freezes the block at the joint
mode it started in. The move that unlocks it is the COLLAPSED flip:

  1. **Group** ``G``: a discrete class of the IR colour refinement
     (``lift.fast.refine_ir``), kept when two of its members share a
     factor row (only intra-coupled blocks can mode-lock).
  2. **Proposal**: one uniformly chosen value transposition ``a ↔ b``
     applied to every member of ``G`` (an involution: no Hastings factor),
     then a redraw of a precomputed independent set ``F`` of G's discrete
     neighbours from their full conditionals given the flipped block.
  3. **Accept** with the collapsed ratio π̃(g')/π̃(g),

         log π̃(g) = Σ_{f∈F} logsumexp_v β·logit_f(v; g) + β · direct(g)

     where ``direct`` sums the rows touching G and no F member: the
     anchoring neighbours are summed out rather than dragged along.

Each group step is a valid MH kernel for any fixed grouping, so exactness
does not depend on ``G`` being a true orbit.

The reference's ``lax.scan`` over groups is a Python loop; ``vmap`` over
chains is the leading axis. F's logits come from the colour plan
(``hmc.planned_logits``) restricted to the colours that hold a member of
F: the same logits for F, without the all-rows candidate tensors of
``disc_logits`` or the colours that hold no F member. Two reference
faults are not carried (ROADMAP Queue 3): masked variables enter the
collapsed sum through ``torch.where``, not a product, so a variable whose
logits are all −inf outside F gives no NaN; and a NaN in a weighted
direct row stays NaN (``log u < NaN`` rejects) instead of counting as 0.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from lhvi_tpu_torch.fg.compile import _NEG_BIG, CompiledFG


@dataclasses.dataclass(frozen=True, eq=False)
class ModeSwapPlan:
    """Static per-group data for the collapsed orbit-flip move.

    ``vars_[g]`` holds the group's global discrete ids padded with
    ``n_disc``; ``vmax[g]`` the shared domain size (host ints: they bound
    the proposal's draws); ``f_mask[g]`` marks the group's collapsed
    independent neighbour set; ``w_direct`` carries per kept bucket the
    row weights ``[G, R]`` of the direct term (rows touching G and no F
    member; all-zero buckets dropped). ``f_cells[g]`` lists the colour
    plan's (group, colour) cells that hold a member of F (empty without a
    colour plan).
    """

    n_groups: int
    n_vars: int  # padded group width
    direct_buckets: Tuple[int, ...]
    # any group with a non-empty F? Self-contained cliques collapse
    # nothing, and the sweep then skips both logit passes
    has_f: bool
    vars_: torch.Tensor  # i64 [G, M] (pad = n_disc)
    vmax: Tuple[int, ...]
    member: torch.Tensor  # bool [G, n_disc]
    f_mask: torch.Tensor  # bool [G, n_disc]
    w_direct: Tuple[torch.Tensor, ...]  # per kept bucket f32 [G, R]
    f_cells: Tuple[Tuple[Tuple[int, int], ...], ...] = ()


def _row_latents(np_b):
    """(real_row_idx, disc_idx[real], latent_mask[real]) of one host
    bucket mirror."""
    real = np.nonzero(np_b["scale"] > 0)[0]
    return real, np_b["disc_idx"][real], np_b["disc_mask"][real] > 0


# plans keyed by the compiled graph itself (identity; weak, so a dropped
# graph releases its plan): the engines ask on every run, and the host
# refinement costs seconds at pod scale. ``fg.meta`` is no key: it is None
# for a graph built from tables.
_PLAN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_NO_PLAN = object()


def plan_for(fg: CompiledFG) -> Optional[ModeSwapPlan]:
    """Cached ``build_mode_swap_plan(fg)`` (default parameters)."""
    hit = _PLAN_CACHE.get(fg)
    if hit is None:
        hit = build_mode_swap_plan(fg)
        _PLAN_CACHE[fg] = hit if hit is not None else _NO_PLAN
    return None if hit is _NO_PLAN else hit


def build_mode_swap_plan(fg: CompiledFG, min_size: int = 2,
                         max_groups: int = 8) -> Optional[ModeSwapPlan]:
    """Build the collapsed-flip plan for ``fg`` (host numpy, one-time; the
    reference's construction).

    Groups are the discrete classes of the IR colour refinement with ≥
    ``min_size`` members, a domain of ≥ 2 values and a real factor row
    holding two members, largest first up to ``max_groups``. Returns
    ``None`` when nothing qualifies.
    """
    if fg.n_disc == 0:
        return None
    from lhvi_tpu_torch.lift.fast import refine_ir

    _, vcol_d, _ = refine_ir(fg)
    n_disc = fg.n_disc
    sizes = np.asarray(fg.meta.np_global["disc_sizes"], np.int64)
    np_bs = fg.meta.np_buckets

    # host adjacency (latent–latent co-occurrence)
    pairs = []
    for np_b in np_bs:
        _, didx, dlat = _row_latents(np_b)
        a = didx.shape[1] if didx.ndim == 2 else 0
        for p in range(a):
            for q in range(p + 1, a):
                m = dlat[:, p] & dlat[:, q]
                if m.any():
                    pairs.append(np.stack([didx[m, p], didx[m, q]], axis=1))
    if pairs:
        pr = np.concatenate(pairs, axis=0).astype(np.int64)
        pr = pr[pr[:, 0] != pr[:, 1]]
        lo = np.minimum(pr[:, 0], pr[:, 1])
        hi = np.maximum(pr[:, 0], pr[:, 1])
        enc = np.unique(lo * n_disc + hi)
        lo, hi = enc // n_disc, enc % n_disc
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        starts = np.searchsorted(src, np.arange(n_disc + 1))
    else:
        dst = np.zeros(0, np.int64)
        starts = np.zeros(n_disc + 1, np.int64)

    def neighbors(v):
        return dst[starts[v]:starts[v + 1]]

    def classes_of(labels):
        order_ = np.argsort(labels, kind="stable")
        _, grp_starts = np.unique(labels[order_], return_index=True)
        return [g for g in np.split(order_, grp_starts[1:])
                if len(g) >= min_size and sizes[g[0]] >= 2]

    def intra_coupled(classes):
        out = []
        for g in classes:
            gset = np.zeros(n_disc, bool)
            gset[g] = True
            if any(gset[neighbors(v)].any() for v in g):
                out.append(g)
        return out

    groups = intra_coupled(classes_of(vcol_d))
    if not groups:
        # an ordered grounding can shatter a symmetric block; the coarse
        # domain-signature partition only lowers acceptance, never
        # exactness
        vals = np.asarray(fg.meta.np_global["disc_vals"], np.float64)
        sig = np.array([hash((int(sizes[i]),
                              tuple(np.round(vals[i], 6).tolist())))
                        for i in range(n_disc)])
        groups = intra_coupled(classes_of(sig))
    if not groups:
        return None
    groups.sort(key=len, reverse=True)
    groups = groups[:max_groups]

    G = len(groups)
    m = max(len(g) for g in groups)
    vars_ = np.full((G, m), n_disc, np.int64)
    vmax = []
    member = np.zeros((G, n_disc), bool)
    f_mask = np.zeros((G, n_disc), bool)
    for i, g in enumerate(groups):
        vars_[i, : len(g)] = g
        gs = sizes[g]
        if not (gs == gs[0]).all():
            raise ValueError("mode-swap group members must share a domain")
        vmax.append(int(gs[0]))
        member[i, g] = True
        # F: greedy maximal independent subset of G's neighbours (no two F
        # members share any factor row, so the collapsed product factorizes)
        cand = np.unique(np.concatenate([neighbors(v) for v in g]))
        cand = cand[~member[i][cand]]
        blocked = np.zeros(n_disc, bool)
        for f in cand:
            if blocked[f]:
                continue
            f_mask[i, f] = True
            blocked[neighbors(f)] = True

    # direct-term row weights: rows touching G and no F member (F rows
    # live inside the F logits; rows touching neither cancel in the
    # accept delta)
    direct_buckets, w_direct = [], []
    for bi in fg.disc_bucket_idx:
        np_b = np_bs[bi]
        scale = np.asarray(np_b["scale"], np.float32)
        didx_l = np.where(np_b["disc_mask"] > 0, np_b["disc_idx"], n_disc)
        w = np.broadcast_to(scale, (G,) + scale.shape).copy()
        for i in range(G):
            fm = np.concatenate([f_mask[i], np.zeros(1, bool)])
            gm = np.concatenate([member[i], np.zeros(1, bool)])
            w[i, fm[didx_l].any(axis=1)] = 0.0
            w[i, ~gm[didx_l].any(axis=1)] = 0.0
        if (w != 0.0).any():
            direct_buckets.append(bi)
            w_direct.append(torch.tensor(w, device=fg.device))

    f_cells = ()
    if fg.color_plan is not None:
        f_cells = tuple(
            tuple((gi, j) for gi, grp in enumerate(fg.color_plan.groups)
                  for j, cell in enumerate(grp.vars_.cpu().numpy())
                  if f_mask[i, cell[cell < n_disc]].any())
            for i in range(G))

    dev = fg.device
    return ModeSwapPlan(
        n_groups=G, n_vars=m, direct_buckets=tuple(direct_buckets),
        has_f=bool(f_mask.any()),
        vars_=torch.tensor(vars_, device=dev), vmax=tuple(vmax),
        member=torch.tensor(member, device=dev),
        f_mask=torch.tensor(f_mask, device=dev),
        w_direct=tuple(w_direct), f_cells=f_cells)


def _direct_lp(fg: CompiledFG, xc, xd, w_tabs, bucket_idx) -> torch.Tensor:
    """``[C]`` Σ_rows w·log φ over the plan's kept buckets with one
    group's row weights ``w_tabs`` (``[R]`` per bucket). Hard-formula rows
    are legitimately −inf (counted as −1e30); zero-weight rows contribute
    exactly 0, and a NaN in a weighted row stays NaN."""
    total = torch.zeros((xd.shape[0],), device=xd.device)
    for w, bi in zip(w_tabs, bucket_idx):
        b = fg.buckets[bi]
        params, xcs, xdi, xdv = b.gather_args_batched(xc, xd)
        lp = b.kernel(params, xcs, xdi, xdv)  # [C, R]
        lp = torch.nan_to_num(lp, nan=math.nan, neginf=_NEG_BIG)
        total = total + torch.sum(
            torch.where(w[None] != 0, w[None] * lp, 0.0), dim=-1)
    return total


def _tempered_logits(fg: CompiledFG, plan: ModeSwapPlan, group: int, xc,
                     xd, beta):
    """β-tempered full-conditional logits ``[C, n_disc, V]``, exact on the
    rows of group ``group``'s F: through the colour plan's cells that hold
    an F member, else the all-rows ``disc_logits``. Invalid values carry
    −1e30 after tempering (β = 0 must not revive them)."""
    if fg.color_plan is not None:
        from lhvi_tpu_torch.engines.hmc import planned_logits

        L = planned_logits(fg, xc, xd, cells=plan.f_cells[group])
    else:
        L = fg.disc_logits(xc, xd)
    valid = (torch.arange(fg.max_v, device=xd.device)[None, :]
             < fg.disc_sizes[:, None])
    return torch.where(valid[None], beta * L,
                       torch.full((), _NEG_BIG, device=xd.device))


def collapsed_delta(fg: CompiledFG, xc, xd, xd_p, plan: ModeSwapPlan,
                    group: int, beta=1.0):
    """The move's decision for group ``group``: the collapsed log-ratio
    ``delta [C]`` of the flipped state ``xd_p`` against ``xd`` (accept
    where ``log u < delta``), and the tempered logits ``Lp`` at ``xd_p``
    that F is redrawn from (``None`` when no group has an F)."""
    fmask = plan.f_mask[group]
    Lp = None
    if plan.has_f:
        L = _tempered_logits(fg, plan, group, xc, xd, beta)
        Lp = _tempered_logits(fg, plan, group, xc, xd_p, beta)
        S = torch.sum(torch.where(fmask[None], torch.logsumexp(L, -1), 0.0),
                      dim=-1)
        Sp = torch.sum(torch.where(fmask[None], torch.logsumexp(Lp, -1), 0.0),
                       dim=-1)
    else:
        S = Sp = torch.zeros((xd.shape[0],), device=xd.device)
    w_tabs = [w[group] for w in plan.w_direct]
    d0 = _direct_lp(fg, xc, xd, w_tabs, plan.direct_buckets)
    d1 = _direct_lp(fg, xc, xd_p, w_tabs, plan.direct_buckets)
    return (Sp - S) + beta * (d1 - d0), Lp


def mode_swap_sweep(fg: CompiledFG, gen: torch.Generator, xc, xd,
                    plan: ModeSwapPlan, beta=1.0):
    """One collapsed-flip MH pass over the plan's groups for all chains:
    ``xc [C, n_cont]``, ``xd [C, n_disc]`` → ``(xd', accept_mean)`` with
    ``accept_mean`` a 0-d tensor (per-chain accepts averaged over
    groups). ``beta`` tempers logits and direct terms like the tempered
    Gibbs sweep (SMC's rejuvenation targets π^β). Every draw comes from
    ``gen``; nothing is read back to the host."""
    from lhvi_tpu_torch.engines.hmc import categorical

    C, dev = xd.shape[0], xd.device
    accs = []
    for g in range(plan.n_groups):
        v = plan.vmax[g]
        # a uniform unordered value pair per chain: involutive with a
        # state-independent probability, so symmetric; per-chain pairs
        # keep chains independent on V > 2 domains
        a = torch.randint(0, v, (C,), generator=gen, device=dev)
        b = (a + 1 + torch.randint(0, v - 1, (C,), generator=gen,
                                   device=dev)) % v
        a_, b_ = a[:, None], b[:, None]
        swapped = torch.where(xd == a_, b_, torch.where(xd == b_, a_, xd))
        member = plan.member[g][None]
        xd_p = torch.where(member, swapped, xd)
        delta, Lp = collapsed_delta(fg, xc, xd, xd_p, plan, g, beta)
        u = torch.rand((C,), generator=gen, device=dev)
        acc = (torch.log(u) < delta)[:, None]
        xd_out = torch.where(acc & member, xd_p, xd)
        if plan.has_f:
            # accepted chains: F redrawn from the flipped-state
            # conditionals (the proposal the ratio collapsed over)
            f_new = categorical(gen, Lp)
            xd_out = torch.where(acc & plan.f_mask[g][None], f_new, xd_out)
        xd = xd_out
        accs.append(torch.mean(acc.to(torch.float32)))
    return xd, torch.mean(torch.stack(accs))


def gate_generator(gen: torch.Generator) -> torch.Generator:
    """The host generator of ``maybe_mode_swap``'s gate, seeded from one
    draw of the run's generator (one read at the run's start; a
    transition then reads nothing back)."""
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=gen.device)
    return torch.Generator().manual_seed(int(seed.item()))


def maybe_mode_swap(fg: CompiledFG, cfg, gen: torch.Generator,
                    gate: Optional[torch.Generator], xc, xd):
    """The transition-level entry: apply the sweep with probability
    ``1/cfg.mode_swap_every`` (a random-scan mixture kernel, exact). The
    gate's uniform is drawn on the host from ``gate`` (unused at
    ``every = 1``). Returns ``(xd, accept_mean, n_applied)``, ``n_applied``
    a host float: the accumulator counts only applications, so
    ``diag["mode_swap_accept"]`` is a per-application rate."""
    every = max(1, int(cfg.mode_swap_every))
    if every > 1 and float(torch.rand((), generator=gate)) * every >= 1.0:
        return xd, torch.zeros((), device=xd.device), 0.0
    xd, acc = mode_swap_sweep(fg, gen, xc, xd, fg.mode_swap_plan)
    return xd, acc, 1.0
