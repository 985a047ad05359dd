"""Expectation Particle Belief Propagation (PyTorch port of
``lhvi_tpu/engines/epbp.py``; Lienart et al. 2015).

Log-space particle BP: every continuous variable carries a particle set
drawn from an adaptive Gaussian proposal (moment-matched to its current
belief each iteration); discrete variables enumerate their domains.
Messages are tables over the *current* particle sets; a factor→variable
update importance-weights the sum over neighbour particle tuples:

  m_{f→v}(x) = logsumexp_{u_{-v}} [ log φ(x, u)
               + Σ_{w≠v} (cavity_w(u_w) − log q_w(u_w)) ]

The per-slot mixed grids (target slot at NEW particles, other slots at
OLD particles) are evaluated as batched bucket tensors on the device and
reduced with logsumexp. Grid axes are per slot: continuous slots use P
particle sites, discrete slots their domain size, so a hybrid factor
costs O(P^n_cont · V^n_disc) (support tables are ``max(P, max_v)`` wide).

The proposal's standard normals are drawn apart from the update
(``proposal_noise``), so ``epbp_run`` is a pure function of them: given
the same numbers, both packages compute the same run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple

import numpy as np
import torch

from lhvi_tpu_torch.engines.lbp import (
    _edge_weights,
    _grid_shape,
    _normalize_last,
    _stack_axes,
    _trapezoid,
    assemble_beliefs,
    clip_neg,
    grid_params,
)
from lhvi_tpu_torch.fg.compile import CompiledFG, build_edge_gather

_NEG = -1e30


class _BucketIdx(NamedTuple):
    gvid: torch.Tensor  # i64 [n_f, a] var row per slot (0 for observed)
    lat: torch.Tensor  # f32 [n_f, a]
    is_cont: torch.Tensor  # f32 [n_f, a] (1 for a continuous slot)
    const: torch.Tensor  # f32 [n_f, a] observed-slot value
    const_idx: torch.Tensor  # i64 [n_f, a] observed-slot value index (discrete)
    w_edge: torch.Tensor  # f32 [n_f, a]


def _index_buckets(fg: CompiledFG) -> List[_BucketIdx]:
    dev = fg.device
    out = []
    for b, np_b in zip(fg.buckets, fg.meta.np_buckets):
        a = len(b.pattern)
        n_f = b.n_factors
        gvid = np.zeros((n_f, a), np.int64)
        lat = np.zeros((n_f, a), np.float32)
        isc = np.zeros((n_f, a), np.float32)
        const = np.zeros((n_f, a), np.float32)
        const_idx = np.zeros((n_f, a), np.int64)
        ci = di = 0
        for p, is_cont in enumerate(b.pattern):
            if is_cont:
                gvid[:, p] = np_b["cont_idx"][:, ci]
                lat[:, p] = np_b["cont_mask"][:, ci]
                isc[:, p] = 1.0
                const[:, p] = np_b["cont_const"][:, ci]
                ci += 1
            else:
                gvid[:, p] = fg.n_cont + np_b["disc_idx"][:, di]
                lat[:, p] = np_b["disc_mask"][:, di]
                const_idx[:, p] = np_b["disc_const"][:, di]
                const[:, p] = np.take_along_axis(
                    np_b["disc_vals"][:, di, :], const_idx[:, p: p + 1],
                    axis=1)[:, 0]
                di += 1
        w_edge = _edge_weights(fg, np_b, gvid)
        out.append(_BucketIdx(
            gvid=torch.tensor(gvid, device=dev),
            lat=torch.tensor(lat, device=dev),
            is_cont=torch.tensor(isc, device=dev),
            const=torch.tensor(const, device=dev),
            const_idx=torch.tensor(const_idx, device=dev),
            w_edge=torch.tensor(w_edge.astype(np.float32), device=dev),
        ))
    return out


def _eval_bucket_grid(b, bi: _BucketIdx, slot_vals, slot_idx, sizes: tuple):
    """log φ over the product grid given per-slot support tables
    (``slot_vals [n_f, a, W]``, ``slot_idx`` i64 ``[n_f, a, W]``;
    ``sizes[p]`` is slot p's grid-axis length) →
    ``[n_f, sizes[0], …, sizes[a-1]]``."""
    a, n_f = bi.gvid.shape[1], bi.gvid.shape[0]
    shape = (n_f,) + tuple(sizes)
    xc_axes, xdi_axes, xdv_axes = [], [], []
    for p, is_cont in enumerate(b.pattern):
        bshape = _grid_shape(n_f, a, p, sizes[p])
        vp = slot_vals[:, p, : sizes[p]].reshape(bshape).expand(shape)
        if is_cont:
            xc_axes.append(vp)
        else:
            xdi_axes.append(
                slot_idx[:, p, : sizes[p]].reshape(bshape).expand(shape))
            xdv_axes.append(vp)
    lp = b.kernel(grid_params(b.params, a),
                  *_stack_axes(xc_axes, xdi_axes, xdv_axes, shape,
                               slot_vals.device))
    return clip_neg(lp)


@dataclasses.dataclass(frozen=True)
class EPBPConfig:
    n_particles: int = 32
    n_iters: int = 15
    q_var_floor: float = 1e-3


def _table_width(fg: CompiledFG, P: int) -> int:
    """Support-table width: P particle sites for continuous rows, the
    full domain for discrete rows, whichever is larger."""
    return max(P, fg.max_v, 1)


def _slot_sizes(b, P: int, max_v: int) -> tuple:
    """Per-slot grid-axis lengths for one bucket's factors."""
    return tuple(P if is_cont else max_v for is_cont in b.pattern)


def _static_tables(fg: CompiledFG, P: int):
    """(sup_idx i64 [n_var, W], dmask f32 [n_var, W]): support indices and
    valid positions (a prefix of P for continuous rows, the domain size
    for discrete rows)."""
    W = _table_width(fg, P)
    n_var = max(fg.n_cont + fg.n_disc, 1)
    dev = fg.device
    sup_idx = torch.arange(W, device=dev)[None].expand(n_var, W)
    lens = torch.cat([torch.full((fg.n_cont,), P, dtype=torch.int64,
                                 device=dev), fg.disc_sizes])[:n_var]
    dmask = (torch.arange(W, device=dev)[None, :]
             < lens[:, None]).to(torch.float32)
    return sup_idx, dmask


def _slot_tables(bi: _BucketIdx, sup, sup_idx, which_new=None, sup_new=None):
    """``[n_f, a, W]`` slot values/indices from the support table; slot
    ``which_new`` (if any) reads from ``sup_new`` instead."""
    rows = sup[bi.gvid]  # [n_f, a, W] (a copy)
    if which_new is not None:
        rows[:, which_new, :] = sup_new[bi.gvid[:, which_new]]
    # observed slots: their constant at every position
    vals = torch.where(bi.lat[..., None] > 0, rows, bi.const[..., None])
    idx = torch.where(bi.lat[..., None] > 0, sup_idx[bi.gvid],
                      bi.const_idx[..., None])
    return vals, idx


def _log_q(fg: CompiledFG, sup, q_mu, q_var, W: int, n_var: int):
    """Per-row log-proposal at the support points (0 on discrete rows)."""
    dev = sup.device
    if fg.n_cont:
        lq_c = -0.5 * ((sup[: fg.n_cont] - q_mu[:, None]) ** 2 / q_var[:, None]
                       + torch.log(2 * math.pi * q_var[:, None]))
    else:
        lq_c = torch.zeros((0, W), device=dev)
    return torch.cat([lq_c, torch.zeros((n_var - fg.n_cont, W), device=dev)],
                     0)


def _beliefs_of(msgs, bidx, plan, n_var: int, W: int):
    dev = msgs[0].device if msgs else torch.device("cpu")
    return assemble_beliefs(
        [bi.w_edge[..., None] * m * bi.lat[..., None]
         for bi, m in zip(bidx, msgs)], plan, n_var, W, dev)


def _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var: int, P: int,
                 sup_old, msgs_old, lq_old, sup_new, normalize: bool = True):
    """One synchronous message update targeting the ``sup_new`` points.

    ``normalize=False`` keeps per-edge constants, so two passes from one
    (sup_old, msgs_old) state, a dense grid pass and an arbitrary-x query
    pass, are on one scale.
    """
    W = _table_width(fg, P)
    max_v = max(fg.max_v, 1)
    B_old = _beliefs_of(msgs_old, bidx, plan, n_var, W)
    new_msgs = []
    for b, bi, m_old in zip(fg.buckets, bidx, msgs_old):
        a = bi.gvid.shape[1]
        sizes = _slot_sizes(b, P, max_v)
        cav = B_old[bi.gvid] - m_old  # [n_f, a, W] at OLD particles
        cav = cav - bi.is_cont[..., None] * (lq_old[bi.gvid] + math.log(P))
        cav = torch.where(dmask[bi.gvid] > 0, cav, _NEG)
        cav = torch.where(bi.lat[..., None] > 0, cav, 0.0)
        upd = []
        for p in range(a):
            vals, idx = _slot_tables(bi, sup_old, sup_idx, which_new=p,
                                     sup_new=sup_new)
            lp = _eval_bucket_grid(b, bi, vals, idx, sizes)
            for q in range(a):
                if q == p:
                    continue
                shape = [1] * lp.dim()
                shape[0] = lp.shape[0]
                shape[1 + q] = sizes[q]
                lp = lp + cav[:, q, : sizes[q]].reshape(shape)
            axes = tuple(1 + q for q in range(a) if q != p)
            red = torch.logsumexp(lp, dim=axes) if axes else lp
            if sizes[p] < W:  # pad the target axis back to the table width
                red = torch.nn.functional.pad(red, (0, W - sizes[p]),
                                              value=_NEG)
            upd.append(red)
        m_new = torch.stack(upd, 1)
        if normalize:
            m_new = _normalize_last(m_new)
        new_msgs.append(clip_neg(m_new))
    return tuple(new_msgs)


def proposal_noise(fg: CompiledFG, gen: torch.Generator, P: int,
                   n_iters: int):
    """The run's standard normals, ``n_iters + 1`` tensors of
    ``[max(n_cont, 1), P]`` (the initial support, then one per
    iteration), drawn from ``gen`` on ``fg.device``."""
    return [torch.randn((max(fg.n_cont, 1), P), generator=gen,
                        device=fg.device) for _ in range(n_iters + 1)]


def epbp_run(fg: CompiledFG, bidx, plan, cfg: EPBPConfig, eps):
    """The EPBP iteration from the proposal normals ``eps``
    (``proposal_noise``'s list; its length sets the iteration count) →
    ``(sup_grid, sup_idx, dmask, B, q_mu, q_var, sup, msgs, lq)``: the
    final beliefs ``B`` tabulated on a dense grid per continuous var,
    and the final particle state for density queries."""
    P = cfg.n_particles
    W = _table_width(fg, P)
    n_var = max(fg.n_cont + fg.n_disc, 1)
    dev = fg.device
    sup_idx, dmask = _static_tables(fg, P)
    disc_rows = torch.zeros((max(fg.n_disc, 1), W), device=dev)
    if fg.n_disc:
        disc_rows = torch.nn.functional.pad(fg.disc_vals, (0, W - fg.max_v))

    q_mu = 0.5 * (fg.cont_lo + fg.cont_hi)
    q_var = torch.ones(fg.n_cont, device=dev) * torch.clamp(
        (fg.cont_hi - fg.cont_lo) / 4.0, max=3.0) ** 2
    msgs = tuple(torch.zeros(bi.gvid.shape + (W,), device=dev) for bi in bidx)

    def support_from(q_mu, q_var, e):
        if not (fg.n_cont or fg.n_disc):
            return torch.zeros((n_var, W), device=dev)
        cont_rows = q_mu[:, None] + torch.sqrt(q_var)[:, None] * e[: fg.n_cont]
        cont_rows = torch.nn.functional.pad(cont_rows, (0, W - P))
        return torch.cat([cont_rows, disc_rows[: fg.n_disc]], dim=0)

    sup = support_from(q_mu, q_var, eps[0])
    for e in eps[1:]:
        B_old = _beliefs_of(msgs, bidx, plan, n_var, W)
        lq_old = _log_q(fg, sup, q_mu, q_var, W, n_var)
        if fg.n_cont:
            # refit the proposals from the current beliefs (importance
            # moment matching)
            lw = B_old[: fg.n_cont] - lq_old[: fg.n_cont]
            lw = torch.where(dmask[: fg.n_cont] > 0, lw, -math.inf)
            w = torch.exp(lw - torch.logsumexp(lw, 1, keepdim=True))
            m1 = torch.sum(w * sup[: fg.n_cont], 1)
            m2 = torch.sum(w * (sup[: fg.n_cont] - m1[:, None]) ** 2, 1)
            q_mu, q_var = m1, torch.clamp(m2, min=cfg.q_var_floor)
        # discrete rows keep their static values
        sup_new = torch.cat([support_from(q_mu, q_var, e)[: fg.n_cont],
                             sup[fg.n_cont:]], dim=0)
        msgs = _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var, P, sup,
                            msgs, lq_old, sup_new)
        sup = sup_new

    # Rao-Blackwellized final pass: messages on a deterministic dense grid
    # per continuous var
    if fg.n_cont:
        t = torch.linspace(0.0, 1.0, P, device=dev)[None, :]
        span = 4.0 * torch.sqrt(q_var)
        lo = torch.maximum(q_mu - span, fg.cont_lo)
        hi = torch.minimum(q_mu + span, fg.cont_hi)
        grid_rows = torch.nn.functional.pad(
            lo[:, None] + (hi - lo)[:, None] * t, (0, W - P))
        sup_grid = torch.cat([grid_rows, sup[fg.n_cont:]], dim=0)
    else:
        sup_grid = sup
    lq = _log_q(fg, sup, q_mu, q_var, W, n_var)
    # UNNORMALIZED grid pass: shares per-edge constants with any later
    # arbitrary-x query pass from the same (sup, msgs, lq) state
    msgs_grid = _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var, P, sup,
                             msgs, lq, sup_grid, normalize=False)
    B = _beliefs_of(msgs_grid, bidx, plan, n_var, W)
    return sup_grid, sup_idx, dmask, B, q_mu, q_var, sup, msgs, lq


def _epbp_query(fg: CompiledFG, bidx, plan, cfg: EPBPConfig, sup, msgs, lq,
                sup_grid, row: int, xq):
    """Belief row at caller-supplied points ``xq [W]`` for variable ``row``:
    one unnormalized message pass from the final state targeting the grid
    support with ``row`` replaced by ``xq`` (the stored grid beliefs'
    constants, so exp(B_q − logZ_grid) is the density)."""
    P = cfg.n_particles
    W = _table_width(fg, P)
    n_var = max(fg.n_cont + fg.n_disc, 1)
    sup_idx, dmask = _static_tables(fg, P)
    sup_q = sup_grid.clone()
    sup_q[row] = xq
    msgs_q = _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var, P, sup, msgs,
                          lq, sup_q, normalize=False)
    return _beliefs_of(msgs_q, bidx, plan, n_var, W)[row]


class EPBP:
    """Engine facade: ``EPBP(fg, cfg).run(gen)`` then queries; runs on
    ``fg.device`` with draws from ``gen`` (a ``torch.Generator`` there)."""

    def __init__(self, fg: CompiledFG, cfg: EPBPConfig = EPBPConfig()):
        fg.require_whole("EPBP")
        self.fg = fg
        self.cfg = cfg
        self.bidx = _index_buckets(fg)
        self.edge_plan = build_edge_gather(
            fg.meta.np_buckets, [b.pattern for b in fg.buckets],
            fg.n_cont, fg.n_disc, fg.device)
        self.state = None

    def run(self, gen: torch.Generator, n_iters: int = None):
        n_iters = n_iters or self.cfg.n_iters
        eps = proposal_noise(self.fg, gen, self.cfg.n_particles, n_iters)
        return self.run_from(eps)

    def run_from(self, eps):
        """The run from given proposal normals (``proposal_noise``)."""
        out = epbp_run(self.fg, self.bidx, self.edge_plan, self.cfg, eps)
        (sup_grid, sup_idx, dmask, B, q_mu, q_var,
         sup_final, msgs_final, lq_final) = out
        self.sup, self.sup_idx, self.sup_mask, self.B, self.q_mu, self.q_var = (
            o.cpu().numpy() for o in (sup_grid, sup_idx, dmask, B, q_mu, q_var))
        # the final message state stays on the device for density queries
        self._sup_grid_j = sup_grid
        self._sup_j = sup_final
        self._msgs_j = msgs_final
        self._lq_j = lq_final
        return self

    # --- queries ----------------------------------------------------------
    def _row(self, rv, want=None):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if want and kind != want:
            raise ValueError(
                f"{rv} is {'continuous' if kind == 'c' else 'discrete'}")
        return kind, (i if kind == "c" else self.fg.n_cont + i), i

    def _weights(self, row, kind):
        # beliefs tabulated on a uniform dense grid (continuous) or the
        # full domain (discrete): density ∝ exp(B)
        lw = np.where(self.sup_mask[row] > 0, self.B[row], -np.inf)
        if not np.isfinite(lw).any():
            # every message underflowed: the masked-uniform distribution
            m = (self.sup_mask[row] > 0).astype(np.float64)
            return m / m.sum()
        lw -= lw.max()
        w = np.exp(lw) * (self.sup_mask[row] > 0)
        return w / w.sum()

    def mean(self, rv) -> float:
        kind, row, _ = self._row(rv, "c")
        w = self._weights(row, kind)
        return float(np.sum(w * self.sup[row]))

    def var(self, rv) -> float:
        kind, row, _ = self._row(rv, "c")
        w = self._weights(row, kind)
        m = np.sum(w * self.sup[row])
        return float(np.sum(w * (self.sup[row] - m) ** 2))

    def disc_marginal(self, rv):
        kind, row, i = self._row(rv, "d")
        w = self._weights(row, kind)
        return w[: self.fg.meta.disc_size(rv)]

    def map(self, rv):
        kind, row, _ = self._row(rv)
        w = self._weights(row, kind)
        if kind == "c":
            return float(self.sup[row][int(np.argmax(w))])
        return self.fg.meta.disc_values(rv)[
            int(np.argmax(w[: self.fg.meta.disc_size(rv)]))]

    # --- arbitrary-x density queries --------------------------------------
    def _query_logb(self, xs: np.ndarray, row: int):
        """Log unnormalized message product at ``xs`` + grid log-normalizer."""
        P = self.cfg.n_particles
        W = _table_width(self.fg, P)
        valid = self.sup_mask[row] > 0
        grid = self.sup[row][valid]
        Brow = self.B[row][valid]
        bmax = float(Brow.max())
        logZ = bmax + float(np.log(_trapezoid(np.exp(Brow - bmax), grid)))
        vals = np.empty(len(xs))
        for s in range(0, len(xs), P):
            blk = xs[s: s + P]
            pad = np.pad(blk, (0, W - len(blk)), mode="edge")
            bq = _epbp_query(
                self.fg, self.bidx, self.edge_plan, self.cfg, self._sup_j,
                self._msgs_j, self._lq_j, self._sup_grid_j, row,
                torch.tensor(pad, dtype=torch.float32, device=self.fg.device))
            vals[s: s + len(blk)] = bq.cpu().numpy()[: len(blk)]
        return vals, logZ, bmax

    def belief(self, x, rv):
        """Normalized posterior density (continuous) / pmf (discrete) at
        caller-supplied ``x`` (scalar or array): a fresh message pass at
        ``x``, not a table lookup."""
        kind, row, _ = self._row(rv)
        if kind == "d":
            pmf = self.disc_marginal(rv)
            xs = np.atleast_1d(x)
            out = np.array(
                [pmf[self.fg.meta.value_index(rv, v)] for v in xs])
            return float(out[0]) if np.ndim(x) == 0 else out
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, logZ, _ = self._query_logb(xs, row)
        out = np.exp(vals - logZ)
        return float(out[0]) if np.ndim(x) == 0 else out

    def probability(self, x, rv):
        """Unnormalized message product Π m(x) at ``x`` (up to one per-run
        constant shared with the belief grid)."""
        kind, row, _ = self._row(rv)
        if kind == "d":
            return self.belief(x, rv)
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, _, bmax = self._query_logb(xs, row)
        out = np.exp(vals - bmax)
        return float(out[0]) if np.ndim(x) == 0 else out
