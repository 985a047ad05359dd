"""Hybrid loopy belief propagation (PyTorch port of
``lhvi_tpu/engines/lbp.py``).

Continuous domains are discretized at their ``Domain.integral_points``;
messages are log-space tables over each variable's support. Each bucket's
factor table ``log φ`` over the full support product grid is computed
ONCE on the device (static points), so an iteration is only

  1. variable beliefs  = sum of incoming messages (the edge gather plan)
  2. var→factor        = belief − incoming (cavity)
  3. factor→var slot p = logsumexp over all grid axes except p

every op batched over the bucket's factor axis; the reference's
``lax.scan`` over iterations is a Python loop.

The support width ``S = max(P, V)`` is global, so an arity-a bucket's table
holds ``S^a`` entries per row (``HybridLBP.table_bytes``).

Lifted mode: on a lifted IR the incoming-message sum weights each
(factor-orbit, slot) message by ``scale_f / count_v``, the per-ground-var
edge multiplicity, which reduces to standard LBP when grounded (scale =
count = 1): one message per cluster edge.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from lhvi_tpu_torch.fg.compile import CompiledFG, build_edge_gather

_NEG = -1e30
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@dataclasses.dataclass(frozen=True)
class LBPConfig:
    n_iters: int = 30
    damping: float = 0.2


class _BucketTables(NamedTuple):
    log_phi: torch.Tensor  # [n_f, S_0, …, S_{a-1}] factor table over the grid
    gvid: torch.Tensor  # i64 [n_f, a] global var id per latent slot (0 if obs)
    lat: torch.Tensor  # f32 [n_f, a] 1 = latent slot
    w_edge: torch.Tensor  # f32 [n_f, a] lifted edge multiplicity scale_f/count_v


class _QueryAux(NamedTuple):
    """Per-bucket tables for re-evaluating log φ at arbitrary query points
    (``belief(x, rv)`` / ``probability(x, rv)``)."""

    slot_vals: torch.Tensor  # f32 [n_f, a, S] support values (obs slots: const)
    slot_idx: torch.Tensor  # i64 [n_f, a, S] discrete value indices (0 for cont)
    slot_valid: torch.Tensor  # f32 [n_f, a, S] valid support positions per slot


def grid_params(params, n_axes: int):
    """Insert ``n_axes`` singleton axes after the factor axis (axis 0) of
    every ``[n_f, …]`` parameter leaf (the reference's ``expand_params``),
    so the leaves broadcast against ``[n_f, S, …, S]`` grids."""
    return {k: v.reshape(v.shape[:1] + (1,) * n_axes + v.shape[1:])
            for k, v in params.items()}


def clip_neg(x):
    """NaN → 0, −inf → −1e30, and nothing below −1e30."""
    return torch.clamp(torch.nan_to_num(x, neginf=_NEG), min=_NEG)


def _grid_shape(n_f: int, a: int, p: int, size: int):
    shape = [n_f] + [1] * a
    shape[1 + p] = size
    return shape


def _support(fg: CompiledFG):
    """Unified per-variable support table (host numpy):
    ``(sup_vals f32 [n_var, S], sup_mask f32 [n_var, S])`` with continuous
    vars first (integral points) then discrete vars (domain values);
    S = max support size."""
    P = fg.cont_ipoints.shape[1] if fg.n_cont else 1
    S = max(P, fg.max_v, 1)
    n_var = fg.n_cont + fg.n_disc
    vals = np.zeros((max(n_var, 1), S), np.float32)
    mask = np.zeros((max(n_var, 1), S), np.float32)
    cip = fg.meta.np_global["cont_ipoints"]
    dvals = fg.meta.np_global["disc_vals"]
    dsz = fg.meta.np_global["disc_sizes"]
    for i in range(fg.n_cont):
        vals[i, :P] = cip[i]
        mask[i, :P] = 1.0
    for j in range(fg.n_disc):
        vals[fg.n_cont + j, : dsz[j]] = dvals[j, : dsz[j]]
        mask[fg.n_cont + j, : dsz[j]] = 1.0
    return vals, mask


def _edge_weights(fg: CompiledFG, np_b, gvid):
    """``scale_f / count_v`` per (row, slot): the lifted edge multiplicity."""
    counts = np.concatenate(
        [fg.meta.np_global["cont_counts"], fg.meta.np_global["disc_counts"]]
    ) if (fg.n_cont + fg.n_disc) else np.ones(1)
    return np_b["scale"][:, None] / np.maximum(
        counts[np.clip(gvid, 0, max(len(counts) - 1, 0))], 1.0)


def _build_tables(fg: CompiledFG, sup_vals_np: np.ndarray,
                  sup_mask_np: np.ndarray, S: int):
    """Per-bucket factor tables over the support product grid, on
    ``fg.device``. Returns (tables, aux): the iteration tables and the
    per-slot support tables that re-evaluate log φ at query points."""
    dev = fg.device
    tables: List[_BucketTables] = []
    aux_list: List[_QueryAux] = []
    for b, np_b in zip(fg.buckets, fg.meta.np_buckets):
        a = len(b.pattern)
        n_f = b.n_factors
        slot_vals = []
        gvid = np.zeros((n_f, a), np.int64)
        lat = np.zeros((n_f, a), np.float32)
        ci = di = 0
        disc_vals = np_b["disc_vals"]
        for p, is_cont in enumerate(b.pattern):
            if is_cont:
                v = np.where(
                    np_b["cont_mask"][:, ci, None] > 0,
                    sup_vals_np[np.clip(np_b["cont_idx"][:, ci], 0,
                                        sup_vals_np.shape[0] - 1)],
                    np_b["cont_const"][:, ci, None],
                )
                gvid[:, p] = np_b["cont_idx"][:, ci]
                lat[:, p] = np_b["cont_mask"][:, ci]
                ci += 1
            else:
                # the bucket's value tables are as wide as its widest
                # domain, observed slots' included; a latent slot's values
                # fit in S
                K = min(S, disc_vals.shape[2])
                dv = np.zeros((n_f, S), np.float32)
                dv[:, :K] = disc_vals[:, di, :K]
                const_v = np.take_along_axis(
                    disc_vals[:, di, :],
                    np_b["disc_const"][:, di: di + 1].astype(np.int64), axis=1)
                v = np.where(np_b["disc_mask"][:, di, None] > 0, dv, const_v)
                gvid[:, p] = fg.n_cont + np_b["disc_idx"][:, di]
                lat[:, p] = np_b["disc_mask"][:, di]
                di += 1
            slot_vals.append(v.astype(np.float32))

        # log φ on the product grid by broadcasting
        shape = (n_f,) + (S,) * a
        xc_axes, xdi_axes, xdv_axes = [], [], []
        slot_idx = np.zeros((n_f, a, S), np.int64)
        di = 0
        for p, is_cont in enumerate(b.pattern):
            bshape = _grid_shape(n_f, a, p, S)
            vp = torch.tensor(slot_vals[p], device=dev).reshape(bshape)
            if is_cont:
                xc_axes.append(vp.expand(shape))
            else:
                # observed slots: a fixed value index
                slot_idx[:, p, :] = np.where(
                    np_b["disc_mask"][:, di: di + 1] > 0,
                    np.arange(S)[None, :],
                    np_b["disc_const"][:, di: di + 1],
                )
                xdi_axes.append(torch.tensor(slot_idx[:, p, :], device=dev)
                                .reshape(bshape).expand(shape))
                xdv_axes.append(vp.expand(shape))
                di += 1
        log_phi = clip_neg(b.kernel(grid_params(b.params, a),
                                    *_stack_axes(xc_axes, xdi_axes, xdv_axes,
                                                 shape, dev)))

        # mask invalid support positions of latent slots
        w_edge = _edge_weights(fg, np_b, gvid)
        slot_valid = np.zeros((n_f, a, S), np.float32)
        obs_valid = np.concatenate([np.ones((n_f, 1)), np.zeros((n_f, S - 1))],
                                   axis=1)  # observed slot: position 0 only
        for p in range(a):
            m = np.where(
                lat[:, p: p + 1] > 0,
                sup_mask_np[np.clip(gvid[:, p], 0, sup_mask_np.shape[0] - 1)],
                obs_valid,
            )
            slot_valid[:, p, :] = m
            mt = torch.tensor(m, device=dev).reshape(_grid_shape(n_f, a, p, S))
            log_phi = torch.where(mt > 0, log_phi, _NEG)
        tables.append(_BucketTables(
            log_phi=log_phi,
            gvid=torch.tensor(gvid, device=dev),
            lat=torch.tensor(lat, device=dev),
            w_edge=torch.tensor(w_edge.astype(np.float32), device=dev),
        ))
        aux_list.append(_QueryAux(
            slot_vals=torch.tensor(np.stack(slot_vals, axis=1), device=dev),
            slot_idx=torch.tensor(slot_idx, device=dev),
            slot_valid=torch.tensor(slot_valid, device=dev),
        ))
    return tables, aux_list


def _stack_axes(xc_axes, xdi_axes, xdv_axes, shape, dev):
    """Per-slot grids → the kernel's ``(xc, xdi, xdv)`` (last axis =
    slot)."""
    shape = tuple(shape)
    xc = (torch.stack(xc_axes, -1) if xc_axes
          else torch.zeros(shape + (0,), device=dev))
    xdi = (torch.stack(xdi_axes, -1) if xdi_axes
           else torch.zeros(shape + (0,), dtype=torch.int64, device=dev))
    xdv = (torch.stack(xdv_axes, -1) if xdv_axes
           else torch.zeros(shape + (0,), device=dev))
    return xc, xdi, xdv


def assemble_beliefs(contribs, plan, n_var: int, S: int, device):
    """Σ of the incoming (weighted) messages per variable, ``[n_var, S]``,
    through the edge gather plan (``fg.compile.build_edge_gather``):
    ``contribs`` holds one ``[n_f, a, S]`` tensor per bucket."""
    if not plan.idx:
        return torch.zeros((n_var, S), device=device)
    flats = [c.transpose(0, 1).reshape(-1, S) for c in contribs]
    flat = torch.cat(flats + [torch.zeros((1, S), device=device)], dim=0)
    parts = [torch.sum(flat[idx], dim=1) for idx in plan.idx]
    return torch.cat(parts, dim=0)[plan.pos_of_var]


def _normalize_last(m):
    """Subtract each row's largest finite entry (stability)."""
    return m - torch.amax(torch.where(torch.isfinite(m), m,
                                      torch.full((), -1e9, device=m.device)),
                          dim=-1, keepdim=True)


def _cavity(t: _BucketTables, B, m):
    """var→factor messages of one bucket: belief − this edge's message,
    0 on observed slots, normalized."""
    m_vf = B[t.gvid] - m  # [n_f, a, S]
    m_vf = torch.where(t.lat[..., None] > 0, m_vf, 0.0)
    return _normalize_last(m_vf)


def _beliefs_of(tables, msgs, plan, n_var: int, S: int, device):
    return assemble_beliefs(
        [t.w_edge[..., None] * m * t.lat[..., None]
         for t, m in zip(tables, msgs)], plan, n_var, S, device)


def lbp_step(tables, msgs, plan, n_var: int, damping: float):
    """One synchronous damped LBP iteration → new messages."""
    S = msgs[0].shape[-1] if msgs else 1
    dev = tables[0].log_phi.device if tables else torch.device("cpu")
    B = _beliefs_of(tables, msgs, plan, n_var, S, dev)
    new_msgs = []
    for t, m in zip(tables, msgs):
        a = t.gvid.shape[1]
        m_vf = _cavity(t, B, m)
        # factor→var per slot: add every other slot's m_vf onto the grid,
        # reduce every axis but the slot's
        upd = []
        for p in range(a):
            g = t.log_phi
            for q in range(a):
                if q != p:
                    g = g + m_vf[:, q, :].reshape(
                        _grid_shape(g.shape[0], a, q, g.shape[1 + q]))
            axes = tuple(1 + q for q in range(a) if q != p)
            upd.append(torch.logsumexp(g, dim=axes) if axes else g)
        m_new = clip_neg(_normalize_last(torch.stack(upd, dim=1)))
        new_msgs.append(damping * m + (1.0 - damping) * m_new)
    return tuple(new_msgs)


def _lbp_iterate(tables, msgs, plan, n_var: int, n_iters: int,
                 damping: float):
    for _ in range(n_iters):
        msgs = lbp_step(tables, msgs, plan, n_var, damping)
    S = msgs[0].shape[-1] if msgs else 1
    dev = tables[0].log_phi.device if tables else torch.device("cpu")
    return msgs, _beliefs_of(tables, msgs, plan, n_var, S, dev)


class HybridLBP:
    """Engine facade: ``HybridLBP(fg).run(iters)`` then belief queries.

    Works on grounded or lifted ``CompiledFG`` (one message per cluster
    edge in the lifted case); runs on ``fg.device``.
    """

    def __init__(self, fg: CompiledFG):
        fg.require_whole("HybridLBP")
        self.fg = fg
        self.edge_plan = build_edge_gather(
            fg.meta.np_buckets, [b.pattern for b in fg.buckets],
            fg.n_cont, fg.n_disc, fg.device)
        sup_vals_np, sup_mask_np = _support(fg)
        self.sup_vals_np, self.sup_mask_np = sup_vals_np, sup_mask_np
        self.S = int(sup_vals_np.shape[1])
        self.tables, self.query_aux = _build_tables(
            fg, sup_vals_np, sup_mask_np, self.S)
        self.n_var = max(fg.n_cont + fg.n_disc, 1)
        self.msgs = None  # tuple of [n_f, a, S] per bucket
        self.beliefs_ = None

    @property
    def table_bytes(self) -> int:
        """Device bytes of the factor tables over the support grids."""
        return sum(t.log_phi.numel() * t.log_phi.element_size()
                   for t in self.tables)

    def run(self, n_iters: int = 30, damping: float = 0.2):
        msgs = tuple(
            torch.zeros(t.gvid.shape + (self.S,), device=self.fg.device)
            for t in self.tables)
        self.msgs, beliefs = _lbp_iterate(
            self.tables, msgs, self.edge_plan, self.n_var, n_iters, damping)
        self.beliefs_ = beliefs.cpu().numpy()
        return self

    # --- queries ----------------------------------------------------------
    def _belief_row(self, rv):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        row = i if kind == "c" else self.fg.n_cont + i
        b = self.beliefs_[row]
        mask = self.sup_mask_np[row] > 0
        logb = np.where(mask, b, -np.inf)
        logb = logb - logb.max()
        p = np.exp(logb) * mask
        return p / p.sum(), self.sup_vals_np[row], kind, i

    def disc_marginal(self, rv):
        p, vals, kind, i = self._belief_row(rv)
        if kind != "d":
            raise ValueError(f"{rv} is continuous")
        return p[: self.fg.meta.disc_size(rv)]

    def mean(self, rv) -> float:
        p, vals, kind, _ = self._belief_row(rv)
        return float(np.sum(p * vals))

    def var(self, rv) -> float:
        p, vals, kind, _ = self._belief_row(rv)
        m = np.sum(p * vals)
        return float(np.sum(p * (vals - m) ** 2))

    def map(self, rv):
        p, vals, kind, _ = self._belief_row(rv)
        return float(vals[int(np.argmax(p))]) if kind == "c" else (
            self.fg.meta.disc_values(rv)[
                int(np.argmax(p[: self.fg.meta.disc_size(rv)]))])

    # --- arbitrary-x density queries --------------------------------------
    def _query_logb(self, xs: np.ndarray, row: int):
        """Log unnormalized message product at ``xs`` + grid log-normalizer.

        Both come from the same fresh (undamped, unnormalized) factor→var
        pass off the converged message state, so they share constants.
        """
        if self.msgs is None:
            raise RuntimeError("call run() before density queries")
        S, dev = self.S, self.fg.device
        grid_full = self.sup_vals_np[row]
        gmask = self.sup_mask_np[row] > 0
        Bj = torch.tensor(self.beliefs_, device=dev)

        def query(xq):
            return _lbp_query(self.fg, self.tables, self.query_aux, self.msgs,
                              Bj, row, torch.tensor(xq, dtype=torch.float32,
                                                    device=dev)).cpu().numpy()

        bg = np.where(gmask, query(grid_full), -np.inf)
        bmax = float(bg.max())
        grid = grid_full[gmask]
        logZ = bmax + float(np.log(_trapezoid(np.exp(bg[gmask] - bmax), grid)))
        vals = np.empty(len(xs))
        for s in range(0, len(xs), S):
            blk = xs[s: s + S]
            pad = np.pad(blk, (0, S - len(blk)), mode="edge")
            vals[s: s + len(blk)] = query(pad)[: len(blk)]
        return vals, logZ, bmax

    def belief(self, x, rv):
        """Normalized posterior density (continuous) / pmf (discrete) at
        caller-supplied ``x``: the message product at ``x`` by a fresh
        factor→var pass, not a support-table lookup."""
        kind, i = self.fg.meta.loc(rv)
        if kind == "d":
            pmf = self.disc_marginal(rv)
            xs = np.atleast_1d(x)
            out = np.array(
                [pmf[self.fg.meta.value_index(rv, v)] for v in xs])
            return float(out[0]) if np.ndim(x) == 0 else out
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, logZ, _ = self._query_logb(xs, i)
        out = np.exp(vals - logZ)
        return float(out[0]) if np.ndim(x) == 0 else out

    def probability(self, x, rv):
        """Unnormalized message product Π m(x) at ``x`` (up to one per-run
        constant shared with the belief grid)."""
        kind, i = self.fg.meta.loc(rv)
        if kind == "d":
            return self.belief(x, rv)
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, _, bmax = self._query_logb(xs, i)
        out = np.exp(vals - bmax)
        return float(out[0]) if np.ndim(x) == 0 else out


def _lbp_query(fg: CompiledFG, tables, aux_list, msgs, B, row: int, xq):
    """Fresh factor→var pass for one variable at query points ``xq`` [S].

    Re-evaluates every bucket kernel with each continuous slot substituted
    by ``xq`` (other slots on their support grids), adds the converged
    cavities, reduces, and sums the edge-weighted messages of the edges
    incident to ``row``. Unnormalized and undamped, so a grid call and an
    arbitrary-x call share constants.
    """
    S = xq.shape[0]
    dev = xq.device
    out = torch.zeros(S, device=dev)
    for b, t, aux, m in zip(fg.buckets, tables, aux_list, msgs):
        a, n_f = t.gvid.shape[1], t.gvid.shape[0]
        m_vf = _cavity(t, B, m)
        shape = (n_f,) + (S,) * a
        for p, is_cont_p in enumerate(b.pattern):
            if not is_cont_p:
                continue  # arbitrary-x queries target continuous slots only
            xc_axes, xdi_axes, xdv_axes = [], [], []
            for q, is_cont in enumerate(b.pattern):
                bshape = _grid_shape(n_f, a, q, S)
                if q == p:
                    vq = xq[None, :].expand(n_f, S).reshape(bshape).expand(shape)
                else:
                    vq = aux.slot_vals[:, q, :].reshape(bshape).expand(shape)
                if is_cont:
                    xc_axes.append(vq)
                else:
                    xdi_axes.append(
                        aux.slot_idx[:, q, :].reshape(bshape).expand(shape))
                    xdv_axes.append(vq)
            g = clip_neg(b.kernel(grid_params(b.params, a),
                                  *_stack_axes(xc_axes, xdi_axes, xdv_axes,
                                               shape, dev)))
            for q in range(a):
                if q == p:
                    continue
                bshape = _grid_shape(n_f, a, q, S)
                g = torch.where(aux.slot_valid[:, q, :].reshape(bshape) > 0,
                                g, _NEG)
                g = g + m_vf[:, q, :].reshape(bshape)
            axes = tuple(1 + q for q in range(a) if q != p)
            mq = clip_neg(torch.logsumexp(g, dim=axes) if axes else g)
            sel = ((t.gvid[:, p] == row) & (t.lat[:, p] > 0)).to(mq.dtype)
            out = out + torch.sum((t.w_edge[:, p] * sel)[:, None] * mq, dim=0)
    return out
