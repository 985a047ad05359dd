"""Vectorized lifted compile: colour refinement on the array IR (the
PyTorch port of ``lhvi_tpu/lift/fast.py``).

``lift.color.compile_lifted`` walks the Python object graph, which caps it
at the scale of object grounding itself. :func:`fast_lift` runs the same
refinement,

    var color    ← hash(var color, multiset of (factor color, slot))
    factor color ← hash(row params/evidence, tuple of slot var colors)

directly on a grounded :class:`CompiledFG`'s host numpy mirrors
(``meta.np_buckets`` / ``meta.np_global``), so it composes with
``relational.fast.fast_compile`` and lifts million-latent models in
seconds: every round is a handful of vectorized hash folds and one
``np.unique``; the multiset aggregation is a wrapping uint64
``np.add.at`` (commutative, order-free). Colours are 64-bit mixed hashes
canonicalized to dense ints each round, so the partition refines
monotonically and the fixpoint test (colour counts stable) is exact. The
arithmetic is the reference's, in numpy ``uint64``, so the partitions are
the reference's.

Output: a lifted ``CompiledFG`` with one representative factor row per
factor orbit (``scale`` = orbit size), variable slots retied to orbit
indices, per-orbit entropy counts, and a meta that delegates addressing
(RV objects or ``FastMeta`` keys) to the grounded one. Quadratic fusion is
not re-applied (``has_quad=False``): retying can alias a factor's slots,
and the bucket path evaluates tied slots correctly.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from lhvi_tpu_torch.fg.compile import (
    CompiledFG,
    FGMeta,
    FactorBucket,
    _BUCKET_TABLES,
    _build_color_plan,
    _build_gibbs_gather,
    _pad_rows,
    _round_up,
    _tensor,
)
from lhvi_tpu_torch.relational.fast import _greedy_color_pairs

_U = np.uint64
_GOLD = _U(0x9E3779B97F4A7C15)


def _mix(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 arrays."""
    h = np.asarray(h, _U).copy()
    h ^= h >> _U(33)
    h *= _U(0xFF51AFD7ED558CCD)
    h ^= h >> _U(33)
    h *= _U(0xC4CEB9FE1A85EC53)
    h ^= h >> _U(33)
    return h


def _fold(h, v) -> np.ndarray:
    """Order-sensitive combine: fold value(s) v into running hash h."""
    return _mix(np.asarray(h, _U) * _GOLD + np.asarray(v, _U) + _U(1))


def _fold_bytes(h: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Fold each row of ``a`` (any dtype/shape [n, ...]) into h [n]."""
    if a.size == 0:
        return h
    flat = np.ascontiguousarray(a.reshape(a.shape[0], -1))
    # reinterpret row bytes as uint64 words (pad the tail to 8 bytes)
    b = flat.view(np.uint8).reshape(flat.shape[0], -1)
    pad = (-b.shape[1]) % 8
    if pad:
        b = np.concatenate(
            [b, np.zeros((b.shape[0], pad), np.uint8)], axis=1
        )
    words = b.view(_U)
    for j in range(words.shape[1]):
        h = _fold(h, words[:, j])
    return h


def refine_ir(fg: CompiledFG, max_rounds: int = 10_000):
    """Color-refine a grounded CompiledFG.

    Returns ``(vcol_c [n_cont], vcol_d [n_disc], fcols)`` — dense orbit
    ids per latent variable (numbered by first occurrence) and, per
    bucket, the dense factor-orbit id of each REAL row (padding rows get
    -1).
    """
    np_bs = fg.meta.np_buckets
    glob = fg.meta.np_global
    n_c, n_d = fg.n_cont, fg.n_disc

    # --- initial var colors: domain identity ---------------------------
    hc = _U(np.full(n_c, 2, _U))
    hc = _fold_bytes(hc, glob["cont_lo"].astype(np.float32))
    hc = _fold_bytes(hc, glob["cont_hi"].astype(np.float32))
    hc = _fold_bytes(hc, glob["cont_ipoints"].astype(np.float32))
    hd = _U(np.full(n_d, 3, _U))
    hd = _fold_bytes(hd, glob["disc_sizes"].astype(np.int32))
    hd = _fold_bytes(hd, glob["disc_vals"].astype(np.float32))
    allv = np.concatenate([hc, hd])
    _, vcol = np.unique(allv, return_inverse=True)

    # --- per-bucket static row data (real rows only) --------------------
    rows_data = []
    for bi, (b, np_b) in enumerate(zip(fg.buckets, np_bs)):
        real = np.nonzero(np_b["scale"] > 0)[0]
        h0 = _fold(np.full(len(real), 17, _U), hash(b.kind) & (2**63 - 1))
        # fold the row scale too: rows with different pre-existing scales
        # (compile_graph(scales=...)) must never share a factor orbit, or
        # `counts * scale[rep]` would misweight the orbit
        h0 = _fold_bytes(h0, np_b["scale"][real].astype(np.float32))
        for k in sorted(np_b["params"]):
            h0 = _fold_bytes(h0, np_b["params"][k][real])
        for k in ("cont_const", "disc_const", "disc_vals", "disc_size",
                  "cont_mask", "disc_mask"):
            h0 = _fold_bytes(h0, np_b[k][real])
        c_idx = np_b["cont_idx"][real]
        c_lat = np_b["cont_mask"][real] > 0
        d_idx = np_b["disc_idx"][real]
        d_lat = np_b["disc_mask"][real] > 0
        rows_data.append((real, h0, c_idx, c_lat, d_idx, d_lat))

    def factor_colors(vcol):
        """Dense factor colors of each real row, keyed on (static row
        data, tuple of slot var colors) — order-sensitive."""
        hs = []
        for real, h0, c_idx, c_lat, d_idx, d_lat in rows_data:
            h = h0
            if vcol.size:
                for j in range(c_idx.shape[1]):
                    slot = np.where(c_lat[:, j], vcol[c_idx[:, j]] + 2, 0)
                    h = _fold(h, slot)
                for j in range(d_idx.shape[1]):
                    slot = np.where(
                        d_lat[:, j], vcol[n_c + d_idx[:, j]] + 2, 0
                    )
                    h = _fold(h, slot)
            hs.append(h)
        sizes = [len(h) for h in hs]
        cat = np.concatenate(hs) if hs else np.zeros(0, _U)
        _, finv = np.unique(cat, return_inverse=True)
        per_bucket = np.split(finv, np.cumsum(sizes)[:-1])
        n = len(np.unique(finv)) if finv.size else 0
        return per_bucket, n

    n_vcol = len(np.unique(vcol))
    n_fcol = -1
    fcol_per_bucket: List[np.ndarray] = []
    for _ in range(max_rounds):
        # factor colors: order-sensitive fold of slot var colors ---------
        fcol_per_bucket, n_fcol_new = factor_colors(vcol)

        # var colors: commutative multiset of (factor color, slot) -------
        acc = np.zeros(n_c + n_d, _U)
        deg = np.zeros(n_c + n_d, np.int64)
        for (real, h0, c_idx, c_lat, d_idx, d_lat), fcol in zip(
            rows_data, fcol_per_bucket
        ):
            for j in range(c_idx.shape[1]):
                m = c_lat[:, j]
                if m.any():
                    sig = _mix(_fold(fcol[m], j))
                    np.add.at(acc, c_idx[m, j], sig)
                    np.add.at(deg, c_idx[m, j], 1)
            for j in range(d_idx.shape[1]):
                m = d_lat[:, j]
                if m.any():
                    sig = _mix(_fold(fcol[m], 1_000_003 + j))
                    np.add.at(acc, n_c + d_idx[m, j], sig)
                    np.add.at(deg, n_c + d_idx[m, j], 1)
        h = _fold(_fold(np.asarray(vcol, _U), acc), deg)
        _, vcol = np.unique(h, return_inverse=True)
        n_vcol_new = len(np.unique(vcol))

        if n_vcol_new == n_vcol and n_fcol_new == n_fcol:
            break
        n_vcol, n_fcol = n_vcol_new, n_fcol_new
    else:
        # truncated refinement (C2F stage): the loop's factor colors were
        # keyed on the PREVIOUS round's var colors. Re-key them on the
        # final var coloring so that every row in a factor orbit has an
        # identical (params, slot-orbit tuple) signature — that makes
        # representative-row × count an EXACT aggregation of the ground
        # tied-parameter ELBO for any truncation depth (without this, a
        # merged orbit's representative can drop a coarser var orbit's
        # factor terms entirely, leaving its entropy unbounded).
        fcol_per_bucket, _ = factor_colors(vcol)

    def first_occurrence_ids(v):
        _, first, inv = np.unique(v, return_index=True, return_inverse=True)
        order = np.argsort(np.argsort(first))
        return order[inv]

    vcol = first_occurrence_ids(vcol)
    out_f = []
    for (real, *_), fcol in zip(rows_data, fcol_per_bucket):
        out_f.append(np.asarray(fcol, np.int64))
    return vcol[:n_c], vcol[n_c:], out_f


class LiftedIRMeta(FGMeta):
    """Delegates addressing (RV objects or FastMeta keys) to the grounded
    meta, then maps ground latent indices to their orbit slots."""

    def __init__(self, ground: FGMeta, cont_orbit: np.ndarray,
                 disc_orbit: np.ndarray):
        super().__init__()
        self.ground = ground
        self._c, self._d = cont_orbit, disc_orbit

    def loc(self, rv):
        kind, i = self.ground.loc(rv)
        if kind == "obs":
            return kind, i
        return kind, int(self._c[i] if kind == "c" else self._d[i])

    def disc_size(self, rv):
        return self.ground.disc_size(rv)

    def disc_values(self, rv):
        return self.ground.disc_values(rv)

    def value_index(self, rv, x):
        return self.ground.value_index(rv, x)

    def obs_value(self, rv):
        return self.ground.obs_value(rv)


def fast_lift(fg: CompiledFG, pad_to: int = 8,
              max_rounds: int = 10_000) -> CompiledFG:
    """Lifted compile of a grounded ``CompiledFG`` (see module doc), on
    the grounded graph's device.

    Works on the output of ``compile_graph`` and ``fast_compile`` alike;
    engines and queries run unchanged on the result (queries on any
    ground RV / key resolve to its orbit slot).
    """
    device = fg.device
    if fg.meta.cont_counts is not None and (
        np.any(fg.meta.cont_counts != 1) or np.any(fg.meta.disc_counts != 1)
    ):
        raise ValueError("fast_lift expects a GROUNDED CompiledFG")
    vcol_c, vcol_d, fcols = refine_ir(fg, max_rounds=max_rounds)
    glob = fg.meta.np_global

    n_cont = int(vcol_c.max() + 1) if vcol_c.size else 0
    n_disc = int(vcol_d.max() + 1) if vcol_d.size else 0
    cont_counts = np.bincount(vcol_c, minlength=n_cont).astype(np.float32)
    disc_counts = np.bincount(vcol_d, minlength=n_disc).astype(np.float32)
    # representative ground var per orbit (orbit members share a domain
    # by construction: initial colors hash the domain tables)
    rep_c = np.zeros(n_cont, np.int64)
    rep_c[vcol_c[::-1]] = np.arange(len(vcol_c))[::-1]
    rep_d = np.zeros(n_disc, np.int64)
    rep_d[vcol_d[::-1]] = np.arange(len(vcol_d))[::-1]

    meta = LiftedIRMeta(fg.meta, vcol_c, vcol_d)
    meta.cont_counts, meta.disc_counts = cont_counts, disc_counts
    meta.orbit_of = None

    buckets: List[FactorBucket] = []
    pair_a: List[np.ndarray] = []
    pair_b: List[np.ndarray] = []
    for b, np_b, fcol in zip(fg.buckets, fg.meta.np_buckets, fcols):
        real = np.nonzero(np_b["scale"] > 0)[0]
        if real.size == 0:
            continue
        uniq, first, inv = np.unique(
            fcol, return_index=True, return_inverse=True
        )
        counts = np.bincount(inv).astype(np.float32)
        rep = real[first]  # one representative ground row per orbit
        n_raw = len(rep)
        n = _round_up(n_raw, pad_to)

        c_mask = np_b["cont_mask"][rep]
        c_idx = (
            np.where(c_mask > 0, vcol_c[np_b["cont_idx"][rep]], 0)
            if vcol_c.size else np.zeros_like(np_b["cont_idx"][rep])
        ).astype(np.int32)
        d_mask = np_b["disc_mask"][rep]
        d_idx = (
            np.where(d_mask > 0, vcol_d[np_b["disc_idx"][rep]], 0)
            if vcol_d.size else np.zeros_like(np_b["disc_idx"][rep])
        ).astype(np.int32)
        ad = d_idx.shape[1]
        # first latent occurrence of each ORBIT within a row (slots of one
        # factor can alias after retying — same dedup compile_graph does
        # under var_overrides)
        d_first = d_mask.copy()
        for j in range(ad):
            for i in range(j):
                dup = (d_mask[:, i] > 0) & (d_mask[:, j] > 0) \
                    & (d_idx[:, i] == d_idx[:, j])
                d_first[dup, j] = 0.0
        for i in range(ad):
            for j in range(i + 1, ad):
                both = (d_mask[:, i] > 0) & (d_mask[:, j] > 0)
                if both.any():
                    pair_a.append(d_idx[both, i].astype(np.int64))
                    pair_b.append(d_idx[both, j].astype(np.int64))

        scale_p = np.concatenate(
            [counts * np_b["scale"][rep],
             np.zeros(n - n_raw, np.float32)]
        )
        pad = lambda a: _pad_rows(a, n)  # noqa: E731
        params = {k: pad(v[rep]) for k, v in np_b["params"].items()}
        new_b = {
            "cont_idx": pad(c_idx),
            "cont_mask": (pad(c_mask) * (scale_p > 0)[:, None]
                          if c_idx.shape[1] else pad(c_mask)),
            "cont_const": pad(np_b["cont_const"][rep]),
            "disc_idx": pad(d_idx),
            "disc_mask": (pad(d_mask) * (scale_p > 0)[:, None]
                          if ad else pad(d_mask)),
            "disc_first": (pad(d_first) * (scale_p > 0)[:, None]
                           if ad else pad(d_first)),
            "disc_const": pad(np_b["disc_const"][rep]),
            "disc_vals": pad(np_b["disc_vals"][rep]),
            "disc_size": pad(np_b["disc_size"][rep]),
            "scale": scale_p,
            "params": params,
        }
        meta.np_buckets.append(new_b)
        buckets.append(
            FactorBucket(
                kind=b.kind,
                pattern=b.pattern,
                cont_lat=b.cont_lat,
                disc_lat=b.disc_lat,
                kernel=b.kernel,
                kernel_planar=b.kernel_planar,
                params={k: _tensor(v, device) for k, v in params.items()},
                **{k: _tensor(new_b[k], device) for k in _BUCKET_TABLES},
            )
        )

    disc_sizes = glob["disc_sizes"][rep_d].astype(np.int32)
    disc_vals = glob["disc_vals"][rep_d].astype(np.float32)
    cont_lo = glob["cont_lo"][rep_c].astype(np.float32)
    cont_hi = glob["cont_hi"][rep_c].astype(np.float32)
    cont_ip = glob["cont_ipoints"][rep_c].astype(np.float32)
    color_of = _greedy_color_pairs(pair_a, pair_b, n_disc)
    n_colors = int(color_of.max() + 1) if n_disc else 1
    gibbs = _build_gibbs_gather(meta.np_buckets, n_disc, device)
    color_plan = _build_color_plan(meta.np_buckets, n_disc, color_of,
                                   disc_sizes, device, disc_vals)
    meta.np_global = {
        "disc_sizes": disc_sizes,
        "disc_vals": disc_vals,
        "color_of": color_of,
        "cont_lo": cont_lo,
        "cont_hi": cont_hi,
        "cont_ipoints": cont_ip,
        "cont_counts": cont_counts,
        "disc_counts": disc_counts,
    }
    return CompiledFG(
        buckets=tuple(buckets),
        n_cont=n_cont,
        n_disc=n_disc,
        max_v=fg.max_v,
        n_colors=n_colors,
        has_quad=False,
        lp_bucket_idx=tuple(range(len(buckets))),
        meta=meta,
        device=device,
        disc_sizes=_tensor(disc_sizes, device),
        disc_vals=_tensor(disc_vals, device),
        color_of=_tensor(color_of, device),
        cont_lo=_tensor(cont_lo, device),
        cont_hi=_tensor(cont_hi, device),
        cont_ipoints=_tensor(cont_ip, device),
        cont_counts=_tensor(cont_counts, device),
        disc_counts=_tensor(disc_counts, device),
        quad_J=torch.zeros((0, 0), device=device),
        quad_h=torch.zeros((0,), device=device),
        quad_c=torch.zeros((), device=device),
        gibbs=gibbs,
        color_plan=color_plan,
    )


def fast_lifting_report(fg: CompiledFG) -> Dict[str, int]:
    """Compression stats of the IR-level refinement (cf. lifting_report)."""
    vcol_c, vcol_d, fcols = refine_ir(fg)
    n_forbits = sum(len(np.unique(f)) for f in fcols)
    return {
        "n_rvs": fg.n_cont + fg.n_disc,
        "n_factors": int(sum(
            (np_b["scale"] > 0).sum() for np_b in fg.meta.np_buckets
        )),
        "n_rv_orbits": (
            int(len(np.unique(vcol_c)) + len(np.unique(vcol_d)))
        ),
        "n_factor_orbits": int(n_forbits),
    }
