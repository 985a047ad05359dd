"""Direct relational → IR compiler: grounding without the object graph
(the PyTorch port of ``lhvi_tpu/relational/fast.py``).

``RelationalGraph.ground()`` + ``compile_graph`` build one Python ``RV``
and ``F`` per grounding, which is fine to ~1e5 groundings and bound by
objects beyond. :func:`fast_compile` grounds a ``RelationalGraph``
straight to the array IR: substitutions are ``np.indices`` products, atom
ids are mixed-radix arithmetic, evidence is array lookups, and each
(template × evidence pattern) becomes one ``FactorBucket`` in a handful
of vectorized numpy ops, with no per-ground Python object anywhere. The
host code is the reference's, so the tables are equal to its tables.

The result is a ``CompiledFG`` interchangeable with the object path's,
except:

- every atom argument must be a declared logical variable, and each
  predicate slot must be bound to one constant sort across templates
  (the fixed signature that makes ids arithmetic);
- no quadratic fusion (``has_quad=False``);
- lifting runs on the compiled IR (``lift/fast.py``).

Queries: there are no RV objects, so results resolve
``(pred_name, (const, ...))`` keys: ``FastMeta.loc`` accepts exactly what
``RelationalGraph.ground()``'s index dict is keyed by.

A constraint is first called with columns (numpy arrays of constants)
and used directly if it returns a boolean array; otherwise that template
alone falls back to a per-combination Python loop.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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
from lhvi_tpu_torch.relational.graph import RelationalGraph


class FastMeta(FGMeta):
    """Key-addressed metadata: ``loc(("pred", (consts...)))`` instead of
    ``loc(rv)`` — ground RVs are never materialized."""

    def __init__(self):
        super().__init__()
        self.pred_info: Dict[str, dict] = {}

    def loc(self, key) -> Tuple[str, int]:
        if not (isinstance(key, tuple) and len(key) == 2):
            raise TypeError(
                "fast_compile graphs are queried by (pred_name, consts) "
                f"keys, got {key!r}"
            )
        name, consts = key
        info = self.pred_info[name]
        flat = 0
        for dmap, stride, c in zip(info["maps"], info["strides"], consts):
            flat += stride * dmap[c]
        if not info["ref"][flat]:
            raise KeyError(f"{key!r} is not referenced by any ground factor")
        if info["obs"][flat]:
            return ("obs", -1)
        return (info["kind"], int(info["lat"][flat]))

    def obs_value(self, key) -> float:
        name, consts = key
        info = self.pred_info[name]
        flat = 0
        for dmap, stride, c in zip(info["maps"], info["strides"], consts):
            flat += stride * dmap[c]
        return float(info["obs_val"][flat])

    def _domain(self, key):
        return self.pred_info[key[0]]["pred"].domain

    def disc_size(self, key) -> int:
        return self._domain(key).size

    def disc_values(self, key):
        return self._domain(key).values

    def value_index(self, key, x) -> int:
        return self._domain(key).value_index(x)


def _template_columns(rg: RelationalGraph, pf, sig):
    """Substitution columns for one template.

    Returns (n_rows, {var: index column}, {var: constants}) after the
    constraint filter; index columns index each var's constants list.
    """
    lv_names: List[str] = []
    for atom in pf.atoms:
        for a in atom.args:
            if a not in rg.lvs:
                raise ValueError(
                    f"fast_compile: atom argument {a!r} is not a declared "
                    "logical variable (constants in atoms are unsupported)"
                )
            if a not in lv_names:
                lv_names.append(a)
    consts = {v: rg.lvs[v] for v in lv_names}
    sizes = [len(consts[v]) for v in lv_names]
    if not lv_names:
        cols = {}
        n = 1
    else:
        grid = np.indices(sizes).reshape(len(sizes), -1)
        cols = {v: grid[i] for i, v in enumerate(lv_names)}
        n = grid.shape[1]
    if pf.constraint is not None:
        carrs = {
            v: np.asarray(consts[v], dtype=object)[cols[v]]
            for v in lv_names
        }
        mask = None
        try:  # vectorized: constraint over COLUMNS of constants
            out = pf.constraint(carrs)
            if isinstance(out, np.ndarray) and out.dtype == bool \
                    and out.shape == (n,):
                mask = out
        except Exception:
            mask = None
        if mask is None:  # per-combo fallback (this template only)
            mask = np.fromiter(
                (
                    bool(pf.constraint(
                        {v: consts[v][cols[v][r]] for v in lv_names}
                    ))
                    for r in range(n)
                ),
                dtype=bool, count=n,
            )
        cols = {v: c[mask] for v, c in cols.items()}
        n = int(mask.sum())
    return n, cols, consts


def fast_compile(rg: RelationalGraph, device="cuda",
                 pad_to: int = 8) -> CompiledFG:
    """Ground ``rg`` directly into a :class:`CompiledFG` on ``device``, the
    card unless the caller names another (see module doc)."""
    device = torch.device(device)
    meta = FastMeta()

    # --- pass 1: fixed signatures + substitution columns per template ----
    sig: Dict[Tuple[str, int], Tuple[str, ...]] = {}
    tcols = []
    for pf in rg.param_fs:
        for atom in pf.atoms:
            for sl, a in enumerate(atom.args):
                key = (atom.pred.name, sl)
                cs = tuple(rg.lvs[a]) if a in rg.lvs else (a,)
                if key in sig and sig[key] != cs:
                    raise ValueError(
                        f"fast_compile: predicate slot {key} bound to "
                        "different constant sorts across templates"
                    )
                sig.setdefault(key, cs)
        tcols.append(_template_columns(rg, pf, sig))

    # --- pass 2: referenced-atom masks per predicate ----------------------
    pred_names = [
        p for p in rg.preds
        if any((p, sl) in sig for sl in range(rg.preds[p].arity))
    ]
    pinfo: Dict[str, dict] = {}
    for name in pred_names:
        pred = rg.preds[name]
        slot_consts = [sig[(name, sl)] for sl in range(pred.arity)]
        sizes = [len(c) for c in slot_consts]
        strides = np.ones(pred.arity, np.int64)
        for sl in range(pred.arity - 2, -1, -1):
            strides[sl] = strides[sl + 1] * sizes[sl + 1]
        total = int(np.prod(sizes)) if sizes else 1
        pinfo[name] = {
            "pred": pred,
            "sizes": sizes,
            "strides": strides,
            "maps": [
                {c: i for i, c in enumerate(cs)} for cs in slot_consts
            ],
            "ref": np.zeros(total, bool),
            "obs": np.zeros(total, bool),
            "obs_val": np.zeros(total, np.float64),
            "obs_vi": np.zeros(total, np.int32),
        }

    def atom_flat_ids(pf_idx, atom):
        """[n_rows] mixed-radix flat atom ids for one atom of template."""
        n, cols, consts = tcols[pf_idx]
        info = pinfo[atom.pred.name]
        flat = np.zeros(n, np.int64)
        for sl, a in enumerate(atom.args):
            # fixed signature: the var's constants == the slot's constants,
            # so the var's index column IS the slot index column
            if tuple(consts[a]) != sig[(atom.pred.name, sl)]:
                raise ValueError(
                    f"fast_compile: variable {a!r} does not match the "
                    f"signature of slot ({atom.pred.name}, {sl})"
                )
            flat += info["strides"][sl] * cols[a]
        return flat

    atom_ids: List[List[np.ndarray]] = []
    for ti, pf in enumerate(rg.param_fs):
        per_atom = []
        for atom in pf.atoms:
            ids = atom_flat_ids(ti, atom)
            pinfo[atom.pred.name]["ref"][ids] = True
            per_atom.append(ids)
        atom_ids.append(per_atom)

    # --- pass 3: evidence (referenced atoms only, like get_rv) -----------
    for (name, consts), v in rg.evidence.items():
        info = pinfo.get(name)
        if info is None:
            continue
        try:
            flat = sum(
                s * m[c]
                for m, s, c in zip(info["maps"], info["strides"], consts)
            )
        except KeyError:
            continue
        if not info["ref"][flat]:
            continue
        info["obs"][flat] = True
        info["obs_val"][flat] = float(v)
        if not info["pred"].domain.continuous:
            info["obs_vi"][flat] = info["pred"].domain.value_index(v)

    # --- pass 4: latent numbering (pred declaration order, id order) -----
    n_cont = n_disc = 0
    for name in pred_names:
        info = pinfo[name]
        latm = info["ref"] & ~info["obs"]
        lat = np.full(latm.shape[0], -1, np.int64)
        k = int(latm.sum())
        if info["pred"].domain.continuous:
            lat[latm] = n_cont + np.arange(k)
            info["kind"] = "c"
            n_cont += k
        else:
            lat[latm] = n_disc + np.arange(k)
            info["kind"] = "d"
            n_disc += k
        info["lat"] = lat
        meta.pred_info[name] = info

    # --- per-variable tables ---------------------------------------------
    disc_doms = [None] * n_disc
    cont_doms = [None] * n_cont
    for name in pred_names:
        info = pinfo[name]
        latm = info["ref"] & ~info["obs"]
        if info["kind"] == "c":
            for i in info["lat"][latm]:
                cont_doms[i] = info["pred"].domain
        else:
            for i in info["lat"][latm]:
                disc_doms[i] = info["pred"].domain

    max_v = max([d.size for d in disc_doms if d is not None] + [1])
    disc_sizes = np.array(
        [d.size if d is not None else 1 for d in disc_doms], np.int32
    ).reshape(n_disc)
    disc_vals = np.zeros((n_disc, max_v), np.float32)
    for i, d in enumerate(disc_doms):
        if d is not None:
            disc_vals[i, : d.size] = d.values
    n_ip = max(
        [len(d.integral_points) for d in cont_doms if d is not None] + [1]
    )
    cont_lo = np.zeros(n_cont, np.float32)
    cont_hi = np.zeros(n_cont, np.float32)
    cont_ip = np.zeros((n_cont, n_ip), np.float32)
    for i, d in enumerate(cont_doms):
        if d is None:
            continue
        cont_lo[i], cont_hi[i] = d.low, d.high
        ip = np.asarray(d.integral_points, np.float32)
        cont_ip[i, : len(ip)] = ip
        if len(ip) < n_ip:
            cont_ip[i, len(ip):] = ip[-1] if len(ip) else 0.0

    # --- buckets: one per (template, evidence pattern) --------------------
    buckets: List[FactorBucket] = []
    disc_pair_a: List[np.ndarray] = []  # conflict edges for greedy coloring
    disc_pair_b: List[np.ndarray] = []
    for ti, pf in enumerate(rg.param_fs):
        n_rows, _, _ = tcols[ti]
        if n_rows == 0:
            continue
        pattern = tuple(a.pred.domain.continuous for a in pf.atoms)
        m = len(pf.atoms)
        ids = atom_ids[ti]  # per atom: [n_rows] flat atom ids
        obs = np.stack(
            [pinfo[a.pred.name]["obs"][ids[j]]
             for j, a in enumerate(pf.atoms)], axis=1,
        )  # [n_rows, m] True = observed
        packed = np.zeros(n_rows, np.int64)
        for j in range(m):
            packed |= obs[:, j].astype(np.int64) << j
        for code in np.unique(packed):
            rows = np.nonzero(packed == code)[0]
            _emit_bucket(
                buckets, meta, pf, pattern, rows, ids, pinfo,
                [bool((int(code) >> j) & 1) for j in range(m)],
                pad_to, disc_pair_a, disc_pair_b, device,
            )

    # --- chromatic coloring from the factor incidence edges ---------------
    color_of = _greedy_color_pairs(disc_pair_a, disc_pair_b, n_disc)
    n_colors = int(color_of.max() + 1) if n_disc else 1

    meta.cont_counts = np.ones(n_cont, np.float32)
    meta.disc_counts = np.ones(n_disc, np.float32)
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
        "cont_counts": meta.cont_counts,
        "disc_counts": meta.disc_counts,
    }
    return CompiledFG(
        buckets=tuple(buckets),
        n_cont=n_cont,
        n_disc=n_disc,
        max_v=max_v,
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
        cont_counts=_tensor(meta.cont_counts, device),
        disc_counts=_tensor(meta.disc_counts, device),
        quad_J=torch.zeros((0, 0), device=device),
        quad_h=torch.zeros((0,), device=device),
        quad_c=torch.zeros((), device=device),
        gibbs=gibbs,
        color_plan=color_plan,
    )


def _emit_bucket(buckets, meta, pf, pattern, rows, ids, pinfo, obs_pat,
                 pad_to, disc_pair_a, disc_pair_b, device):
    """Materialize one (template × evidence-pattern) bucket from columns."""
    n_raw = rows.shape[0]
    n = _round_up(max(n_raw, 1), pad_to)
    ac = sum(pattern)
    ad = len(pattern) - ac

    c_idx = np.zeros((n_raw, ac), np.int32)
    c_mask = np.zeros((n_raw, ac), np.float32)
    c_const = np.zeros((n_raw, ac), np.float32)
    d_idx = np.zeros((n_raw, ad), np.int32)
    d_mask = np.zeros((n_raw, ad), np.float32)
    d_const = np.zeros((n_raw, ad), np.int32)
    d_size = np.ones((n_raw, ad), np.int32)
    b_vmax = max(
        [a.pred.domain.size for a, c in zip(pf.atoms, pattern) if not c]
        + [1]
    )
    d_vals = np.zeros((n_raw, ad, b_vmax), np.float32)

    ci = di = 0
    for j, (atom, is_cont) in enumerate(zip(pf.atoms, pattern)):
        info = pinfo[atom.pred.name]
        aj = ids[j][rows]
        if is_cont:
            if obs_pat[j]:
                c_const[:, ci] = info["obs_val"][aj]
            else:
                c_idx[:, ci] = info["lat"][aj]
                c_mask[:, ci] = 1.0
            ci += 1
        else:
            dom = atom.pred.domain
            d_vals[:, di, : dom.size] = dom.values
            if dom.size < b_vmax:
                d_vals[:, di, dom.size:] = dom.values[-1]
            d_size[:, di] = dom.size
            if obs_pat[j]:
                d_const[:, di] = info["obs_vi"][aj]
            else:
                d_idx[:, di] = info["lat"][aj]
                d_mask[:, di] = 1.0
            di += 1

    # disc_first: first latent occurrence of its variable within a row
    # (latent indices are globally unique, so equality identifies the var)
    d_first = d_mask.copy()
    for j in range(ad):
        for i in range(j):
            dup = (d_mask[:, i] > 0) & (d_mask[:, j] > 0) \
                & (d_idx[:, i] == d_idx[:, j])
            d_first[dup, j] = 0.0
    # conflict edges for the chromatic schedule
    for i in range(ad):
        for j in range(i + 1, ad):
            both = (d_mask[:, i] > 0) & (d_mask[:, j] > 0)
            if both.any():
                disc_pair_a.append(d_idx[both, i].astype(np.int64))
                disc_pair_b.append(d_idx[both, j].astype(np.int64))

    params = {}
    for k, v in pf.potential.param_arrays().items():
        leaf = np.asarray(v)
        if np.issubdtype(leaf.dtype, np.floating):
            leaf = leaf.astype(np.float32)
        params[k] = np.broadcast_to(leaf[None], (n,) + leaf.shape).copy()
    pad = lambda a: _pad_rows(a, n)  # noqa: E731
    scale_p = np.concatenate(
        [np.ones(n_raw, np.float32), np.zeros(n - n_raw, np.float32)]
    )
    latency = tuple(not o for o in obs_pat)
    np_b = {
        "cont_idx": pad(c_idx),
        "cont_mask": (pad(c_mask) * (scale_p > 0)[:, None]
                      if ac else pad(c_mask)),
        "cont_const": pad(c_const),
        "disc_idx": pad(d_idx),
        "disc_mask": (pad(d_mask) * (scale_p > 0)[:, None]
                      if ad else pad(d_mask)),
        "disc_first": (pad(d_first) * (scale_p > 0)[:, None]
                       if ad else pad(d_first)),
        "disc_const": pad(d_const),
        "disc_vals": pad(d_vals),
        "disc_size": pad(d_size),
        "scale": scale_p,
        "params": params,
    }
    meta.np_buckets.append(np_b)
    buckets.append(
        FactorBucket(
            kind=f"{pf.potential.bucket_key()}|{latency}",
            pattern=pattern,
            cont_lat=tuple(
                l for l, c in zip(latency, pattern) if c),
            disc_lat=tuple(
                l for l, c in zip(latency, pattern) if not c),
            kernel=pf.potential.kernel(pattern),
            kernel_planar=pf.potential.kernel_planar(pattern),
            params={k: _tensor(v, device) for k, v in params.items()},
            **{k: _tensor(np_b[k], device) for k in _BUCKET_TABLES},
        )
    )


def _greedy_color_pairs(pair_a: List[np.ndarray], pair_b: List[np.ndarray],
                        n_disc: int) -> np.ndarray:
    """Greedy conflict coloring from edge arrays (CSR, no object graph)."""
    if n_disc == 0:
        return np.zeros(0, np.int32)
    if not pair_a:
        return np.zeros(n_disc, np.int32)
    a = np.concatenate(pair_a)
    b = np.concatenate(pair_b)
    keep = a != b
    src = np.concatenate([a[keep], b[keep]])
    dst = np.concatenate([b[keep], a[keep]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n_disc)
    starts = np.concatenate([[0], np.cumsum(deg)])
    # O(E) stamp-based greedy: ``seen[c] == v`` marks color c used by a
    # neighbor of v (plain Python lists — ~20x faster than per-variable
    # numpy set ops at 1e6 variables)
    dst_l = dst.tolist()
    starts_l = starts.tolist()
    colors = [0] * n_disc
    seen = [-1] * 64
    for v in range(n_disc):
        for k in range(starts_l[v], starts_l[v + 1]):
            u = dst_l[k]
            if u < v:
                c = colors[u]
                if c >= len(seen):
                    seen.extend([-1] * (c + 1 - len(seen)))
                seen[c] = v
        c = 0
        while c < len(seen) and seen[c] == v:
            c += 1
        colors[v] = c
    return np.asarray(colors, np.int32)
