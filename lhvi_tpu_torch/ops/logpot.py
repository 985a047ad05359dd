"""Batched leapfrog on (possibly tempered) non-quadratic targets (PyTorch
port of ``lhvi_tpu/ops/logpot.py``), with the fused log-potential kernel
K5 (``csrc/logpot_leapfrog.cu``).

The tempered continuous energy

    E(x) = β·[ x·h − ½ xJx + Σ_buckets Σ_f w_f · log φ_f(slots_f(x)) ]
           + (1−β)·[ −½ Σ_i (x_i − mid_i)² / s_i² ]

and its gradient drive an n-step leapfrog with merged half-kicks. Three
routes compute the same thing:

- ``plan=None``: autograd over ``fg.log_prob_cont_batched``
  (``_torch_logpot_leapfrog``, the reference's ``_jnp_logpot_leapfrog``);
- a :class:`LogpotPlan` on CUDA tensors: ONE launch of K5 per proposal,
  which keeps a tile of chains' positions, momenta and gradients in
  shared memory for the whole trajectory; a warp interprets one factor
  row's traced tape (``ops/logpot_tape.py``) forward and backward for 32
  chains at once (:func:`k5_launch` sets the tile);
- a plan on CPU tensors: the same trajectory with the energy and gradient
  from :func:`tape_energy_grad`, K5's plain twin.

Two plans. :func:`logpot_plan` keeps the reference's eligibility rules
(its TPU VMEM estimate included), so the same models are eligible there,
and returns None where the reference's does. :func:`kernel_plan` is the
plan K5 runs: it is held to K5's own limits (a dense quadratic form, a
planar kernel per bucket, one chain and one warp within a block's shared
memory) and RAISES where K5 cannot run the graph. ``plan="auto"``
resolves to the cached kernel plan on CUDA tensors, so a model never
leaves K5 silently on the card, and to None (autograd) on CPU tensors,
as the reference resolves it off the TPU. A formula the tracer cannot
record makes either plan raise.

The plan's tables are gathers, not the reference's one-hot ``x @ G``
matmuls (a Mosaic workaround): per factor row and continuous slot, the
latent's index (−1 for evidence) and the evidence value. The active rows
are coloured so that no two rows of a colour read the same latent, and
the gradient takes their slot adjoints colour by colour, slot by slot: a
fixed order without atomics, so every run gives the same bits. Padded
factor rows (scale 0) are dropped.
"""

from __future__ import annotations

import weakref
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.ops.leapfrog import _check_f32, eps_tensor
from lhvi_tpu_torch.ops.logpot_tape import (
    Tape,
    param_table,
    tape_forward,
    tape_reverse,
    trace_planar,
)
from lhvi_tpu_torch.utils.metrics import count

_LANE = 128  # the reference's footprint estimate counts 128-lane padding
# K5's shared memory per block (csrc/logpot_leapfrog.cu, kSmemLimit)
K5_SMEM_LIMIT = 227 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _torch_logpot_leapfrog(fg, x, p, xd, inv_mass, eps, beta, base_mid,
                           base_is2, n_steps: int, use_base: bool):
    """The reference's ``_jnp_logpot_leapfrog``: same semantics, gradient
    by autograd over ``fg.log_prob_cont_batched``."""

    def logp(X):
        lp = fg.log_prob_cont_batched(X, xd)
        if use_base:
            d = X - base_mid[None]
            lp = beta * lp - (1.0 - beta) * 0.5 * torch.sum(
                d * d * base_is2[None], dim=-1)
        return lp

    def grad(X):
        with torch.enable_grad():
            Xr = X.detach().requires_grad_(True)
            g = torch.autograd.grad(torch.sum(logp(Xr)), Xr,
                                    allow_unused=True)[0]
        return torch.zeros_like(X) if g is None else g

    with torch.no_grad():
        e0 = logp(x)
    p = p + 0.5 * eps * grad(x)
    for i in range(n_steps):
        x = x + eps * inv_mass[None] * p
        p = p + (0.5 if i == n_steps - 1 else 1.0) * eps * grad(x)
    with torch.no_grad():
        e1 = logp(x)
    return x, p, e0, e1


class _BucketPlan:
    """One xc-dependent bucket in the plan: its tape and its real rows'
    positions in the plan's row space."""

    def __init__(self, pattern, tape: Tape, rows: torch.Tensor):
        self.pattern = pattern
        self.tape = tape
        self.rows = rows  # i64 [R_b] plan rows of this bucket's factors


class LogpotPlan:
    """The fused kernel's tables for one compiled graph, on ``fg.device``.

    Rows: every real factor row of every xc-dependent bucket; the first
    ``n_active`` read at least one latent continuous slot, the others
    only evidence (their energy is constant along a trajectory, so K5
    evaluates them once per proposal). Per row: ``cidx``/``cconst``
    ``[R, ACM]`` (latent index or −1, evidence value), ``prm [R, PM]``
    (parameters in the planar layout) and ``w [R]`` (scale). K5's order:
    ``row_order``, cut into ``segs`` (bucket, first position, count) and
    the segments into colours by ``color_ptr`` (``segments`` holds the
    same for the twin). The tapes: ``tape_pack`` (16-byte nodes) and
    ``bucket_tape`` (first node, length). Discrete slot values are
    gathered per proposal by :meth:`disc_values`.
    """

    def __init__(self, fg, buckets: List[_BucketPlan], tables: dict):
        self.n_cont = fg.n_cont
        self.has_quad = bool(fg.has_quad)
        self.buckets = buckets
        for k, v in tables.items():
            setattr(self, k, v)

    @property
    def n_rows(self) -> int:
        return self.w.shape[0]

    def disc_values(self, xd: torch.Tensor) -> Optional[torch.Tensor]:
        """``[C, R, ADM]`` f32 domain values of every row's discrete slots
        at the state ``xd [C, n_disc]`` (fixed during a continuous move),
        or None when no bucket has a discrete slot."""
        if self.adm == 0:
            return None
        C = xd.shape[0]
        if xd.shape[1]:
            xi = torch.where(self.dlat[None], xd[:, self.dvar],
                             self.dconst[None])
        else:
            xi = self.dconst[None].expand(C, -1)
        vals = torch.gather(self.dtab[None].expand(C, -1, -1), 2,
                            xi[..., None])[..., 0]
        return vals.reshape(C, self.n_rows, self.adm)


def _footprint(fg, idx, block_chains: int) -> Optional[int]:
    """The reference's eligibility gate (``logpot_plan``): the TPU
    kernel's VMEM estimate, or None when a bucket has no planar kernel."""
    n_pad = _round_up(max(fg.n_cont, 1), _LANE)
    total = 4 * (n_pad * n_pad + n_pad) if fg.has_quad else 0
    for i in idx:
        b = fg.buckets[i]
        if b.kernel_planar is None:
            return None
        np_b = fg.meta.np_buckets[i]
        F_pad = _round_up(b.n_factors, _LANE)
        ci = 0
        for is_cont in b.pattern:
            if not is_cont:
                total += 4 * block_chains * F_pad
                continue
            if (np_b["cont_mask"][:, ci] > 0).any():
                total += 2 * 4 * n_pad * F_pad
            ci += 1
        for k in np_b["params"]:
            rows = np.asarray(np_b["params"][k]).reshape(b.n_factors, -1)
            total += 4 * rows.shape[1] * F_pad
        total += 4 * F_pad
        total += 4 * block_chains * F_pad * (4 * max(len(b.pattern), 1))
    return total + 4 * block_chains * n_pad * 4


class K5Launch(NamedTuple):
    """K5's launch geometry (``csrc/logpot_leapfrog.cu``): blocks of
    ``threads`` threads own ``chains`` chains each (a power of two up to
    32); ``stage``/``j_smem``: the plan's tables and J are copied into the
    block's ``smem`` bytes of shared memory."""

    threads: int
    chains: int
    stage: bool
    j_smem: bool
    smem: int


def _k5_smem(plan, threads: int, chains: int, stage: bool,
             j_smem: bool) -> int:
    """K5's shared memory per block (``smem_bytes`` in the kernel): two
    double partials a thread; the staged tables (16-byte tape nodes, then
    the int and float row tables) and J; x, p and g of the block's chains;
    each warp's node values and adjoints ([max_tape][32] each) and its slot
    adjoints ([acm][32])."""
    n, R, acm = plan.n_cont, plan.n_rows, plan.acm
    b = 16 * threads
    if stage:
        b += 16 * plan.tape_pack.shape[0] + 4 * (
            2 * len(plan.buckets) + R + 3 * len(plan.seg_list)
            + plan.n_colors + 2 + 2 * R * acm + R * plan.pm + R)
    if j_smem:
        b += 4 * n * n
    b += 12 * n * chains
    b += (threads // 32) * 128 * (2 * plan.max_tape + acm)
    return b


def k5_launch(plan, C: int) -> K5Launch:
    """The geometry K5 runs a plan at for C chains. Chains per block: the
    smallest power of two covering C, at most 32 (a warp's lanes are then
    32 chains of one row, or 32 / TC rows × TC chains). Warps: enough for
    the largest colour's tasks and for the (variable, chain) passes, at
    most 32, fewer where shared memory runs out; then the tables and J go
    to shared memory where they still fit. At robot_map(100), C = 16,384:
    32 chains, 14 warps; at the 11×11 denoise grid, C = 4,096: 32 chains,
    32 warps. Raises ``NotImplementedError`` where one chain and one warp
    do not fit (``kernel_plan`` raises first)."""
    key = int(C)
    hit = plan.launch_cache.get(key)
    if hit is not None:
        return hit
    n = plan.n_cont
    chains = min(32, 1 << max(0, (key - 1).bit_length()))
    while True:
        rpl = 32 // chains
        tasks = max([sum(-(-k // rpl) for _, _, k in
                         plan.seg_list[plan.color_list[i]:
                                       plan.color_list[i + 1]])
                     for i in range(plan.n_colors)] + [1])
        warps = min(32, max(tasks, -(-(n * chains) // 32)))
        while warps > 1 and _k5_smem(plan, 32 * warps, chains, False,
                                     False) > K5_SMEM_LIMIT:
            warps -= 1
        smem = _k5_smem(plan, 32 * warps, chains, False, False)
        if smem <= K5_SMEM_LIMIT:
            break
        if chains == 1:
            raise NotImplementedError(
                f"K5 needs {smem} bytes of shared memory for one chain and "
                f"one warp; a block has {K5_SMEM_LIMIT}")
        chains //= 2
    threads = 32 * warps
    stage = _k5_smem(plan, threads, chains, True, False) <= K5_SMEM_LIMIT
    j_smem = plan.has_quad and _k5_smem(plan, threads, chains, stage,
                                        True) <= K5_SMEM_LIMIT
    geo = K5Launch(threads, chains, stage, j_smem,
                   _k5_smem(plan, threads, chains, stage, j_smem))
    plan.launch_cache[key] = geo
    return geo


def logpot_plan(fg, max_bytes: int = 8 << 20,
                block_chains: int = 256) -> Optional[LogpotPlan]:
    """The plan under the reference's eligibility rules, or None where the
    reference's is None: no xc-dependent buckets, an ELL-sparse quadratic
    form, a bucket without a planar kernel, or the reference's TPU
    footprint estimate above ``max_bytes``. Raises
    ``NotImplementedError`` when an eligible bucket's planar function
    cannot be traced into a tape. K5 runs :func:`kernel_plan`."""
    idx = fg.cont_bucket_idx
    if not idx or fg.n_cont == 0 or fg.quad_sparse:
        return None
    est = _footprint(fg, idx, block_chains)
    if est is None or est > max_bytes:
        return None
    return _build_plan(fg, idx)


def kernel_plan(fg) -> Optional[LogpotPlan]:
    """The plan K5 runs, held to K5's own limits rather than the
    reference's TPU footprint gate. None only when the graph has no
    continuous latent (nothing moves). Raises ``NotImplementedError``
    where K5 cannot run the graph: an ELL-sparse quadratic form (K5 reads
    a dense J), no factor reading a continuous latent, a bucket without a
    planar kernel or with a formula the tracer cannot record, or one
    chain and one warp past a block's shared memory (``k5_launch``)."""
    if fg.n_cont == 0:
        return None
    if fg.quad_sparse:
        raise NotImplementedError(
            "K5 reads a dense quadratic form; this graph's is ELL-sparse "
            "(more continuous latents than compile_graph's quad_max_n)")
    idx = fg.cont_bucket_idx
    if not idx:
        raise NotImplementedError(
            "K5: no factor outside the quadratic form reads a continuous "
            "latent")
    for i in idx:
        b = fg.buckets[i]
        if b.kernel_planar is None:
            raise NotImplementedError(
                f"K5: bucket {i} (pattern {b.pattern}, {b.n_factors} "
                f"factors) has no planar kernel to trace")
    plan = _build_plan(fg, idx)
    need = _k5_smem(plan, 32, 1, False, False)
    if need > K5_SMEM_LIMIT:
        raise NotImplementedError(
            f"K5 needs {need} bytes of shared memory for one chain and one "
            f"warp ({plan.n_cont} latents, tapes of up to {plan.max_tape} "
            f"nodes, {plan.acm} continuous slots): 512 + 12 n + 128 (2 "
            f"max_tape + acm) must stay within a block's {K5_SMEM_LIMIT}")
    return plan


def _build_plan(fg, idx) -> LogpotPlan:
    """Trace the buckets ``idx`` and lay out the plan's tables."""
    dev = fg.device
    traced = []  # (bucket index, tape, real rows, param table, np bucket)
    for i in idx:
        b = fg.buckets[i]
        np_b = fg.meta.np_buckets[i]
        prm = param_table(np_b["params"], b.n_factors)
        counts = {k: int(np.asarray(v).reshape(b.n_factors, -1).shape[1])
                  for k, v in np_b["params"].items()}
        tape = trace_planar(b.kernel_planar, b.pattern, counts)
        rows = np.flatnonzero(np_b["scale"] > 0)
        traced.append((i, tape, rows, prm, np_b))
    acm = max(1, max(fg.buckets[i].ac for i in idx))
    adm = max(fg.buckets[i].ad for i in idx)
    pm = max(1, max(t[3].shape[1] for t in traced))

    # plan rows: active rows (a latent continuous slot) first, bucket by
    # bucket, then the evidence-only rows
    act, cst = [], []
    for bi, (_, _, rows, _, np_b) in enumerate(traced):
        lat = (np_b["cont_mask"][rows] > 0).any(axis=1)
        act += [(bi, r) for r in rows[lat]]
        cst += [(bi, r) for r in rows[~lat]]
    order = act + cst
    R = len(order)
    row_bucket = np.zeros(R, np.int32)
    cidx = np.full((R, acm), -1, np.int32)
    cconst = np.zeros((R, acm), np.float32)
    prm_all = np.zeros((R, pm), np.float32)
    w = np.zeros(R, np.float32)
    dvar = np.zeros((R, max(adm, 1)), np.int64)
    dlat = np.zeros((R, max(adm, 1)), bool)
    dconst = np.zeros((R, max(adm, 1)), np.int64)
    vb = max([t[4]["disc_vals"].shape[-1] for t in traced] + [1])
    dtab = np.zeros((R, max(adm, 1), vb), np.float32)
    bucket_rows: List[List[int]] = [[] for _ in traced]
    for k, (bi, r) in enumerate(order):
        _, _, _, prm, np_b = traced[bi]
        bucket_rows[bi].append(k)
        row_bucket[k] = bi
        m = np_b["cont_mask"][r] > 0
        ac = m.shape[0]
        cidx[k, :ac] = np.where(m, np_b["cont_idx"][r], -1)
        cconst[k, :ac] = np.where(m, 0.0, np_b["cont_const"][r])
        prm_all[k, : prm.shape[1]] = prm[r]
        w[k] = np_b["scale"][r]
        ad = np_b["disc_idx"].shape[1]
        if ad:
            dl = np_b["disc_mask"][r] > 0
            dvar[k, :ad] = np.where(dl, np_b["disc_idx"][r], 0)
            dlat[k, :ad] = dl
            dconst[k, :ad] = np_b["disc_const"][r]
            kb = np_b["disc_vals"].shape[-1]
            dtab[k, :ad, :kb] = np_b["disc_vals"][r]
    row_order, segs, color_ptr = _colour_rows(cidx, row_bucket, len(act))
    # every bucket's tape, one 16-byte node each: op, a, b, c's f32 bits
    tape_rows, nodes = [], []
    off = 0
    for _, tape, _, _, _ in traced:
        code, a, b_, c = tape.arrays()
        tape_rows.append((off, len(tape)))
        nodes.append(np.stack([code.astype(np.int32), a.astype(np.int32),
                               b_.astype(np.int32),
                               c.astype(np.float32).view(np.int32)], 1))
        off += len(tape)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    tables = dict(
        n_active=len(act), acm=acm, adm=adm, pm=pm,
        bucket_tape=t(np.asarray(tape_rows, np.int32)),
        tape_pack=t(np.concatenate(nodes)),
        max_tape=max(len(tr[1]) for tr in traced),
        cidx=t(cidx), cconst=t(cconst), prm=t(prm_all), w=t(w),
        row_order=t(row_order), segs=t(segs), color_ptr=t(color_ptr),
        n_colors=len(color_ptr) - 2, seg_list=[tuple(map(int, g))
                                               for g in segs],
        color_list=[int(c) for c in color_ptr], launch_cache={},
        dvar=t(dvar.reshape(-1)), dlat=t(dlat.reshape(-1)),
        dconst=t(dconst.reshape(-1)), dtab=t(dtab.reshape(-1, vb)),
    )
    if fg.has_quad:
        npg = fg.meta.np_global
        tables["J"] = t(np.asarray(npg["quad_J"], np.float32))
        tables["h"] = t(np.asarray(npg["quad_h"], np.float32))
    else:
        tables["J"] = tables["h"] = None
    plans = [
        _BucketPlan(fg.buckets[i].pattern, tape,
                    t(np.asarray(bucket_rows[bi], np.int64)))
        for bi, (i, tape, _, _, _) in enumerate(traced)
    ]
    # (bucket, its rows in K5's order, active) per segment, for the twin
    tables["segments"] = [
        (int(b), t(row_order[a:a + k].astype(np.int64)), bool(a < len(act)))
        for b, a, k in segs]
    return LogpotPlan(fg, plans, tables)


def _colour_rows(cidx, row_bucket, n_active: int):
    """K5's row order and segments. Active rows are coloured greedily in
    plan order, so that no two rows of a colour read the same latent, then
    ordered by (colour, bucket); the evidence-only rows follow, bucket by
    bucket. Returns ``row_order`` i32 [R], ``segs`` i32 [S, 3] (bucket,
    first position in row_order, row count) and ``color_ptr`` i32
    [n_colours + 2]: the segments of colour k are ``color_ptr[k] ..
    color_ptr[k + 1]``, the last range the evidence-only rows."""
    R = cidx.shape[0]
    used: dict = {}
    colour = np.zeros(R, np.int64)
    for k in range(n_active):
        vs = [int(v) for v in cidx[k] if v >= 0]
        busy = set().union(*(used.get(v, set()) for v in vs))
        c = 0
        while c in busy:
            c += 1
        colour[k] = c
        for v in vs:
            used.setdefault(v, set()).add(c)
    n_col = int(colour[:n_active].max()) + 1 if n_active else 0
    colour[n_active:] = n_col
    row_order = np.lexsort((np.arange(R), row_bucket, colour)).astype(np.int32)
    segs, color_ptr = [], [0]
    for col in range(n_col + 1):
        rows = row_order[colour[row_order] == col]
        if rows.size:
            first = int(np.flatnonzero(row_order == rows[0])[0])
            cut = np.flatnonzero(np.diff(row_bucket[rows])) + 1
            for a, b in zip(np.r_[0, cut], np.r_[cut, rows.size]):
                segs.append((int(row_bucket[rows[a]]), first + int(a),
                             int(b - a)))
        color_ptr.append(len(segs))
    return (row_order, np.asarray(segs, np.int32).reshape(-1, 3),
            np.asarray(color_ptr, np.int32))


def tape_energy_grad(plan: LogpotPlan, x: torch.Tensor, dv):
    """K5's plain twin: ``(E [C], ∇E [C, n])`` of the untempered model part
    (``x·h − ½xJx + Σ w·log φ``, without ``quad_c``) at ``x [C, n]``, with
    the discrete slots at ``dv = plan.disc_values(xd)``. Segment by segment
    in K5's order (``plan.segments``: colour by colour, then the
    evidence-only rows), the bucket's tape runs forward over ``[C, R_s]``
    tensors and back for the slot adjoints, which are added slot by slot:
    each variable receives its adjoints in the kernel's order (the
    quadratic term, then colour by colour; no two rows of a colour share a
    latent). Energies are summed in double, as the kernel does."""
    C = x.shape[0]
    e = torch.zeros((C,), dtype=torch.float64, device=x.device)
    g = torch.zeros_like(x)
    if plan.has_quad:
        xJ = x @ plan.J
        e = e + torch.sum(x * (plan.h[None] - 0.5 * xJ), -1).double()
        g = g + (plan.h[None] - xJ)
    for b, rows, active in plan.segments:
        bp = plan.buckets[b]
        ci = plan.cidx[rows]  # [R_s, ACM]
        cont = [torch.where(ci[:, s] >= 0, x[:, ci[:, s].clamp(min=0)],
                            plan.cconst[rows, s])
                for s in range(sum(bp.pattern))]
        disc = ([dv[:, rows, d] for d in range(len(bp.pattern)
                                               - sum(bp.pattern))]
                if dv is not None else [])
        vals = tape_forward(bp.tape, cont, disc, plan.prm[rows])
        w = plan.w[rows]
        e = e + torch.sum(vals[-1] * w[None], -1).double()
        if not active:
            continue
        adj = tape_reverse(bp.tape, vals, w[None].expand(C, -1))
        for s in sorted(adj):
            lat = ci[:, s] >= 0
            g.index_add_(1, ci[lat, s].long(), adj[s][:, lat])
    return e, g


def _plan_leapfrog(plan, x, p, dv, inv_mass, eps, beta, base_mid, base_is2,
                   n_steps: int, use_base: bool):
    """The kernel's trajectory in plain PyTorch over :func:`tape_energy_grad`
    (merged half-kicks; energies in double, returned f32)."""

    def e_g(x):
        e, g = tape_energy_grad(plan, x, dv)
        if use_base:
            d = x - base_mid[None]
            e = beta.double() * e - (1.0 - beta.double()) * 0.5 * torch.sum(
                d * d * base_is2[None], -1).double()
            g = beta * g - (1.0 - beta) * d * base_is2[None]
        return e.to(torch.float32), g

    e0, g = e_g(x)
    p = p + 0.5 * eps * g
    e1 = e0
    for i in range(n_steps):
        x = x + eps * inv_mass[None] * p
        e1, g = e_g(x)
        p = p + (0.5 if i == n_steps - 1 else 1.0) * eps * g
    return x, p, e0, e1


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _cuda_logpot_leapfrog(plan, x, p, dv, inv_mass, eps, beta, base_mid,
                          base_is2, n_steps: int, use_base: bool):
    C, n = x.shape
    dev = x.device
    eps, beta = eps_tensor(eps, dev), eps_tensor(beta, dev)
    checks = [("x", x, (C, n)), ("p", p, (C, n)), ("inv_mass", inv_mass, (n,)),
              ("eps", eps, ()), ("beta", beta, ())]
    if use_base:
        checks += [("base_mid", base_mid, (n,)), ("base_inv_s2", base_is2, (n,))]
    if dv is not None:
        checks.append(("disc values", dv, (C, plan.n_rows, plan.adm)))
    for name, t_, shape in checks:
        _check_f32(name, t_, dev, shape)
    geo = k5_launch(plan, C)
    xo, po = torch.empty_like(x), torch.empty_like(p)
    e0 = torch.empty((C,), device=dev)
    e1 = torch.empty((C,), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().lhvi_logpot_leapfrog(
        x.data_ptr(), p.data_ptr(), inv_mass.data_ptr(), eps.data_ptr(),
        beta.data_ptr(), _ptr(plan.J), _ptr(plan.h),
        _ptr(base_mid if use_base else None),
        _ptr(base_is2 if use_base else None),
        plan.tape_pack.data_ptr(), plan.bucket_tape.data_ptr(),
        plan.row_order.data_ptr(), plan.segs.data_ptr(),
        plan.color_ptr.data_ptr(), plan.cidx.data_ptr(),
        plan.cconst.data_ptr(), plan.prm.data_ptr(), plan.w.data_ptr(),
        _ptr(dv), xo.data_ptr(), po.data_ptr(), e0.data_ptr(), e1.data_ptr(),
        C, n, plan.n_rows, plan.tape_pack.shape[0], len(plan.buckets),
        len(plan.seg_list), plan.n_colors, plan.acm, plan.adm, plan.pm,
        plan.max_tape, int(n_steps), geo.threads, geo.chains,
        int(geo.stage), int(geo.j_smem), geo.smem, stream)
    _build.check(code, "logpot_leapfrog")
    count("ops.k5.launches")
    return xo, po, e0, e1


# ``plan="auto"`` resolves through this cache: one kernel plan (one host
# trace, one set of device tables) per compiled graph, keyed weakly on its
# meta.
_PLAN_CACHE: Any = weakref.WeakKeyDictionary()


def logpot_plan_cached(fg) -> Optional[LogpotPlan]:
    """:func:`kernel_plan`, built once per compiled graph (it raises, and
    caches nothing, where K5 cannot run the graph)."""
    if fg.meta is None:
        return kernel_plan(fg)
    try:
        return _PLAN_CACHE[fg.meta]
    except KeyError:
        pass
    plan = kernel_plan(fg)
    _PLAN_CACHE[fg.meta] = plan
    return plan


def _resolve_plan(fg, plan, x):
    """``"auto"`` → the cached kernel plan on CUDA tensors, None
    elsewhere."""
    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(f"plan must be None, 'auto' or a LogpotPlan: "
                             f"{plan!r}")
        return logpot_plan_cached(fg) if x.is_cuda else None
    return plan


def _tempering(fg, dev, beta, base_mid, base_inv_s2):
    """(use_base, β, mid, 1/s²) with the untempered defaults filled in."""
    if beta is None:
        beta = torch.ones((), device=dev)
    if base_mid is None:
        zeros = torch.zeros((fg.n_cont,), device=dev)
        return False, beta, zeros, zeros
    return True, beta, base_mid, base_inv_s2


def _run_plan(route, fg, plan, x, p, xd, inv_mass, eps, n_steps, beta,
              base_mid, base_inv_s2):
    if plan.w.device != x.device:
        raise ValueError(f"the plan's tables are on {plan.w.device}, "
                         f"the state on {x.device}")
    use_base, beta, mid, is2 = _tempering(fg, x.device, beta, base_mid,
                                          base_inv_s2)
    eps, beta = eps_tensor(eps, x.device), eps_tensor(beta, x.device)
    x1, p1, e0, e1 = route(plan, x, p, plan.disc_values(xd), inv_mass, eps,
                           beta, mid, is2, n_steps, use_base)
    if plan.has_quad:  # match log_prob_cont_batched's constant term
        e0 = e0 + beta * fg.quad_c
        e1 = e1 + beta * fg.quad_c
    return x1, p1, e0, e1


def tape_logpot_leapfrog(fg, x, p, xd, inv_mass, eps, n_steps: int,
                         beta=None, base_mid=None, base_inv_s2=None,
                         plan=None):
    """K5's plain twin on any device: :func:`logpot_leapfrog`'s signature
    and results, the energy and gradient from :func:`tape_energy_grad`
    (``plan=None`` builds the graph's cached plan)."""
    plan = logpot_plan_cached(fg) if plan is None else plan
    return _run_plan(_plan_leapfrog, fg, plan, x, p, xd, inv_mass, eps,
                     n_steps, beta, base_mid, base_inv_s2)


def logpot_leapfrog(fg, x, p, xd, inv_mass, eps, n_steps: int,
                    beta=None, base_mid=None, base_inv_s2=None, plan=None):
    """Batched leapfrog on a (possibly tempered) non-quadratic target.

    x, p: [C, n_cont]; xd: [C, n_disc] (held fixed); eps and beta may be
    floats or 0-d tensors (read on the device, no host sync). Returns
    ``(x1, p1, lp0, lp1)`` where lp is the log-density of the tempered
    target at the start and end points, up to an x-independent constant
    (the same constant on every route: ``β·quad_c`` is added to the
    plan's energies, as the reference's ``logpot.py:519-521``).

    ``plan=None`` runs the autograd path; ``plan="auto"`` or a plan runs
    K5 on CUDA tensors (counter ``ops.k5.launches`` counts its launches)
    and its plain twin on CPU tensors. On CUDA tensors ``"auto"`` is
    :func:`kernel_plan`, which raises where K5 cannot run the graph; on
    CPU tensors it is the autograd path.
    """
    plan = _resolve_plan(fg, plan, x)
    if plan is None:
        use_base, beta, mid, is2 = _tempering(fg, x.device, beta, base_mid,
                                              base_inv_s2)
        return _torch_logpot_leapfrog(fg, x, p, xd, inv_mass, eps, beta,
                                      mid, is2, n_steps, use_base)
    if x.is_cuda:
        route = _cuda_logpot_leapfrog
    elif x.device.type == "cpu":
        route = _plan_leapfrog
    else:
        raise NotImplementedError(f"logpot_leapfrog: no route for {x.device}")
    return _run_plan(route, fg, plan, x, p, xd, inv_mass, eps, n_steps,
                     beta, base_mid, base_inv_s2)
