"""Graph-to-tensor factor compiler (PyTorch port of ``lhvi_tpu/fg/compile.py``).

The graph is compiled ONCE on the host into a statically-shaped, bucketed
tensor IR — ``CompiledFG`` — placed on the ``device`` the caller names;
every engine consumes only that IR:

- factors are grouped into **buckets** by (potential bucket key, continuity
  pattern, evidence pattern, tied); one batched kernel evaluates a bucket;
- evidence is baked in as per-slot constants + masks;
- bucket sizes are padded to a multiple of ``pad_to`` with zero-weight rows;
- per-factor ``scale`` carries lifted orbit counts (1.0 when grounded,
  0.0 for padding);
- Gaussian-quadratic buckets are folded into one information form
  ``(J, h, c)``: dense up to ``quad_max_n`` latents, ELL past it, refined
  to banded DIA when the offsets form a small set (``ops/dia.py``);
- a chromatic schedule (greedy conflict coloring of the discrete latents,
  ``color_of``) and two Gibbs plans are precomputed: the scatter-free
  gather plan behind ``disc_logits`` (``GibbsGather``) and the per-color
  tables of the planned sweep (``GibbsColorPlan``).

All host-side table construction is the reference's numpy code, so the
host mirrors (``FGMeta.np_buckets``/``np_global``), the information-form
tables and the Gibbs plans equal the reference's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from lhvi_tpu_torch.fg.graph import Domain, F, Graph, RV
from lhvi_tpu_torch.potentials.library import select_last

_NEG_BIG = -1e30


class FGMeta:
    """Host-side metadata: RV ↔ flat-index maps, plus host numpy mirrors
    (``np_buckets``/``np_global``) of the compiled index tables, so setup
    code never has to read tables back from the device."""

    def __init__(self):
        self.cont_rvs: List[RV] = []
        self.disc_rvs: List[RV] = []
        self.index: Dict[int, Tuple[str, int]] = {}  # id(rv) -> (kind, idx)
        self.graph: Graph = None
        self.cont_counts: np.ndarray = None  # lifted orbit sizes (None=grounded)
        self.disc_counts: np.ndarray = None
        self.orbit_of: Dict[int, Tuple[str, int]] = None  # lifted: id(rv) -> slot
        self.np_buckets: List[Dict[str, np.ndarray]] = []
        self.np_global: Dict[str, np.ndarray] = {}

    def loc(self, rv: RV) -> Tuple[str, int]:
        """('c'|'d'|'obs', flat index) of an RV in the compiled state."""
        return self.index[id(rv)]

    # Engine results resolve domain facts through these hooks, never
    # through ``rv.domain``, so metas that address variables by key (the
    # relational compiler's ``FastMeta``) work with every engine.
    def disc_size(self, rv) -> int:
        return rv.domain.size

    def disc_values(self, rv):
        return rv.domain.values

    def value_index(self, rv, x) -> int:
        return rv.domain.value_index(x)

    def obs_value(self, rv):
        return rv.value


@dataclasses.dataclass(frozen=True, eq=False)
class FactorBucket:
    """One potential-type bucket: ``n_f`` same-kernel factors, batched.

    Index tensors are int64 (torch's indexing type); the host mirrors in
    ``FGMeta.np_buckets`` keep the reference's int32."""

    kind: str
    pattern: Tuple[bool, ...]
    # per-slot latency, uniform over the bucket (the evidence pattern is
    # part of the bucket key): one bool per continuous / discrete slot,
    # True = latent; VI's quadrature grid is built from them
    cont_lat: Tuple[bool, ...]
    disc_lat: Tuple[bool, ...]
    kernel: Callable
    params: Dict[str, torch.Tensor]  # leaves [n_f, ...]
    cont_idx: torch.Tensor  # i64 [n_f, ac] into x_c (0 where not latent)
    cont_mask: torch.Tensor  # f32 [n_f, ac] 1=latent
    cont_const: torch.Tensor  # f32 [n_f, ac] evidence values
    disc_idx: torch.Tensor  # i64 [n_f, ad] into x_d
    disc_mask: torch.Tensor  # f32 [n_f, ad]
    disc_first: torch.Tensor  # f32 [n_f, ad] 1 = first latent occurrence
    disc_const: torch.Tensor  # i64 [n_f, ad] evidence value-indices
    disc_vals: torch.Tensor  # f32 [n_f, ad, Vmax] slot index->value tables
    disc_size: torch.Tensor  # i64 [n_f, ad] slot domain sizes
    scale: torch.Tensor  # f32 [n_f] orbit count (0 = padding)
    # optional factor-minor kernel (Potential.kernel_planar), traced by
    # the fused log-potential kernel K5 (ops/logpot.py)
    kernel_planar: Any = None

    @property
    def n_factors(self) -> int:
        return self.scale.shape[0]

    @property
    def ac(self) -> int:
        return self.cont_idx.shape[1]

    @property
    def ad(self) -> int:
        return self.disc_idx.shape[1]

    def gather_args_batched(self, xc: torch.Tensor, xd: torch.Tensor):
        """State ``[C, n_cont]/[C, n_disc]`` →
        ``(params [1, n_f, …], xcs [C, n_f, ac], xdi, xdv [C, n_f, ad])``."""
        C = xc.shape[0]
        if xc.shape[1]:
            xcs = torch.where(self.cont_mask[None] > 0, xc[:, self.cont_idx],
                              self.cont_const[None])
        else:
            xcs = self.cont_const[None].expand((C,) + self.cont_const.shape)
        if xd.shape[1]:
            xdi = torch.where(self.disc_mask[None] > 0, xd[:, self.disc_idx],
                              self.disc_const[None])
        else:
            xdi = self.disc_const[None].expand((C,) + self.disc_const.shape)
        if self.ad:
            xdv = select_last(self.disc_vals[None], xdi)
        else:
            xdv = xdi.to(torch.float32)
        params = {k: v[None] for k, v in self.params.items()}
        return params, xcs, xdi, xdv

    def slot_values(self, xdi: torch.Tensor) -> torch.Tensor:
        """Slot value-indices ``[C, n_f, *extra, ad]`` → domain values
        (out-of-range candidate indices give 0, as the reference)."""
        if self.ad == 0:
            return xdi.to(torch.float32)
        n_extra = xdi.dim() - 3  # axes between the factor and slot axes
        vals = self.disc_vals.reshape(
            (1, self.disc_vals.shape[0]) + (1,) * n_extra
            + self.disc_vals.shape[1:])
        return select_last(vals, xdi)


def _expand_params(params: Dict[str, torch.Tensor], n_axes: int):
    """Insert ``n_axes`` singleton axes after the factor axis (axis 1) of
    every ``[1, n_f, …]`` leaf."""
    return {k: v.reshape(v.shape[:2] + (1,) * n_axes + v.shape[2:])
            for k, v in params.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class GibbsGather:
    """Compile-time gather plan for the discrete full-conditional logits:
    every (bucket, slot, factor) contribution gets a static flat row id;
    variables are grouped by incidence degree with per-group index tables
    into the flat contribution array (row ``F_tot`` = zero padding); a
    static permutation maps group-concatenated results back to variable
    order."""

    degrees: Tuple[int, ...]
    idx: Tuple[torch.Tensor, ...]  # per group i64 [m_g, d_g] into flat rows
    pos_of_var: torch.Tensor  # i64 [n_disc] var -> row in concat(groups)


@dataclasses.dataclass(frozen=True, eq=False)
class GibbsColorGroup:
    """One group of a ``GibbsColorPlan``: colors of similar cost, padded to
    uniform shapes. Per color the tables hold exactly the factor rows
    adjacent to that color's variables, so a full chromatic sweep costs
    O(Σ_v deg(v)) kernel-row evaluations.

    ``bucket_tabs[i]`` is ``None`` when bucket ``i`` has no rows in this
    group; otherwise a dict of tensors with leading dims ``[nc, R]``:
    pre-gathered slot tables, ``sub`` (slots referencing the target
    variable, substituted jointly by the candidate value), ``disc_cval``
    (domain values of observed slots' indices), ``sub_vals`` (``[nc, R,
    Vmax]`` candidate domain values of the target), ``w`` (factor scale;
    0 = padding), ``vidx`` (``[nc, M, D]`` per-var gather into the color's
    row block; index R = zero row) and ``params``. ``disc_cval`` and
    ``sub_vals`` are ``None`` where every slot's values are its indices.
    """

    n_colors: int
    n_vars: int  # M = padded class size
    vars_: torch.Tensor  # i64 [nc, M] global discrete var ids (pad = n_disc)
    sizes: torch.Tensor  # i64 [nc, M] domain sizes (pad = 1)
    vals_: Any  # f32 [nc, M, Vmax] index->value (None if values_are_indices)
    bucket_tabs: Tuple


@dataclasses.dataclass(frozen=True, eq=False)
class GibbsColorPlan:
    groups: Tuple[GibbsColorGroup, ...]
    # every latent discrete domain's values are exactly 0..K-1: the sweep
    # derives slot values from indices and carries no value state
    values_are_indices: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledFG:
    """Compiled factor graph: the tensor IR the engines consume.

    Buckets whose log-potentials are quadratic in all-continuous arguments
    are folded into the information form ``(quad_J, quad_h, quad_c)``;
    ``log_prob`` evaluates the form and skips those buckets
    (``lp_bucket_idx`` lists the survivors). ``buckets`` always holds
    EVERY factor.

    Sparse (ELL) form, set when ``n_cont > quad_max_n``:
    ``J @ x = diag·x + Σ_k w[:,k]·x[col[:,k]]``; ``quad_J`` stays ``[0, 0]``.
    Banded (DIA) refinement: ``quad_dia_offsets`` is a static tuple,
    ``quad_dia_w`` f32 ``[K, n_emb]`` in declaration-order embedded
    coordinates, ``quad_dia_pos`` (i64 ``[n_cont]``, or None for the
    identity) embeds the latent state and ``quad_dia_inv`` (i64
    ``[n_emb]``, sentinel ``n_cont`` at gap lanes) is its inverse.
    """

    buckets: Tuple[FactorBucket, ...]
    n_cont: int
    n_disc: int
    max_v: int
    has_quad: bool
    lp_bucket_idx: Tuple[int, ...]
    meta: Any  # FGMeta (None when built from tables, utils/convert.py)
    device: torch.device
    disc_sizes: torch.Tensor  # i64 [n_disc]
    disc_vals: torch.Tensor  # f32 [n_disc, Vmax]
    cont_lo: torch.Tensor  # f32 [n_cont]
    cont_hi: torch.Tensor
    cont_ipoints: torch.Tensor  # f32 [n_cont, P]
    cont_counts: torch.Tensor  # f32 [n_cont]
    disc_counts: torch.Tensor  # f32 [n_disc]
    quad_J: torch.Tensor  # f32 [n_cont, n_cont] (or [0, 0])
    quad_h: torch.Tensor  # f32 [n_cont]
    quad_c: torch.Tensor  # f32 scalar
    gibbs: Any = None  # GibbsGather (None when built from tables)
    color_plan: Any = None  # GibbsColorPlan | None
    n_colors: int = 1
    color_of: Any = None  # i64 [n_disc] chromatic-Gibbs color per latent
    quad_diag: Any = None  # f32 [n_cont]
    quad_ell_col: Any = None  # i64 [n_cont, D]
    quad_ell_w: Any = None  # f32 [n_cont, D]
    quad_sparse: bool = False
    quad_dia_offsets: Any = None
    quad_dia_w: Any = None
    quad_dia_pos: Any = None
    quad_dia_inv: Any = None
    # the collapsed orbit-flip move's plan (engines/modeswap.py): built on
    # demand by ``modeswap.plan_for`` and attached with
    # ``dataclasses.replace`` (ModeSwapPlan | None)
    mode_swap_plan: Any = None
    # VI's per-bucket quadrature plans, keyed by n_quad: built on the first
    # ELBO and kept on the device (engines/vi.py::_vi_plans)
    vi_plans: Dict[int, Any] = dataclasses.field(default_factory=dict,
                                                 repr=False)
    # the parallel.ChainShard whose rank's rows every bucket holds
    # (parallel.shard_fg_factors); None: the whole graph
    factor_shard: Any = None

    def require_whole(self, who: str) -> None:
        """Raise where ``who`` is given one rank's factor rows: only VI and
        ``log_prob`` sum the bucket terms over the ranks."""
        if self.factor_shard is not None:
            raise ValueError(
                f"{who} needs the whole graph, and this one holds one "
                "rank's factor rows (parallel.shard_fg_factors); shard the "
                "chains (shard=) instead")

    @property
    def cont_pure_quad(self) -> bool:
        """True if the continuous energy is ENTIRELY the fused quadratic
        form (every surviving bucket ignores xc) — the fused-leapfrog
        fast path."""
        return self.has_quad and all(
            self.buckets[i].ac == 0 for i in self.lp_bucket_idx
        )

    def quad_matvec_batched(self, xc: torch.Tensor) -> torch.Tensor:
        """``J @ x`` rows for a batch in the ELL form: [C, n] → [C, n]."""
        from lhvi_tpu_torch.ops.leapfrog import ell_matvec

        return ell_matvec(xc, self.quad_diag, self.quad_ell_col,
                          self.quad_ell_w)

    def quad_log_prob_batched(self, xc: torch.Tensor) -> torch.Tensor:
        """Batched continuous energy of the fused form: [C, n] → [C]."""
        if self.quad_sparse:
            Jx = self.quad_matvec_batched(xc)
            return self.quad_c + xc @ self.quad_h - 0.5 * torch.sum(
                xc * Jx, dim=-1)
        return (self.quad_c + xc @ self.quad_h
                - 0.5 * torch.sum((xc @ self.quad_J) * xc, dim=-1))

    def log_prob(self, xc: torch.Tensor, xd: torch.Tensor) -> torch.Tensor:
        """Unnormalized log p(x) = Σ_f scale_f · log φ_f of one state."""
        return self.log_prob_batched(xc[None], xd[None])[0]

    @property
    def cont_bucket_idx(self) -> Tuple[int, ...]:
        """Surviving buckets whose kernels actually read ``xc``."""
        return tuple(i for i in self.lp_bucket_idx if self.buckets[i].ac > 0)

    @property
    def disc_bucket_idx(self) -> Tuple[int, ...]:
        """Surviving buckets whose kernels actually read ``xd``: the
        candidates of the mode-swap plan's direct term (fused and
        continuous-only buckets are constant in ``xd`` and cancel in its
        Metropolis ratios)."""
        return tuple(i for i in self.lp_bucket_idx if self.buckets[i].ad > 0)

    def _bucket_logp_batched(self, i: int, xc, xd) -> torch.Tensor:
        b = self.buckets[i]
        params, xcs, xdi, xdv = b.gather_args_batched(xc, xd)
        lp = b.kernel(params, xcs, xdi, xdv)  # [C, n_f]
        return torch.sum(b.scale[None] * lp, dim=-1)

    def _sum_buckets(self, idx, xc, xd) -> torch.Tensor:
        """The fused form plus the buckets ``idx`` (one running sum, in
        the reference's order); on a factor-sharded graph the bucket terms
        are summed over the ranks (``parallel/mesh.py::sum_over_shards``:
        the whole graph's value on every rank)."""
        sh = self.factor_shard
        zero = torch.zeros((xc.shape[0],), dtype=torch.float32,
                           device=xc.device)
        quad = self.quad_log_prob_batched(xc) if self.has_quad else zero
        total = zero + quad if sh is None else zero
        for i in idx:
            total = total + self._bucket_logp_batched(i, xc, xd)
        if sh is None:
            return total
        from lhvi_tpu_torch.parallel.mesh import sum_over_shards

        return sum_over_shards(quad, total, sh)

    def log_prob_batched(self, xc: torch.Tensor,
                         xd: torch.Tensor) -> torch.Tensor:
        """``[C]`` log p for a batch of states: the fused form plus one
        gather/kernel pass per surviving bucket."""
        return self._sum_buckets(self.lp_bucket_idx, xc, xd)

    def log_prob_cont_batched(self, xc: torch.Tensor,
                              xd: torch.Tensor) -> torch.Tensor:
        """``[C]`` continuous-state-dependent part of ``log_prob``: the fused
        form plus only the buckets that read ``xc`` (differs from
        :meth:`log_prob_batched` by a term constant in ``xc``)."""
        return self._sum_buckets(self.cont_bucket_idx, xc, xd)

    def disc_logits(self, xc: torch.Tensor, xd: torch.Tensor) -> torch.Tensor:
        """Per-variable full-conditional logits of the discrete latents.

        ``xc [C, n_cont]``, ``xd [C, n_disc]`` → f32 ``[C, n_disc, max_v]``
        (one state without the leading axis gives ``[n_disc, max_v]``):
        for each latent d and candidate value v, Σ over factors adjacent
        to d of ``scale · log φ`` with d set to v (other slots at the
        current state); invalid candidates carry ``-1e30``. Slots sharing
        d's variable are set jointly and only the first occurrence
        contributes (``disc_first``), so a factor naming d twice yields
        ``log φ(v, …, v)`` once. Assembled scatter-free through the
        ``GibbsGather`` plan.
        """
        if xc.dim() == 1:
            return self.disc_logits(xc[None], xd[None])[0]
        self.require_whole("disc_logits")
        C, V = xc.shape[0], self.max_v
        dev = xc.device
        if self.n_disc == 0:
            return torch.zeros((C, 0, V), device=dev)
        cand = torch.arange(V, device=dev)
        rows = []
        for b in self.buckets:
            if b.ad == 0:
                continue
            params, xcs, xdi, _ = b.gather_args_batched(xc, xd)
            params = _expand_params(params, 1)
            xcs_b = xcs[:, :, None, :]
            xdi_b = xdi[:, :, None, :].expand(C, b.n_factors, V, b.ad)
            lat = b.disc_mask > 0
            for p in range(b.ad):
                same = ((b.disc_idx == b.disc_idx[:, p:p + 1]) & lat
                        & lat[:, p:p + 1])
                xdi_p = torch.where(same[None, :, None, :],
                                    cand[None, None, :, None], xdi_b)
                lp = b.kernel(params, xcs_b, xdi_p, b.slot_values(xdi_p))
                w = b.scale * b.disc_mask[:, p] * b.disc_first[:, p]
                rows.append(torch.nan_to_num(lp, neginf=_NEG_BIG)
                            * w[None, :, None])
        if not rows:
            return torch.full((C, self.n_disc, V), _NEG_BIG, device=dev)
        flat = torch.cat(rows + [torch.zeros((C, 1, V), device=dev)], dim=1)
        parts = [torch.sum(flat[:, idx_g], dim=2) for idx_g in self.gibbs.idx]
        logits = torch.cat(parts, dim=1)[:, self.gibbs.pos_of_var]
        valid = cand[None, :] < self.disc_sizes[:, None]
        return torch.where(valid[None], logits,
                           torch.full((), _NEG_BIG, device=dev))

    def init_state_batched(self, gen: torch.Generator, n: int,
                           jitter: float = 0.1):
        """[n, …] initial states: continuous at domain midpoint + jitter,
        discrete uniform-random valid indices (two bulk draws from
        ``gen``, which must live on ``self.device``)."""
        mid = 0.5 * (self.cont_lo + self.cont_hi)
        span = torch.clamp(self.cont_hi - self.cont_lo, max=4.0)
        z = torch.randn((n, self.n_cont), generator=gen, device=self.device)
        xc = mid[None] + jitter * span[None] * z
        u = torch.rand((n, self.n_disc), generator=gen, device=self.device)
        xd = torch.floor(u * self.disc_sizes[None]).to(torch.int64)
        return xc, xd


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to n rows by repeating row 0 (keeps kernels finite)."""
    if a.shape[0] == n:
        return a
    reps = np.repeat(a[:1], n - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# a bucket's index and evidence tables, as ``FactorBucket`` fields and as
# keys of its host mirror in ``FGMeta.np_buckets``
_BUCKET_TABLES = ("cont_idx", "cont_mask", "cont_const", "disc_idx",
                  "disc_mask", "disc_first", "disc_const", "disc_vals",
                  "disc_size", "scale")


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """Host numpy → device tensor (a copy); integer tables become int64."""
    a = np.asarray(a)
    if dtype is None and np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    return torch.tensor(a, dtype=dtype, device=device)


def compile_graph(
    g: Graph,
    device="cuda",
    pad_to: int = 8,
    scales: Dict[int, float] = None,
    var_overrides: Dict[int, Tuple[str, int]] = None,
    n_cont_override: int = None,
    n_disc_override: int = None,
    cont_counts: np.ndarray = None,
    disc_counts: np.ndarray = None,
    fuse_quadratic: bool = True,
    quad_max_n: int = 4096,
    ell_max_deg: int = 128,
) -> CompiledFG:
    """Compile a host ``Graph`` into the tensor IR on ``device`` (the
    card unless the caller names another).

    ``scales``/``var_overrides``/``n_*_override`` are the lifting hooks: one
    representative factor per orbit with ``scale = |orbit|`` and orbit-tied
    variable slots.
    """
    device = torch.device(device)
    g.init_nb()
    meta = FGMeta()
    meta.graph = g

    # --- assign state indices -------------------------------------------
    for rv in g.rvs:
        if var_overrides is not None and id(rv) in var_overrides:
            meta.index[id(rv)] = var_overrides[id(rv)]
            continue
        if rv.observed:
            meta.index[id(rv)] = ("obs", -1)
        elif rv.domain.continuous:
            meta.index[id(rv)] = ("c", len(meta.cont_rvs))
            meta.cont_rvs.append(rv)
        else:
            meta.index[id(rv)] = ("d", len(meta.disc_rvs))
            meta.disc_rvs.append(rv)

    n_cont = n_cont_override if n_cont_override is not None else len(meta.cont_rvs)
    n_disc = n_disc_override if n_disc_override is not None else len(meta.disc_rvs)

    # --- per-variable tables (first writer of each slot wins) -----------
    disc_dom: List[Domain] = [None] * n_disc
    cont_dom: List[Domain] = [None] * n_cont
    for rv in g.rvs:
        kind, i = meta.index[id(rv)]
        if kind == "d" and disc_dom[i] is None:
            disc_dom[i] = rv.domain
        elif kind == "c" and cont_dom[i] is None:
            cont_dom[i] = rv.domain

    max_v = max([d.size for d in disc_dom if d is not None] + [1])
    disc_sizes = np.array(
        [d.size if d is not None else 1 for d in disc_dom], np.int32
    ).reshape(n_disc)
    disc_vals = np.zeros((n_disc, max_v), np.float32)
    for i, d in enumerate(disc_dom):
        if d is not None:
            disc_vals[i, : d.size] = d.values

    n_ip = max([len(d.integral_points) for d in cont_dom if d is not None] + [1])
    cont_lo = np.zeros(n_cont, np.float32)
    cont_hi = np.zeros(n_cont, np.float32)
    cont_ip = np.zeros((n_cont, n_ip), np.float32)
    for i, d in enumerate(cont_dom):
        if d is None:
            continue
        cont_lo[i], cont_hi[i] = d.low, d.high
        ip = np.asarray(d.integral_points, np.float32)
        cont_ip[i, : len(ip)] = ip
        if len(ip) < n_ip:  # pad with last site (harmless duplicates)
            cont_ip[i, len(ip):] = ip[-1] if len(ip) else 0.0

    # --- bucket the factors ---------------------------------------------
    buckets_raw: Dict[Any, List[F]] = {}
    for f in g.factors:
        for rv in f.nb:
            if id(rv) not in meta.index:
                raise ValueError(
                    f"factor {f} references {rv} which is not in Graph.rvs"
                )
        pattern = tuple(rv.domain.continuous for rv in f.nb)
        latency = tuple(meta.index[id(rv)][0] != "obs" for rv in f.nb)
        # tied = some latent continuous state index appears in >1 slot;
        # quadratic fusion would fold the cross coupling onto the
        # diagonal, so tied factors stay on the unfused bucket path
        c_slots = [
            meta.index[id(rv)][1]
            for rv in f.nb
            if rv.domain.continuous and meta.index[id(rv)][0] == "c"
        ]
        cont_tied = len(c_slots) != len(set(c_slots))
        key = (f.potential.bucket_key(), pattern, latency, cont_tied)
        buckets_raw.setdefault(key, []).append(f)

    # --- quadratic fusion decision per bucket ---------------------------
    from lhvi_tpu_torch.fg.quad import (
        QUADRATIC_TYPES,
        accumulate_information_ell,
        accumulate_information_form,
    )

    do_fuse = fuse_quadratic and n_cont > 0
    fused_flags: List[bool] = []
    fused_factors: List[F] = []

    buckets: List[FactorBucket] = []
    for (bkey, pattern, latency, cont_tied), fs in buckets_raw.items():
        fusible = (
            do_fuse
            and isinstance(fs[0].potential, QUADRATIC_TYPES)
            and all(pattern)
            and not cont_tied
        )
        fused_flags.append(fusible)
        if fusible:
            fused_factors.extend(fs)
        ac = sum(pattern)
        ad = len(pattern) - ac
        n_raw = len(fs)
        n = _round_up(max(n_raw, 1), pad_to)

        p_stack: Dict[str, List[np.ndarray]] = {}
        c_idx = np.zeros((n_raw, ac), np.int32)
        c_mask = np.zeros((n_raw, ac), np.float32)
        c_const = np.zeros((n_raw, ac), np.float32)
        d_idx = np.zeros((n_raw, ad), np.int32)
        d_mask = np.zeros((n_raw, ad), np.float32)
        d_first = np.zeros((n_raw, ad), np.float32)
        d_const = np.zeros((n_raw, ad), np.int32)
        # value tables sized to THIS bucket's slot domains (an observed
        # discrete slot may have a larger domain than any latent)
        b_vmax = max(
            [rv.domain.size for f in fs for rv in f.nb
             if not rv.domain.continuous] + [1]
        )
        d_vals = np.zeros((n_raw, ad, b_vmax), np.float32)
        d_size = np.ones((n_raw, ad), np.int32)
        scale = np.ones(n_raw, np.float32)

        for r, f in enumerate(fs):
            if scales is not None:
                scale[r] = scales.get(id(f), 1.0)
            for k, v in f.potential.param_arrays().items():
                p_stack.setdefault(k, []).append(np.asarray(v, dtype=None))
            ci = di = 0
            seen_d: set = set()
            for rv, is_cont in zip(f.nb, pattern):
                kind, idx = meta.index[id(rv)]
                if is_cont:
                    if kind == "c":
                        c_idx[r, ci], c_mask[r, ci] = idx, 1.0
                    else:  # observed
                        c_const[r, ci] = float(rv.value)
                    ci += 1
                else:
                    dom = rv.domain
                    d_vals[r, di, : dom.size] = dom.values
                    if dom.size < b_vmax:
                        d_vals[r, di, dom.size:] = dom.values[-1]
                    d_size[r, di] = dom.size
                    if kind == "d":
                        d_idx[r, di], d_mask[r, di] = idx, 1.0
                        if idx not in seen_d:
                            d_first[r, di] = 1.0
                            seen_d.add(idx)
                    else:
                        d_const[r, di] = dom.value_index(rv.value)
                    di += 1

        params = {}
        for k, v in p_stack.items():
            stacked = np.stack(v)
            if np.issubdtype(stacked.dtype, np.floating):
                stacked = stacked.astype(np.float32)
            params[k] = _pad_rows(stacked, n)
        pad = lambda a: _pad_rows(a, n)  # noqa: E731
        scale_p = np.concatenate([scale, np.zeros(n - n_raw, np.float32)])
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
                kind=str(bkey),
                pattern=pattern,
                cont_lat=tuple(l for l, c in zip(latency, pattern) if c),
                disc_lat=tuple(l for l, c in zip(latency, pattern) if not c),
                kernel=fs[0].potential.kernel(pattern),
                kernel_planar=fs[0].potential.kernel_planar(pattern),
                params={k: _tensor(v, device) for k, v in params.items()},
                **{k: _tensor(np_b[k], device) for k in _BUCKET_TABLES},
            )
        )

    # --- chromatic Gibbs schedule ---------------------------------------
    color_of = _greedy_color(g, meta, n_disc).astype(np.int32)
    n_colors = int(color_of.max() + 1) if n_disc else 1

    if cont_counts is None:
        cont_counts = np.ones(n_cont, np.float32)
    if disc_counts is None:
        disc_counts = np.ones(n_disc, np.float32)
    meta.cont_counts, meta.disc_counts = cont_counts, disc_counts

    # --- fold fused buckets into the information form -------------------
    has_quad = bool(fused_factors)
    quad_sparse = False
    quad_diag = quad_ell_col = quad_ell_w = None
    quad_dia_offsets = quad_dia_w = quad_dia_pos = quad_dia_inv = None
    J = None
    if has_quad and n_cont > quad_max_n:
        ell = accumulate_information_ell(
            fused_factors, meta, n_cont, scales=scales, max_deg=ell_max_deg
        )
        if ell is None:
            # densely coupled rows: ELL would be O(n²) — un-fuse and let
            # the bucket path evaluate these factors
            has_quad = False
            fused_flags = [False] * len(fused_flags)
            fused_factors = []
        else:
            diag_np, col_np, w_np, h, c = ell
            quad_sparse = True
            quad_diag = _tensor(diag_np, device)
            quad_ell_col = _tensor(col_np, device)
            quad_ell_w = _tensor(w_np, device)
            quad_J = torch.zeros((0, 0), device=device)
            quad_h = _tensor(h, device, torch.float32)
            quad_c = _tensor(c, device, torch.float32)
            # banded refinement, detected in DECLARATION-ORDER coordinates
            # (each latent's position among all continuous RVs as
            # declared): a row-major grid keeps its {±1, ±W} template
            # there, and evidence positions become inert zero lanes
            if var_overrides is None:
                from lhvi_tpu_torch.ops.dia import ell_to_dia, pos_to_inv

                full_pos = np.empty(n_cont, np.int64)
                kfull = 0
                for rv in g.rvs:
                    if rv.domain.continuous:
                        kind, ii = meta.index[id(rv)]
                        if kind == "c":
                            full_pos[ii] = kfull
                        kfull += 1
                dia = ell_to_dia(col_np, w_np, pos=full_pos)
                if dia is not None:
                    quad_dia_offsets = dia[0]
                    quad_dia_w = _tensor(dia[1], device)
                    if dia[2] is not None:
                        quad_dia_pos = _tensor(dia[2], device, torch.int64)
                        quad_dia_inv = _tensor(pos_to_inv(dia[2], n_cont),
                                               device)
    if has_quad and not quad_sparse:
        J, h, c = accumulate_information_form(
            fused_factors, meta, n_cont, scales=scales
        )
        quad_J = _tensor(J, device, torch.float32)
        quad_h = _tensor(h, device, torch.float32)
        quad_c = _tensor(c, device, torch.float32)
    if not has_quad:
        quad_J = torch.zeros((0, 0), device=device)
        quad_h = torch.zeros((0,), device=device)
        quad_c = torch.zeros((), device=device)
    lp_bucket_idx = tuple(
        i for i, fused in enumerate(fused_flags) if not fused
    )

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
        "cont_counts": np.asarray(cont_counts, np.float32),
        "disc_counts": np.asarray(disc_counts, np.float32),
    }
    if has_quad and not quad_sparse:
        meta.np_global["quad_J"] = np.asarray(J, np.float32)
        meta.np_global["quad_h"] = np.asarray(h, np.float32)

    return CompiledFG(
        buckets=tuple(buckets),
        n_cont=n_cont,
        n_disc=n_disc,
        max_v=max_v,
        has_quad=has_quad,
        lp_bucket_idx=lp_bucket_idx,
        meta=meta,
        device=device,
        disc_sizes=_tensor(disc_sizes, device),
        disc_vals=_tensor(disc_vals, device),
        cont_lo=_tensor(cont_lo, device),
        cont_hi=_tensor(cont_hi, device),
        cont_ipoints=_tensor(cont_ip, device),
        cont_counts=_tensor(cont_counts, device, torch.float32),
        disc_counts=_tensor(disc_counts, device, torch.float32),
        quad_J=quad_J,
        quad_h=quad_h,
        quad_c=quad_c,
        quad_diag=quad_diag,
        quad_ell_col=quad_ell_col,
        quad_ell_w=quad_ell_w,
        quad_sparse=quad_sparse,
        quad_dia_offsets=quad_dia_offsets,
        quad_dia_w=quad_dia_w,
        quad_dia_pos=quad_dia_pos,
        quad_dia_inv=quad_dia_inv,
        gibbs=gibbs,
        color_plan=color_plan,
        n_colors=n_colors,
        color_of=_tensor(color_of, device),
    )


def _build_gibbs_gather(np_buckets: List[Dict[str, np.ndarray]],
                        n_disc: int, device) -> GibbsGather:
    """The scatter-free Gibbs plan (see ``GibbsGather``) from the host
    mirrors. Flat row order matches ``disc_logits``'s emission order:
    buckets in order (skipping ad == 0), slot-major, factor-minor."""
    all_vars: List[np.ndarray] = []
    all_rows: List[np.ndarray] = []
    off = 0
    for b in np_buckets:
        ad = b["disc_idx"].shape[1]
        if ad == 0:
            continue
        disc_idx = b["disc_idx"]
        disc_mask = b["disc_mask"] * b["disc_first"]
        n_f = disc_idx.shape[0]
        for p in range(ad):
            valid = disc_mask[:, p] > 0
            all_rows.append(off + np.nonzero(valid)[0].astype(np.int64))
            all_vars.append(disc_idx[valid, p].astype(np.int64))
            off += n_f
    return _group_gather(all_vars, all_rows, off, n_disc, device)


def _group_gather(all_vars: List[np.ndarray], all_rows: List[np.ndarray],
                  f_tot: int, n_var: int, device) -> GibbsGather:
    """Group (var, flat-row) incidences into degree-bucketed gather tables
    (row ``f_tot`` is the zero-padding row)."""
    if n_var == 0 or not all_vars:
        return GibbsGather(degrees=(), idx=(),
                           pos_of_var=torch.zeros(max(n_var, 0),
                                                  dtype=torch.int64,
                                                  device=device))
    vars_cat = np.concatenate(all_vars)
    rows_cat = np.concatenate(all_rows)
    order = np.argsort(vars_cat, kind="stable")
    rows_sorted = rows_cat[order]
    deg = np.bincount(vars_cat, minlength=n_var)
    starts = np.concatenate([[0], np.cumsum(deg)])

    def pad_deg(d: int) -> int:  # limit distinct group shapes
        if d <= 1:
            return 1
        p = 1
        while p < d:
            p *= 2
        return p

    group_vars: Dict[int, List[int]] = {}
    for v in range(n_var):
        group_vars.setdefault(pad_deg(int(deg[v])), []).append(v)

    degrees, idx_arrays = [], []
    pos_of_var = np.zeros(n_var, np.int64)
    pos = 0
    for d in sorted(group_vars):
        vs = group_vars[d]
        idx = np.full((len(vs), d), f_tot, np.int64)
        for r, v in enumerate(vs):
            k = int(deg[v])
            idx[r, :k] = rows_sorted[starts[v]: starts[v] + k]
            pos_of_var[v] = pos
            pos += 1
        degrees.append(d)
        idx_arrays.append(_tensor(idx, device))
    return GibbsGather(degrees=tuple(degrees), idx=tuple(idx_arrays),
                       pos_of_var=_tensor(pos_of_var, device))


def build_edge_gather(np_buckets: List[Dict[str, np.ndarray]],
                      patterns: List[Tuple[bool, ...]], n_cont: int,
                      n_disc: int, device) -> GibbsGather:
    """Gather plan over ALL latent (bucket, slot, factor) incidences with
    unified var ids (continuous first, then discrete). Flat row order:
    bucket-major, slot-major (full pattern order), factor-minor, matching
    ``[n_f, a, S].transpose(0, 1).reshape(a·n_f, S)`` per bucket. The
    message-passing engines assemble beliefs through it, each variable's
    sum in a fixed order on every device."""
    all_vars: List[np.ndarray] = []
    all_rows: List[np.ndarray] = []
    off = 0
    for np_b, pattern in zip(np_buckets, patterns):
        n_f = np_b["scale"].shape[0]
        ci = di = 0
        for is_cont in pattern:
            if is_cont:
                mask = np_b["cont_mask"][:, ci] > 0
                gv = np_b["cont_idx"][:, ci]
                ci += 1
            else:
                mask = np_b["disc_mask"][:, di] > 0
                gv = n_cont + np_b["disc_idx"][:, di]
                di += 1
            all_rows.append((off + np.nonzero(mask)[0]).astype(np.int64))
            all_vars.append(gv[mask].astype(np.int64))
            off += n_f
    return _group_gather(all_vars, all_rows, off, n_cont + n_disc, device)


def color_plan_bytes(fg: CompiledFG) -> dict:
    """Device memory of the compiled Gibbs colour plan: the bytes of the
    port's own tensors (its integer tables are int64, so the count is
    larger than the reference's int32 one).

    Returns ``{'total_bytes', 'per_group': [{'n_colors', 'n_vars',
    'bytes', 'n_elements'}], 'n_groups'}``.
    """
    if fg.color_plan is None:
        return {"total_bytes": 0, "per_group": [], "n_groups": 0}

    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from leaves(v)

    per_group = []
    for grp in fg.color_plan.groups:
        ts = list(leaves((grp.vars_, grp.sizes, grp.vals_, grp.bucket_tabs)))
        per_group.append({
            "n_colors": grp.n_colors, "n_vars": grp.n_vars,
            "bytes": int(sum(t.numel() * t.element_size() for t in ts)),
            "n_elements": int(sum(t.numel() for t in ts))})
    return {"total_bytes": sum(g["bytes"] for g in per_group),
            "per_group": per_group, "n_groups": len(per_group)}


def _build_color_plan(np_buckets: List[Dict[str, np.ndarray]], n_disc: int,
                      color_of: np.ndarray, disc_sizes: np.ndarray, device,
                      disc_vals: np.ndarray = None,
                      row_cap: int = 50_000_000):
    """Compile the per-color Gibbs tables (see ``GibbsColorGroup``): the
    reference's numpy construction, tensors placed on ``device``.

    For every (factor, discrete-var) adjacency edge: the factor row, the
    joint-substitution mask (all slots naming that var), the factor scale
    and the target's position in its color class. Colors are refined by
    per-var degree, grouped into power-of-two cost buckets, and every
    bucket's slot tables/params are pre-gathered per color.

    Returns ``None`` when there are no discrete latents, no edges, or the
    padded tables would exceed ``row_cap`` rows.
    """
    if n_disc == 0:
        return None
    n_colors = int(color_of.max() + 1)

    bucket_edges = []
    for np_b in np_buckets:
        ad = np_b["disc_idx"].shape[1]
        if ad == 0:
            bucket_edges.append(None)
            continue
        d_idx, d_mask, scale = (
            np_b["disc_idx"], np_b["disc_mask"], np_b["scale"]
        )
        keys, slots = [], []
        for p in range(ad):
            r = np.nonzero((d_mask[:, p] > 0) & (scale > 0))[0]
            keys.append(r.astype(np.int64) * n_disc + d_idx[r, p])
            slots.append(np.full(len(r), p, np.int64))
        keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        if len(keys) == 0:
            bucket_edges.append(None)
            continue
        slots = np.concatenate(slots)
        uniq, inv = np.unique(keys, return_inverse=True)
        sub = np.zeros((len(uniq), ad), bool)
        sub[inv, slots] = True
        edge_r = (uniq // n_disc).astype(np.int64)
        edge_v = (uniq % n_disc).astype(np.int64)
        bucket_edges.append(
            (edge_r, edge_v, sub, np_b["scale"][edge_r].astype(np.float32))
        )
    if all(e is None for e in bucket_edges):
        return None

    def _bits(x: np.ndarray) -> np.ndarray:
        return np.ceil(np.log2(np.maximum(x, 1) + 1)).astype(np.int64)

    # degree-refined coloring (subsets of independent sets stay
    # independent; bounds the [M, D] gather padding)
    deg_v = np.zeros(n_disc, np.int64)
    for e in bucket_edges:
        if e is not None:
            deg_v += np.bincount(e[1], minlength=n_disc)
    key2 = color_of.astype(np.int64) * 64 + _bits(deg_v)
    _, color_eff = np.unique(key2, return_inverse=True)
    color_of = color_eff.astype(np.int64).reshape(-1)
    n_colors = int(color_of.max() + 1)

    order = np.argsort(color_of, kind="stable")
    counts = np.bincount(color_of, minlength=n_colors)
    starts = np.concatenate([[0], np.cumsum(counts)])
    tloc_of_var = np.zeros(n_disc, np.int64)
    tloc_of_var[order] = np.arange(n_disc) - starts[color_of[order]]

    b_sorted = []
    for e in bucket_edges:
        if e is None:
            b_sorted.append(None)
            continue
        edge_r, edge_v, sub, w = e
        ec = color_of[edge_v]
        eo = np.argsort(ec, kind="stable")
        ecounts = np.bincount(ec, minlength=n_colors)
        estarts = np.concatenate([[0], np.cumsum(ecounts)])
        b_sorted.append(
            (edge_r[eo], edge_v[eo], sub[eo], w[eo], ecounts, estarts)
        )

    cost = np.zeros(n_colors, np.int64)
    for e in b_sorted:
        if e is not None:
            cost += e[4]

    dmax = np.zeros(n_colors, np.int64)
    for e in b_sorted:
        if e is None:
            continue
        edge_v = e[1]
        per_var = np.bincount(edge_v, minlength=n_disc)
        np.maximum.at(dmax, color_of[edge_v], per_var[edge_v])

    gkey = (_bits(cost) * 64 + _bits(counts)) * 64 + _bits(dmax)
    group_ids = {}
    for c in range(n_colors):
        group_ids.setdefault(int(gkey[c]), []).append(c)

    total_rows = 0
    for colors in group_ids.values():
        for e in b_sorted:
            if e is not None:
                total_rows += len(colors) * int(e[4][colors].max())
    if total_rows > row_cap:
        return None

    max_v = int(disc_sizes.max()) if len(disc_sizes) else 1
    if disc_vals is None:
        disc_vals = np.broadcast_to(
            np.arange(max_v, dtype=np.float32), (n_disc, max_v)
        )
    ar = np.arange(max_v, dtype=np.float64)
    vai = bool(
        np.all((disc_vals[:, :max_v] == ar[None, :])
               | (ar[None, :] >= disc_sizes[:, None]))
    ) if n_disc else True
    t = lambda a: _tensor(a, device)  # noqa: E731
    groups = []
    for _, colors in sorted(group_ids.items()):
        nc = len(colors)
        M = max(int(counts[colors].max()), 1)
        vars_g = np.full((nc, M), n_disc, np.int64)
        sizes_g = np.ones((nc, M), np.int64)
        vals_g = None if vai else np.zeros((nc, M, max_v), np.float32)
        for j, c in enumerate(colors):
            members = order[starts[c]: starts[c] + counts[c]]
            vars_g[j, : len(members)] = members
            sizes_g[j, : len(members)] = disc_sizes[members]
            if vals_g is not None:
                vals_g[j, : len(members)] = disc_vals[members, :max_v]

        tabs = []
        for np_b, e in zip(np_buckets, b_sorted):
            if e is None:
                tabs.append(None)
                continue
            edge_r, edge_v, sub, w, ecounts, estarts = e
            R = int(ecounts[colors].max())
            if R == 0:
                tabs.append(None)
                continue
            D = max(int(dmax[colors].max()), 1)
            eid = np.zeros((nc, R), np.int64)  # pad: edge 0 with w=0
            valid = np.zeros((nc, R), bool)
            vidx = np.full((nc, M, D), R, np.int64)
            for j, c in enumerate(colors):
                k = ecounts[c]
                sl = slice(estarts[c], estarts[c] + k)
                ov = np.argsort(edge_v[sl], kind="stable")
                eid[j, :k] = np.arange(estarts[c], estarts[c] + k)[ov]
                valid[j, :k] = True
                tl = tloc_of_var[edge_v[sl][ov]]
                _, first, cnts_v = np.unique(
                    tl, return_index=True, return_counts=True
                )
                occ = np.arange(k) - np.repeat(first, cnts_v)
                vidx[j, tl, occ] = np.arange(k)
            fr = edge_r[eid]  # [nc, R] factor rows
            vals_rows = np_b["disc_vals"][fr]  # [nc, R, ad, Kb]
            Kb = vals_rows.shape[-1]
            if np.array_equal(
                vals_rows,
                np.broadcast_to(np.arange(Kb, dtype=vals_rows.dtype),
                                vals_rows.shape),
            ):
                cval = None
                sv = None
            else:
                cval = np.take_along_axis(
                    vals_rows, np_b["disc_const"][fr][..., None].astype(
                        np.int64), axis=-1
                )[..., 0].astype(np.float32)
                sub_eid = sub[eid]  # [nc, R, ad]
                s0 = sub_eid.argmax(axis=-1)  # first substituted slot
                sv = np.take_along_axis(
                    vals_rows, s0[..., None, None], axis=2
                )[:, :, 0, :]  # [nc, R, Kb]
                if Kb < max_v:
                    sv = np.concatenate(
                        [sv, np.zeros(sv.shape[:-1] + (max_v - Kb,),
                                      sv.dtype)], axis=-1)
            tabs.append({
                "cont_idx": t(np_b["cont_idx"][fr]),
                "cont_mask": t(np_b["cont_mask"][fr]),
                "cont_const": t(np_b["cont_const"][fr]),
                "disc_idx": t(np_b["disc_idx"][fr]),
                "disc_mask": t(np_b["disc_mask"][fr]),
                "disc_const": t(np_b["disc_const"][fr]),
                "disc_cval": None if cval is None else t(cval),
                "sub_vals": (None if sv is None
                             else t(sv[..., :max_v].astype(np.float32))),
                "params": {k: t(v[fr]) for k, v in np_b["params"].items()},
                "sub": t(sub[eid]),
                "w": t(np.where(valid, w[eid], 0.0).astype(np.float32)),
                "vidx": t(vidx),
            })
        groups.append(GibbsColorGroup(
            n_colors=nc, n_vars=M, vars_=t(vars_g), sizes=t(sizes_g),
            vals_=None if vals_g is None else t(vals_g),
            bucket_tabs=tuple(tabs)))
    return GibbsColorPlan(groups=tuple(groups), values_are_indices=vai)


def _greedy_color(g: Graph, meta: FGMeta, n_disc: int) -> np.ndarray:
    """Greedy conflict coloring of discrete latent slots (two slots conflict
    if some factor touches both) → a valid chromatic-Gibbs schedule."""
    adj: List[set] = [set() for _ in range(n_disc)]
    for f in g.factors:
        slots = []
        for rv in f.nb:
            kind, idx = meta.index[id(rv)]
            if kind == "d":
                slots.append(idx)
        for a in slots:
            for b in slots:
                if a != b:
                    adj[a].add(b)
    color = -np.ones(n_disc, np.int64)
    for v in range(n_disc):
        used = {color[u] for u in adj[v] if color[u] >= 0}
        c = 0
        while c in used:
            c += 1
        color[v] = c
    if n_disc == 0:
        return np.zeros(0, np.int64)
    return color
