"""Mixture-of-Gaussian variational inference (PyTorch port of
``lhvi_tpu/engines/vi.py``).

The belief is ``b(x) = Σ_k w_k Π_v b_v^k(x_v)`` with Gaussian components
for continuous latents and categoricals for discrete ones; the ELBO is

    ELBO = Σ_f m_f · Σ_k w_k E_{b_k}[log φ_f]  +  H̃(b)

where the factor expectations use Gauss–Hermite quadrature over the latent
continuous slots × enumeration over the latent discrete slots, ``m_f`` is
the lifted orbit count (``FactorBucket.scale``) and ``H̃`` is a lower
bound on the mixture entropy with per-variable terms weighted by orbit
sizes (``cont_counts``/``disc_counts``).

The reference runs the fit as one jitted ``lax.scan`` of optax Adam; here
it is a Python loop of ``torch.optim.Adam`` steps (the same defaults: b1
0.9, b2 0.999, eps 1e-8 outside the square root) that never reads the
device: the ELBO trace stays in a device tensor until the fit ends. Each
bucket's quadrature grid, its slot tables and the flat indices of its
discrete beliefs depend on no parameter, so they are built once per
(graph, ``n_quad``) and kept on the device (``CompiledFG.vi_plans``);
the log-potentials of buckets that read no continuous slot are constant
too, and are evaluated there once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lhvi_tpu_torch.fg.compile import CompiledFG, FactorBucket, _expand_params
from lhvi_tpu_torch.parallel.mesh import all_reduce, sum_over_shards
from lhvi_tpu_torch.utils.debug import check_nan

_NEG_BIG = -1e30


@dataclasses.dataclass(frozen=True)
class VIConfig:
    K: int = 4
    n_quad: int = 9
    lr: float = 5e-2
    n_iters: int = 1500
    init_sigma: float = 1.0
    seed_spread: float = 1.0


class VIParams(NamedTuple):
    log_w: torch.Tensor  # [K]
    mu: torch.Tensor  # [K, n_cont]
    log_sigma: torch.Tensor  # [K, n_cont]
    logits: torch.Tensor  # [K, n_disc, Vmax]


def init_params(fg: CompiledFG, gen: torch.Generator,
                cfg: VIConfig) -> VIParams:
    """Initial parameters; ``gen`` is a ``torch.Generator`` on
    ``fg.device``."""
    dev = fg.device
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    span = torch.clamp(fg.cont_hi - fg.cont_lo, max=4.0)
    z = torch.randn((cfg.K, fg.n_cont), generator=gen, device=dev)
    mu = mid + cfg.seed_spread * span[None, :] * 0.25 * z
    logits = 0.1 * torch.randn((cfg.K, fg.n_disc, fg.max_v), generator=gen,
                               device=dev)
    return VIParams(
        log_w=torch.zeros(cfg.K, device=dev),
        mu=mu,
        log_sigma=torch.full((cfg.K, fg.n_cont), math.log(cfg.init_sigma),
                             device=dev),
        logits=logits,
    )


def _valid_mask(fg: CompiledFG) -> torch.Tensor:
    """[n_disc, Vmax] 1 where the value index is inside the domain."""
    v = torch.arange(fg.max_v, device=fg.device)[None, :]
    return (v < fg.disc_sizes[:, None]).to(torch.float32)


def beliefs_disc(fg: CompiledFG, params: VIParams) -> torch.Tensor:
    """Masked per-component categorical beliefs [K, n_disc, Vmax]."""
    mask = _valid_mask(fg)[None]
    logits = torch.where(mask > 0, params.logits,
                         torch.full((), _NEG_BIG, device=fg.device))
    return torch.softmax(logits, dim=-1) * mask


def _bucket_grid(b: FactorBucket, n_quad: int, max_v: int):
    """Static quadrature/enumeration grid for one bucket (host numpy).

    Returns (node_sel [G, ac] f32, ghw_prod [G] f32, val_idx [G, ad] int)
    where the grid spans GH nodes for latent cont slots (a single dummy
    node for observed ones) × value indices for latent disc slots.
    """
    ghx, ghw = np.polynomial.hermite.hermgauss(n_quad)
    ghw = ghw / np.sqrt(np.pi)  # normalized: sum = 1

    axes = []
    kinds = []  # ('c', slot) or ('d', slot)
    for p, lat in enumerate(b.cont_lat):
        axes.append(np.arange(n_quad) if lat else np.array([0]))
        kinds.append(("c", p))
    for p, lat in enumerate(b.disc_lat):
        axes.append(np.arange(max_v) if lat else np.array([0]))
        kinds.append(("d", p))
    mesh = np.meshgrid(*axes, indexing="ij") if axes else []
    G = int(mesh[0].size) if mesh else 1

    node_sel = np.zeros((G, len(b.cont_lat)), np.float64)  # GH node value
    ghw_prod = np.ones(G, np.float64)
    val_idx = np.zeros((G, len(b.disc_lat)), np.int64)
    for (kind, p), m in zip(kinds, mesh):
        flat = m.reshape(-1)
        if kind == "c":
            if b.cont_lat[p]:
                node_sel[:, p] = ghx[flat]
                ghw_prod *= ghw[flat]
            # observed slot: node 0, weight 1 (value comes from cont_const)
        else:
            val_idx[:, p] = flat
    return (node_sel.astype(np.float32), ghw_prod.astype(np.float32),
            val_idx)


class _BucketPlan(NamedTuple):
    """The parameter-free part of one bucket's expectation, on the device.

    ``bd_idx``/``bd_lat`` hold, per latent discrete slot, the flat index
    ``var · Vmax + value`` of every (row, grid point) into the
    ``[K, n_disc·Vmax]`` beliefs and the rows where the slot is latent
    (padding rows are not). ``log_phi`` is the clipped kernel output
    ``[1, n_f, G]`` where the bucket reads no continuous slot (it is then
    constant; ``xdi``/``xdv`` are then None), else None and
    ``xdi``/``xdv`` feed the kernel each step."""

    node_sel: torch.Tensor  # f32 [G, ac]
    ghw: torch.Tensor  # f32 [G]
    bd_idx: Tuple[torch.Tensor, ...]  # i64 [n_f, G] per latent disc slot
    bd_lat: Tuple[torch.Tensor, ...]  # bool [n_f, 1]
    xdi: torch.Tensor  # i64 [1, n_f, G, ad] | None
    xdv: torch.Tensor  # f32 [1, n_f, G, ad] | None
    log_phi: torch.Tensor  # f32 [1, n_f, G] | None


def _clip(log_phi: torch.Tensor) -> torch.Tensor:
    """The reference's ``clip(nan_to_num(·, neginf=-1e30), -1e30)``: nan
    becomes 0, ±inf the extremes, and nothing falls below −1e30."""
    return torch.clamp_min(
        torch.nan_to_num(log_phi, nan=0.0, neginf=_NEG_BIG), _NEG_BIG)


def _bucket_plan(fg: CompiledFG, b: FactorBucket, n_quad: int) -> _BucketPlan:
    node_sel, ghw_prod, val_idx = _bucket_grid(b, n_quad, fg.max_v)
    dev = fg.device
    G = ghw_prod.shape[0]
    n_f, ad = b.n_factors, b.ad
    if ad:
        val = torch.as_tensor(val_idx, device=dev)
        xdi = torch.where(b.disc_mask[:, None, :] > 0,
                          val[None].expand(n_f, G, ad),
                          b.disc_const[:, None, :])[None]
        xdv = b.slot_values(xdi)
    else:
        xdi = torch.zeros((1, n_f, G, 0), dtype=torch.int64, device=dev)
        xdv = torch.zeros((1, n_f, G, 0), device=dev)
    bd_idx, bd_lat = [], []
    for p, lat in enumerate(b.disc_lat):
        if lat and fg.n_disc:
            on = b.disc_mask[:, p:p + 1] > 0
            bd_idx.append(b.disc_idx[:, p:p + 1] * fg.max_v
                          + torch.where(on, xdi[0, :, :, p], 0))
            bd_lat.append(on)
    log_phi = None
    if b.ac == 0:
        pk = _expand_params({k: v[None] for k, v in b.params.items()}, 1)
        xs = torch.zeros((1, n_f, G, 0), device=dev)
        with torch.no_grad():
            log_phi = _clip(b.kernel(pk, xs, xdi, xdv))
        xdi = xdv = None  # the kernel never runs again
    return _BucketPlan(
        node_sel=torch.as_tensor(node_sel, device=dev),
        ghw=torch.as_tensor(ghw_prod, device=dev),
        bd_idx=tuple(bd_idx), bd_lat=tuple(bd_lat),
        xdi=xdi, xdv=xdv, log_phi=log_phi)


def _vi_plans(fg: CompiledFG, n_quad: int):
    """Every surviving bucket's plan, built once per (graph, n_quad)."""
    plans = fg.vi_plans.get(n_quad)
    if plans is None:
        plans = {i: _bucket_plan(fg, fg.buckets[i], n_quad)
                 for i in fg.lp_bucket_idx}
        fg.vi_plans[n_quad] = plans
    return plans


def _bucket_expected_logpot(fg: CompiledFG, b: FactorBucket,
                            params: VIParams, bd: torch.Tensor,
                            plan: _BucketPlan) -> torch.Tensor:
    """Σ_f scale_f Σ_k w_k E_{b_k}[log φ_f] for one bucket."""
    G = plan.ghw.shape[0]
    n_f, ac = b.n_factors, b.ac
    K = params.mu.shape[0]

    # per-component weight of each grid point: Π over latent disc slots of
    # b_k(var)[val] (one gather a slot, [K, n_f, G]; invalid values carry
    # zero belief mass); observed slots and padding rows weigh 1
    w_disc = None
    if plan.bd_idx:
        bd_flat = bd.reshape(K, -1)
        for idx, on in zip(plan.bd_idx, plan.bd_lat):
            sel = torch.index_select(bd_flat, 1, idx.reshape(-1))
            sel = torch.where(on[None], sel.reshape(K, n_f, G), 1.0)
            w_disc = sel if w_disc is None else w_disc * sel
    else:
        w_disc = torch.ones((1, n_f, G), device=fg.device)

    if plan.log_phi is not None:
        log_phi = plan.log_phi
    else:
        # continuous evaluation points: [K, n_f, G, ac]
        if params.mu.shape[1]:
            mu = params.mu[:, b.cont_idx]  # [K, n_f, ac]
            sig = torch.exp(params.log_sigma)[:, b.cont_idx]
            pts = (mu[:, :, None, :] + math.sqrt(2.0) * sig[:, :, None, :]
                   * plan.node_sel[None, None, :, :])
            xs = torch.where(b.cont_mask[None, :, None, :] > 0, pts,
                             b.cont_const[None, :, None, :])
        else:  # every cont slot observed (no latent cont vars to gather)
            xs = b.cont_const[None, :, None, :].expand(K, n_f, G, ac)
        pk = _expand_params({k: v[None] for k, v in b.params.items()}, 1)
        log_phi = _clip(b.kernel(pk, xs, plan.xdi, plan.xdv))  # [K, n_f, G]
    e_kf = torch.sum(plan.ghw[None, None, :] * w_disc * log_phi, dim=-1)
    w = torch.softmax(params.log_w, dim=0)
    return torch.sum(b.scale[None, :] * w[:, None] * e_kf)


def mixture_entropy_bound(fg: CompiledFG, params: VIParams,
                          bd: torch.Tensor) -> torch.Tensor:
    """Lower bound on the mixture entropy: the max of two valid bounds.

    (a) Jensen pairwise-overlap bound: H(q) ≥ −Σ_k w_k log Σ_l w_l z_kl,
        z_kl = ∫ q_k q_l. Tight for well-separated components.
    (b) Conditional-entropy bound: H(q) ≥ Σ_k w_k H(q_k), exact at K=1 and
        for identical components.

    Both hold for every parameter value, so their pointwise maximum is a
    valid (and tighter) bound. Per-variable terms are weighted by lifted
    orbit counts; everything stays f32.
    """
    w = torch.softmax(params.log_w, dim=0)
    log_w = torch.log_softmax(params.log_w, dim=0)
    K = params.mu.shape[0]

    # --- (a) pairwise-overlap Jensen bound ------------------------------
    log_z = torch.zeros((K, K), device=fg.device)
    if fg.n_cont:
        mu_k = params.mu[:, None, :]  # [K, 1, n]
        mu_l = params.mu[None, :, :]
        v = torch.exp(2.0 * params.log_sigma)
        var = v[:, None, :] + v[None, :, :]
        per_var = -0.5 * (torch.log(2.0 * math.pi * var)
                          + (mu_k - mu_l) ** 2 / var)  # [K, K, n]
        log_z = log_z + torch.sum(fg.cont_counts[None, None, :] * per_var,
                                  dim=-1)
    if fg.n_disc:
        ov = torch.sum(bd[:, None] * bd[None, :], dim=-1)  # [K, K, n_disc]
        log_ov = torch.log(torch.clamp_min(ov, 1e-30))
        log_z = log_z + torch.sum(fg.disc_counts[None, None, :] * log_ov,
                                  dim=-1)
    inner = torch.logsumexp(log_w[None, :] + log_z, dim=1)  # [K]
    h_jensen = -torch.sum(w * inner)

    # --- (b) conditional-entropy bound ----------------------------------
    h_comp = torch.zeros((K,), device=fg.device)
    if fg.n_cont:
        h_gauss = params.log_sigma + 0.5 * math.log(2.0 * math.pi * math.e)
        h_comp = h_comp + torch.sum(fg.cont_counts[None, :] * h_gauss, dim=-1)
    if fg.n_disc:
        h_cat = -torch.sum(
            torch.where(bd > 0, bd * torch.log(torch.clamp_min(bd, 1e-30)),
                        0.0),
            dim=-1,
        )  # [K, n_disc]
        h_comp = h_comp + torch.sum(fg.disc_counts[None, :] * h_cat, dim=-1)
    h_cond = torch.sum(w * h_comp)

    return torch.maximum(h_jensen, h_cond)


def _quad_expected(fg: CompiledFG, params: VIParams) -> torch.Tensor:
    """Closed-form Σ_k w_k E_{b_k}[−½xJx + hx + c] for the fused quadratic
    information form: E[xJx] = μᵀJμ + Σ_i J_ii σ_i² under mean-field."""
    w = torch.softmax(params.log_w, dim=0)
    mu = params.mu  # [K, n]
    s2 = torch.exp(2.0 * params.log_sigma)
    if fg.quad_sparse:
        quad = (torch.sum(mu * fg.quad_matvec_batched(mu), dim=-1)
                + s2 @ fg.quad_diag)
    else:
        quad = (torch.einsum("ki,ij,kj->k", mu, fg.quad_J, mu)
                + torch.einsum("i,ki->k", torch.diagonal(fg.quad_J), s2))
    lin = mu @ fg.quad_h
    return torch.sum(w * (-0.5 * quad + lin + fg.quad_c))


def elbo(fg: CompiledFG, params: VIParams, n_quad: int) -> torch.Tensor:
    """The ELBO of ``params``. On a factor-sharded graph
    (``parallel.shard_fg_factors``) it is the whole graph's ELBO on every
    rank, and its gradient is this rank's share: the bucket terms of this
    rank's rows plus the replicated terms (``mixture_entropy_bound``,
    ``_quad_expected``) scaled by 1/world, so the sum of the ranks'
    gradients (``_fit_from``'s ``all_reduce``) counts the replicated terms
    once (``parallel/mesh.py::sum_over_shards``)."""
    plans = _vi_plans(fg, n_quad)
    bd = beliefs_disc(fg, params)
    sh = fg.factor_shard
    rep = mixture_entropy_bound(fg, params, bd)
    if fg.has_quad:
        rep = rep + _quad_expected(fg, params)
    total = rep if sh is None else torch.zeros((), device=fg.device)
    for i in fg.lp_bucket_idx:
        total = total + _bucket_expected_logpot(fg, fg.buckets[i], params,
                                                bd, plans[i])
    return total if sh is None else sum_over_shards(rep, total, sh)


def _fit_from(fg: CompiledFG, params: VIParams, cfg: VIConfig):
    """Optimize the ELBO from given initial params with Adam; returns
    (params, elbo_trace [n_iters]), the trace a device tensor of the ELBO
    before each update (the loop itself reads nothing back). On a
    factor-sharded graph every step all-reduces the ranks' gradient shares
    (see :func:`elbo`) before the update, so every rank takes the same
    step; the trace holds the whole graph's ELBO."""
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    opt = torch.optim.Adam(leaves, lr=cfg.lr)
    trace = torch.empty((cfg.n_iters,), device=fg.device)
    for i in range(cfg.n_iters):
        opt.zero_grad(set_to_none=True)
        e = elbo(fg, VIParams(*leaves), cfg.n_quad)
        check_nan("vi.fit step", elbo=e, **dict(zip(VIParams._fields,
                                                    leaves)))
        (-e).backward()
        if fg.factor_shard is not None:
            _all_reduce_grads(leaves, fg.factor_shard)
        opt.step()
        trace[i] = e.detach()
    return VIParams(*(p.detach() for p in leaves)), trace


def _all_reduce_grads(leaves, shard) -> None:
    """Sum every leaf's gradient over the ranks of ``shard``, in one
    collective (a leaf the ELBO did not reach counts as zero)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), shard)
    for p, g in zip(leaves, torch.split(flat, [g.numel() for g in grads])):
        p.grad = g.reshape(p.shape)


def fit(fg: CompiledFG, gen: torch.Generator, cfg: VIConfig = VIConfig()):
    """Optimize the ELBO; returns (params, elbo_trace [n_iters])."""
    return _fit_from(fg, init_params(fg, gen, cfg), cfg)


class VIResult:
    """Mixture-belief queries (``mean``, ``var``, ``disc_marginal``,
    ``belief``, ``map``), on host copies of the fitted parameters.
    Variables resolve only through ``fg.meta`` (RV objects, or keys on
    the relational compiler's graphs)."""

    def __init__(self, fg: CompiledFG, params: VIParams, trace=None):
        self.fg = fg
        self.params = VIParams(*(p.detach().cpu().numpy() for p in params))
        self.trace = None if trace is None else trace.detach().cpu().numpy()
        self.w = torch.softmax(params.log_w.detach(), 0).cpu().numpy()
        self.bd = beliefs_disc(fg, params).detach().cpu().numpy()

    def _loc(self, rv, want):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if kind != want:
            raise ValueError(f"{rv} is {'continuous' if kind == 'c' else 'discrete'}")
        return i

    def mean(self, rv) -> float:
        i = self._loc(rv, "c")
        return float(np.sum(self.w * self.params.mu[:, i]))

    def var(self, rv) -> float:
        i = self._loc(rv, "c")
        mu = self.params.mu[:, i]
        s2 = np.exp(2.0 * self.params.log_sigma[:, i])
        m = np.sum(self.w * mu)
        return float(np.sum(self.w * (s2 + mu**2)) - m**2)

    def disc_marginal(self, rv) -> np.ndarray:
        i = self._loc(rv, "d")
        size = self.fg.meta.disc_size(rv)
        return np.einsum("k,kv->v", self.w, self.bd[:, i, :size])

    def belief(self, x, rv) -> float:
        """Mixture marginal density/pmf of rv at x."""
        kind, i = self.fg.meta.loc(rv)
        if kind == "c":
            mu = self.params.mu[:, i]
            s = np.exp(self.params.log_sigma[:, i])
            dens = np.exp(-0.5 * ((x - mu) / s) ** 2) / (s * np.sqrt(2 * np.pi))
            return float(np.sum(self.w * dens))
        probs = self.disc_marginal(rv)
        return float(probs[self.fg.meta.value_index(rv, x)])

    def map(self, rv):
        kind, i = self.fg.meta.loc(rv)
        if kind == "d":
            probs = self.disc_marginal(rv)
            return self.fg.meta.disc_values(rv)[int(probs.argmax())]
        # mixture MODE: argmax of the mixture density on a dense grid over
        # its support, then a parabola through the winning cell
        mu = self.params.mu[:, i]
        s = np.exp(self.params.log_sigma[:, i])
        lo = float((mu - 4.0 * s).min())
        hi = float((mu + 4.0 * s).max())
        grid = np.linspace(lo, hi, 2049)
        dens = np.sum(
            self.w[:, None]
            * np.exp(-0.5 * ((grid[None, :] - mu[:, None]) / s[:, None]) ** 2)
            / (s[:, None] * np.sqrt(2 * np.pi)),
            axis=0,
        )
        j = int(np.argmax(dens))
        if 0 < j < len(grid) - 1:
            y0, y1, y2 = dens[j - 1], dens[j], dens[j + 1]
            denom = y0 - 2.0 * y1 + y2
            if denom < 0:
                dx = 0.5 * (y0 - y2) / denom
                return float(grid[j] + dx * (grid[1] - grid[0]))
        return float(grid[j])


def infer(fg: CompiledFG, gen: torch.Generator,
          cfg: VIConfig = VIConfig()) -> VIResult:
    params, trace = fit(fg, gen, cfg)
    return VIResult(fg, params, trace)


# ---------------------------------------------------------------------------
# Coarse-to-fine lifted VI: optimize on a coarse orbit partition, then split
# clusters and warm-start the finer stage. The hierarchy comes from
# truncated colour refinement: ``max_rounds`` rounds give ever-finer valid
# partitions, ending at the fixpoint (exact lifted) or the grounded graph.
# ---------------------------------------------------------------------------


def _stage_gen(device, seed: int, stage: int) -> torch.Generator:
    """One generator for each stage, seeded from (seed, stage) (the
    reference folds the stage into its key)."""
    s = int(np.random.SeedSequence([seed, stage]).generate_state(1)[0])
    return torch.Generator(device).manual_seed(s)


def _stage_iters(cfg: VIConfig, n_stages: int):
    """Steps per stage: ``cfg.n_iters`` split evenly, the last stage taking
    the remainder (each stage at least 1; below ``n_stages`` steps the
    remainder is not added on top of that minimum)."""
    base = cfg.n_iters // n_stages
    iters = max(base, 1)
    rem = cfg.n_iters % n_stages if base >= 1 else 0
    return [iters + (rem if si == n_stages - 1 else 0)
            for si in range(n_stages)]


def _gather_params(params: VIParams, c_src, d_src, fg_b: CompiledFG):
    """Stage-B params whose slot i copies stage-A slot ``c_src[i]`` /
    ``d_src[i]`` (host index arrays)."""
    K, dev = params.mu.shape[0], params.mu.device
    c = torch.as_tensor(c_src[: fg_b.n_cont], device=dev)
    d = torch.as_tensor(d_src[: fg_b.n_disc], device=dev)
    return VIParams(
        log_w=params.log_w,
        mu=(params.mu[:, c] if fg_b.n_cont
            else torch.zeros((K, 0), device=dev)),
        log_sigma=(params.log_sigma[:, c] if fg_b.n_cont
                   else torch.zeros((K, 0), device=dev)),
        logits=(params.logits[:, d] if fg_b.n_disc
                else torch.zeros((K, 0, fg_b.max_v), device=dev)),
    )


def _transfer_params(fg_a: CompiledFG, fg_b: CompiledFG,
                     params: VIParams) -> VIParams:
    """Warm-start stage-B params by copying each ground RV's stage-A orbit
    params into its (finer) stage-B slot."""
    c_src = np.zeros(max(fg_b.n_cont, 1), np.int64)
    d_src = np.zeros(max(fg_b.n_disc, 1), np.int64)
    for rv in fg_a.meta.graph.rvs:
        if rv.observed:
            continue
        k_a, i_a = fg_a.meta.loc(rv)
        k_b, i_b = fg_b.meta.loc(rv)
        if k_b == "c":
            c_src[i_b] = i_a
        else:
            d_src[i_b] = i_a
    return _gather_params(params, c_src, d_src, fg_b)


def infer_c2f(g, seed: int, cfg: VIConfig = VIConfig(),
              schedule=(0, None, "ground"), pad_to: int = 8,
              device="cuda") -> VIResult:
    """Coarse-to-fine VI over a refinement schedule, on ``device`` (the
    card unless the caller names another).

    ``schedule`` entries: int = that many color-refinement rounds
    (0 = coarsest: domain/evidence/potential-type classes), ``None`` =
    fixpoint (exact lifted partition), ``"ground"`` = fully grounded.
    ``cfg.n_iters`` is split evenly across stages; each stage warm-starts
    from the previous partition's parameters. The first stage's
    parameters are drawn from a generator seeded from (seed, 0).
    """
    from lhvi_tpu_torch.fg.compile import compile_graph
    from lhvi_tpu_torch.lift import compile_lifted

    if not schedule:
        raise ValueError("infer_c2f: schedule must be non-empty")
    params = prev_fg = None
    traces = []
    for si, (stage, n_iters) in enumerate(
            zip(schedule, _stage_iters(cfg, len(schedule)))):
        stage_cfg = dataclasses.replace(cfg, n_iters=n_iters)
        if stage == "ground":
            fg = compile_graph(g, device, pad_to=pad_to)
        else:
            rounds = 10_000 if stage is None else int(stage)
            fg = compile_lifted(g, device, pad_to=pad_to, max_rounds=rounds)
        if params is None:
            params = init_params(fg, _stage_gen(fg.device, seed, si),
                                 stage_cfg)
        else:
            params = _transfer_params(prev_fg, fg, params)
        params, trace = _fit_from(fg, params, stage_cfg)
        traces.append(trace)
        prev_fg = fg
    return VIResult(fg, params, torch.cat(traces))


def infer_c2f_fast(fg: CompiledFG, seed: int, cfg: VIConfig = VIConfig(),
                   schedule=(1, None, "ground")) -> VIResult:
    """Coarse-to-fine VI on a grounded :class:`CompiledFG`, with no object
    graph anywhere, so it composes with ``relational.fast.fast_compile``
    and runs at million-latent scale (on ``fg.device``).

    ``schedule`` entries: int k ≥ 1 = k rounds of IR-level color
    refinement (``lift.fast.refine_ir``; round 1 is the coarsest useful
    partition: domain/evidence/row-param classes), ``None`` = fixpoint
    (exact lifted partition), ``"ground"`` = the input graph itself.
    Refinement is monotone in rounds, so each stage's orbits split the
    previous stage's and params warm-start by orbit inheritance.
    """
    from lhvi_tpu_torch.lift.fast import fast_lift

    if not schedule:
        raise ValueError("infer_c2f_fast: schedule must be non-empty")
    ident = (np.arange(fg.n_cont), np.arange(fg.n_disc))
    params = prev_cols = None
    traces = []
    for si, (stage, n_iters) in enumerate(
            zip(schedule, _stage_iters(cfg, len(schedule)))):
        stage_cfg = dataclasses.replace(cfg, n_iters=n_iters)
        if stage == "ground":
            fg_s, cols = fg, ident
        else:
            rounds = 10_000 if stage is None else max(int(stage), 1)
            fg_s = fast_lift(fg, max_rounds=rounds)
            cols = (fg_s.meta._c, fg_s.meta._d)
        if params is None:
            params = init_params(fg_s, _stage_gen(fg.device, seed, si),
                                 stage_cfg)
        else:
            # ground→orbit maps give the transfer vectorized: stage-B slot
            # cols_b[g] inherits stage-A slot cols_a[g] (consistent because
            # refinement is monotone: every B orbit lies inside one A orbit)
            c_src = np.zeros(max(fg_s.n_cont, 1), np.int64)
            c_src[cols[0]] = prev_cols[0]
            d_src = np.zeros(max(fg_s.n_disc, 1), np.int64)
            d_src[cols[1]] = prev_cols[1]
            # the inheritance scatter is only well-defined when the
            # schedule is genuinely coarse-to-fine; verify it round-trips
            # instead of silently picking a writer
            if (np.any(c_src[cols[0]] != prev_cols[0])
                    or np.any(d_src[cols[1]] != prev_cols[1])):
                raise ValueError(
                    "infer_c2f_fast: schedule is not coarse-to-fine — "
                    f"stage {si} ({stage!r}) orbits do not refine stage "
                    f"{si - 1}'s; order schedule entries from fewer to "
                    "more refinement rounds")
            params = _gather_params(params, c_src, d_src, fg_s)
        params, trace = _fit_from(fg_s, params, stage_cfg)
        traces.append(trace)
        prev_cols = cols
    return VIResult(fg_s, params, torch.cat(traces))
