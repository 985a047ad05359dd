"""Plain reference of the robot-mapping hybrid MLN
(``configs/robot_map100.json``).

NumPy and plain PyTorch only: nothing of the program. Float64 throughout
except where a stated ``dtype`` says otherwise (the control).

The model, over segments ``i = 0 .. n-1``, each with a type ``t_i`` in
{0 wall, 1 door, 2 other} (domain values 0, 1, 2) and a depth ``d_i``:

    log p(t, d) = sum_i log type_prior[t_i]
                + sum_i -d_i^2 / (2 depth_prior_var)
                + sum_i -w_type_depth (d_i - mu[t_i])^2
                + sum_i w_neighbor [t_i = t_(i+1)]
                + sum_i -w_smooth (d_i - d_(i+1))^2           + const

Each term's convention, read from the port's potential classes:

- the type prior and the 3 x 3 agreement table are ``TablePotential``s,
  evaluated as the log of the table: ``log type_prior[t]`` and
  ``log exp(w_neighbor I)[t, t'] = w_neighbor [t = t']``;
- the depth prior is ``GaussianPotential([0], [[4]])``: 4 is the
  variance, ``log phi = -1/2 log(2 pi 4) - d^2 / 8``;
- ``type_sets_depth`` is an ``MLNPotential``, the weight times the
  formula: ``4 * -(d - mu[t])^2``;
- the smoothness is ``QuadraticPotential(A, b = 0)`` with ``A = [[-w,
  w], [w, -w]]``, ``log phi = x^T A x = -w (d_i - d_(i+1))^2`` (no factor
  1/2).

The depth's ``Domain([-3, 3])`` is ignored: the posterior is taken over
the whole real line. ``mass_beyond`` computes what that leaves out: the
posterior mass of any latent depth beyond +-3, under 1e-12 on the seeds
the tests read (a latent depth's conditional sd is 0.31 and its means lie
within +-1.1).

**Exact method.** Every latent depth (``i % depth_miss_every ==
depth_miss_every - 1``) has only observed depths beside it, so given the
types the latent depths are independent one-dimensional Gaussians: its
terms are ``-1/2 a d^2 + b(t) d + c(t)``. Integrated out in closed form,
``log int = c + b^2 / (2 a) + 1/2 log(2 pi / a)`` joins its segment's node
potential; forward-backward over the 3-state chain of types gives every
type's exact marginal; each latent depth's mean and variance are then
exact mixtures of ``N(b(t) / a, 1 / a)`` over its type.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench.reference.gauss_grid128 import (StreamedDiagnostics,
                                               seed_sequence)

_DRAW_TAG = 0x726F626F  # the control's stream of draws


def make_inputs(cfg: dict, seed: int) -> dict:
    """The scan's evidence from the seed, drawn as
    ``robot_scan_evidence(n_segments, seed)`` draws it: the true types
    from the layout, the labelled types, and every depth but the missing
    ones, ``mu[type] + scan_noise N(0, 1)`` written to 4 decimals."""
    n, miss = cfg["n_segments"], cfg["depth_miss_every"]
    lay = cfg["scan_layout"]
    rng = np.random.default_rng(int(seed) % 2**64)
    mus = np.asarray(cfg["type_depth_mu"])
    types = np.zeros(n, np.int64)
    types[lay["door_first"]::lay["door_every"]] = 1
    types[lay["other_first"]::lay["other_every"]] = 2
    labelled = np.unique(np.linspace(0, n - 1, cfg["n_type_labels"])
                         .astype(int))
    d_idx, d_val = [], []
    for i in range(n):
        if i % miss != miss - 1:
            d = mus[types[i]] + cfg["scan_noise"] * rng.standard_normal()
            d_idx.append(i)
            d_val.append(float(f"{d:.4f}"))
    return dict(true_types=types, type_obs_idx=labelled,
                type_obs_val=types[labelled], depth_obs_idx=np.array(d_idx),
                depth_obs_val=np.array(d_val))


def latent_types(cfg: dict, inputs: dict) -> np.ndarray:
    """Segments whose type is latent, ascending (the reference's order)."""
    lat = np.ones(cfg["n_segments"], bool)
    lat[inputs["type_obs_idx"]] = False
    return np.flatnonzero(lat)


def latent_depths(cfg: dict, inputs: dict) -> np.ndarray:
    """Segments whose depth is latent, ascending (the reference's order)."""
    lat = np.ones(cfg["n_segments"], bool)
    lat[inputs["depth_obs_idx"]] = False
    return np.flatnonzero(lat)


def _depths(cfg: dict, inputs: dict) -> np.ndarray:
    """Every segment's observed depth (nan where latent)."""
    d = np.full(cfg["n_segments"], np.nan)
    d[inputs["depth_obs_idx"]] = inputs["depth_obs_val"]
    return d


def log_density(cfg: dict, inputs: dict, types, depths) -> np.ndarray:
    """The unnormalised log density at full states: ``types [..., n]``
    (values 0, 1, 2) and ``depths [..., n]`` over every segment, the
    observed entries at their evidence (the caller puts them there)."""
    t = np.asarray(types, np.int64)
    d = np.asarray(depths, np.float64)
    mu = np.asarray(cfg["type_depth_mu"])
    v = cfg["depth_prior_var"]
    out = np.log(np.asarray(cfg["type_prior"]))[t].sum(-1)
    out = out + (-0.5 * np.log(2 * np.pi * v) - d * d / (2 * v)).sum(-1)
    out = out - cfg["w_type_depth"] * ((d - mu[t]) ** 2).sum(-1)
    out = out + cfg["w_neighbor"] * (t[..., 1:] == t[..., :-1]).sum(-1)
    out = out - cfg["w_smooth"] * ((d[..., 1:] - d[..., :-1]) ** 2).sum(-1)
    return out


def depth_conditionals(cfg: dict, inputs: dict):
    """``(a, b [n_lat, 3], c [n_lat, 3])``: each latent depth's terms
    ``-1/2 a d^2 + b(t) d + c(t)`` for each value of its segment's type,
    with its (observed) neighbours' depths in. ``a`` is the same for
    every latent depth with two neighbours."""
    n = cfg["n_segments"]
    d = _depths(cfg, inputs)
    mu = np.asarray(cfg["type_depth_mu"])
    wtd, ws = cfg["w_type_depth"], cfg["w_smooth"]
    lat = latent_depths(cfg, inputs)
    a = np.zeros(len(lat))
    b = np.zeros((len(lat), 3))
    c = np.zeros((len(lat), 3))
    for k, j in enumerate(lat):
        nbrs = [i for i in (j - 1, j + 1) if 0 <= i < n]
        if any(np.isnan(d[i]) for i in nbrs):
            raise ValueError(f"latent depth {j} has a latent neighbour: the "
                             "reference's exact method needs observed ones")
        a[k] = 1.0 / cfg["depth_prior_var"] + 2 * wtd + 2 * ws * len(nbrs)
        b[k] = 2 * wtd * mu + 2 * ws * sum(d[i] for i in nbrs)
        c[k] = -wtd * mu * mu - ws * sum(d[i] ** 2 for i in nbrs)
    return a, b, c


def node_potentials(cfg: dict, inputs: dict) -> np.ndarray:
    """``psi [n, 3]``: each segment's log-potential over its type, with
    its observed depth's terms, or its latent depth integrated out, in;
    ``-inf`` off a labelled type."""
    n = cfg["n_segments"]
    d = _depths(cfg, inputs)
    mu = np.asarray(cfg["type_depth_mu"])
    psi = np.tile(np.log(np.asarray(cfg["type_prior"])), (n, 1))
    obs = ~np.isnan(d)
    psi[obs] -= cfg["w_type_depth"] * (d[obs, None] - mu[None]) ** 2
    a, b, c = depth_conditionals(cfg, inputs)
    lat = latent_depths(cfg, inputs)
    psi[lat] += (c + b * b / (2 * a[:, None])
                 + 0.5 * np.log(2 * np.pi / a[:, None]))
    for i, v in zip(inputs["type_obs_idx"], inputs["type_obs_val"]):
        keep = psi[i, v]
        psi[i] = -np.inf
        psi[i, v] = keep
    return psi


def _edge(cfg: dict) -> np.ndarray:
    return cfg["w_neighbor"] * np.eye(3)


def _lse(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
            ).squeeze(axis)


def forward_messages(cfg: dict, inputs: dict) -> np.ndarray:
    """``log alpha [n, 3]``: ``alpha_i(t)`` sums the chain's potentials
    over ``t_0 .. t_(i-1)`` with ``t_i = t`` (normalised at each step)."""
    psi, E = node_potentials(cfg, inputs), _edge(cfg)
    la = np.empty_like(psi)
    la[0] = psi[0] - _lse(psi[0], 0)
    for i in range(1, len(psi)):
        x = _lse(la[i - 1][:, None] + E, 0) + psi[i]
        la[i] = x - _lse(x, 0)
    return la


def type_marginals(cfg: dict, inputs: dict) -> np.ndarray:
    """``P [n, 3]``: every segment's exact type marginal (forward-backward;
    a labelled segment reads one-hot)."""
    psi, E = node_potentials(cfg, inputs), _edge(cfg)
    la = forward_messages(cfg, inputs)
    lb = np.zeros_like(psi)
    for i in range(len(psi) - 2, -1, -1):
        x = _lse(E + (psi[i + 1] + lb[i + 1])[None, :], 1)
        lb[i] = x - _lse(x, 0)
    lp = la + lb
    return np.exp(lp - _lse(lp, 1)[:, None])


def posterior(cfg: dict, inputs: dict) -> dict:
    """The exact answer: ``type_probs [n_latent_types, 3]`` (latent types
    ascending) and the latent depths' ``mean`` and ``var`` (ascending)."""
    P = type_marginals(cfg, inputs)
    a, b, _ = depth_conditionals(cfg, inputs)
    w = P[latent_depths(cfg, inputs)]
    m = b / a[:, None]
    mean = np.sum(w * m, 1)
    var = np.sum(w * (1.0 / a[:, None] + m * m), 1) - mean * mean
    return dict(type_probs=P[latent_types(cfg, inputs)], mean=mean, var=var)


def mass_beyond(cfg: dict, inputs: dict) -> float:
    """The posterior mass, summed over the latent depths, beyond the
    depth domain's ends (what ignoring ``Domain([-3, 3])`` leaves out)."""
    lo, hi = cfg["depth_domain"]
    P = type_marginals(cfg, inputs)[latent_depths(cfg, inputs)]
    a, b, _ = depth_conditionals(cfg, inputs)
    m, s = b / a[:, None], 1.0 / np.sqrt(a)[:, None]
    tail = np.vectorize(lambda z: 0.5 * math.erfc(z / math.sqrt(2)))
    return float(np.sum(P * (tail((hi - m) / s) + tail((m - lo) / s))))


@contextlib.contextmanager
def _no_tf32():
    """Float32 products in full float32 on the card, whatever the process
    set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rhat_values(diag: StreamedDiagnostics):
    """Split-R-hat of value traces, 1 where a latent never moved in any
    chain (the program's convention for a frozen discrete latent)."""
    h = diag.h
    means = torch.cat(diag.mean)
    W = torch.mean(torch.cat(diag.m2) / (h - 1), dim=0)
    B = h * torch.var(means, dim=0)
    rhat = torch.sqrt(((h - 1) / h * W + B / h) / W)
    frozen = (W <= 0) & (B <= 1e-12)
    return torch.where(frozen, torch.ones_like(rhat), rhat)


def exact_moments(cfg: dict, inputs: dict, n_chains: int, n_warmup: int,
                  n_samples: int, seed: int, dtype=torch.float32,
                  device="cpu"):
    """``(mean, var, diag, type_probs)`` of the latent depths and types
    from ``n_samples`` exact i.i.d. draws of each of ``n_chains`` chains
    (``n_warmup`` is accepted and unused: exact draws need no warmup),
    in the program's answer's shapes (latents ascending): forward
    filtering in float64, then backward sampling of the types and the
    depths given them. The sampling tables are formed in float64, then
    every tensor, every draw and every sum (the depths' moments, the
    types' counts, ``StreamedDiagnostics`` over the depths and over the
    types' value traces) is in ``dtype``, as a sampler of the program
    would stream them; it stands in for the program in the control."""
    la = forward_messages(cfg, inputs)
    E = _edge(cfg)
    n = len(la)
    # back[i, t', t] = P(t_i = t | t_(i+1) = t'), as cumulative sums
    back = la[:-1, None, :] + E.T[None, :, :]
    back = np.exp(back - _lse(back, 2)[..., None])
    t_ = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,  # noqa: E731
                                   device=device)
    cdf_back = t_(np.cumsum(back, 2)[..., :2])
    cdf_last = t_(np.cumsum(np.exp(la[-1]))[:2])
    a, b, _ = depth_conditionals(cfg, inputs)
    lt, ld = latent_types(cfg, inputs), latent_depths(cfg, inputs)
    mean_t, sd = t_((b / a[:, None]).T), t_(1.0 / np.sqrt(a))  # [3, n_ld]
    ld_ix = torch.as_tensor(ld, device=device)
    lt_ix = torch.as_tensor(lt, device=device)
    gen = torch.Generator(device).manual_seed(
        int(seed_sequence(seed, _DRAW_TAG).generate_state(1)[0]))
    C = n_chains
    s1 = torch.zeros(len(ld), dtype=dtype, device=device)
    s2 = torch.zeros(len(ld), dtype=dtype, device=device)
    cnt = torch.zeros((len(lt), 3), dtype=dtype, device=device)
    dd = StreamedDiagnostics(n_samples, torch.zeros((C, len(ld)),
                                                    dtype=dtype,
                                                    device=device))
    dt = StreamedDiagnostics(n_samples, torch.zeros((C, len(lt)),
                                                    dtype=dtype,
                                                    device=device))
    cols = torch.arange(len(ld), device=device)
    with _no_tf32():
        for k in range(n_samples):
            u = torch.rand((C, n), generator=gen, dtype=dtype, device=device)
            t = torch.empty((C, n), dtype=torch.int64, device=device)
            t[:, -1] = (u[:, -1, None] > cdf_last).sum(-1)
            for i in range(n - 2, -1, -1):
                t[:, i] = (u[:, i, None] > cdf_back[i][t[:, i + 1]]).sum(-1)
            z = torch.randn((C, len(ld)), generator=gen, dtype=dtype,
                            device=device)
            x = mean_t[t[:, ld_ix], cols] + sd * z
            s1 = s1 + torch.sum(x, dim=0)
            s2 = s2 + torch.sum(x * x, dim=0)
            tv = t[:, lt_ix]
            cnt = cnt + torch.nn.functional.one_hot(tv, 3).to(dtype).sum(0)
            dd.add(k, x)
            dt.add(k, tv.to(dtype))
    n_obs = C * n_samples
    m = s1 / n_obs
    v = s2 / n_obs - m * m

    def host(x):
        return x.double().cpu().numpy()

    diag = {k: host(x) for k, x in dd.result().items()}
    diag["rhat_disc"] = host(_rhat_values(dt))
    diag["disc_diag_idx"] = np.arange(len(lt))
    return host(m), host(v), diag, host(cnt / n_obs)
