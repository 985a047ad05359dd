"""Plain reference of the hybrid friends-smokers MLN
(``configs/friends_smokers320.json``).

NumPy and plain PyTorch only: nothing of the program.

People ``0..N-1``; ``smokes(i)``, ``cancer(i)`` and ``friends(i, j)``
(``i != j``) are binary, ``stress(i)`` is real. The grounded log-density:

    sum_i  w_sc (1 - s_i + s_i c_i)                         smokes => cancer
  + sum_{i != j} w_fr (1 - f_ij + f_ij eq(s_i, s_j))       friends => same
  + sum_i  (-1/2 log 2 pi - t_i^2 / 2)                     stress ~ N(0, 1)
  + sum_i  w_st s_i / (1 + exp(-2 t_i))                    stress => smokes

with ``eq(a, b) = a b + (1 - a)(1 - b)`` and the observed ``smokes``
clamped. The variational family is the program's: a mixture of ``K``
components, each a product of Gaussians over the ``stress`` latents and
categoricals over the binary latents. Its ELBO is

    sum_k w_k E_k[log p]  +  max(H_jensen, H_cond)

where ``E_k`` of a factor of stress is Gauss-Hermite quadrature with
``n_quad`` nodes, and the two entropy bounds are
``H_cond = sum_k w_k H(q_k)`` and ``H_jensen = -sum_k w_k log sum_l w_l
z_kl`` with ``z_kl = int q_k q_l`` (both are lower bounds of the mixture's
entropy; the ELBO takes the larger).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_INPUT_TAG = 0x66733332  # the generator's stream for the inputs


def make_inputs(cfg: dict, seed: int) -> dict:
    """The observed people and their ``smokes`` values, from the seed:
    ``n_observed`` people, half of them smokers."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, _INPUT_TAG]))
    n, k = cfg["n_people"], cfg["n_observed"]
    obs = np.sort(rng.choice(n, k, replace=False))
    val = rng.permutation(np.repeat([0, 1], [k // 2, k - k // 2]))
    return dict(obs_idx=obs, obs_smokes=val.astype(np.int64))


def cancer_closed_form(cfg: dict, inputs: dict) -> np.ndarray:
    """P(cancer = 1) of each observed person: cancer appears in its one
    ``smokes => cancer`` factor, so given smokes it is sigma(w_sc) for a
    smoker and 1/2 for a non-smoker."""
    sig = 1.0 / (1.0 + math.exp(-cfg["w_smokes_cancer"]))
    return np.where(inputs["obs_smokes"] == 1, sig, 0.5)


def _p1(logits: torch.Tensor) -> torch.Tensor:
    """P(value 1) of binary categoricals from their two logits."""
    return torch.softmax(logits, dim=-1)[..., 1]


def marginals(q: dict, dtype=torch.float64, device="cpu") -> dict:
    """Mixture marginals P(x = 1) of the binary latents: ``smokes`` [N]
    (observed people read their value), ``cancer`` [N], ``friends``
    [N, N] (diagonal 0)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    w = torch.softmax(t(q["log_w"]), 0)
    out = {}
    for name in ("smokes", "cancer", "friends"):
        p = _p1(t(q[f"{name}_logits"]))
        out[name] = torch.einsum("k,k...->...", w, p)
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def elbo(cfg: dict, inputs: dict, q: dict, n_quad: int,
         dtype=torch.float64, device="cpu") -> float:
    """The ELBO of the variational parameters ``q`` (reference layout:
    ``log_w`` [K], ``mu``/``log_sigma`` [K, N] of stress,
    ``smokes_logits``/``cancer_logits`` [K, N, 2], ``friends_logits``
    [K, N, N, 2]; the observed people's smokes logits and the diagonal of
    friends are ignored). Every tensor is in ``dtype``."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=device)
    N = cfg["n_people"]
    w_sc, w_fr, w_st = (cfg["w_smokes_cancer"], cfg["w_friends"],
                        cfg["w_stress"])
    log_w = t(q["log_w"])
    w = torch.softmax(log_w, 0)
    lw = torch.log_softmax(log_w, 0)
    obs = torch.as_tensor(inputs["obs_idx"], device=device)
    lat_s = np.ones(N, bool)
    lat_s[inputs["obs_idx"]] = False
    lat_s = torch.as_tensor(lat_s, device=device)
    off = ~torch.eye(N, dtype=torch.bool, device=device)

    b_s = torch.softmax(t(q["smokes_logits"]), -1)      # [K, N, 2]
    b_c = torch.softmax(t(q["cancer_logits"]), -1)      # [K, N, 2]
    b_f = torch.softmax(t(q["friends_logits"]), -1)     # [K, N, N, 2]
    ps = b_s[..., 1].clone()
    ps[:, obs] = t(inputs["obs_smokes"])[None, :]
    pc, pf = b_c[..., 1], b_f[..., 1]

    # expected log-potentials of each component, [K]
    e_sc = w_sc * torch.sum(1.0 - ps + ps * pc, dim=1)
    eq = (ps[:, :, None] * ps[:, None, :]
          + (1.0 - ps)[:, :, None] * (1.0 - ps)[:, None, :])
    e_fr = w_fr * torch.sum(torch.where(off, 1.0 - pf + pf * eq,
                                        torch.zeros((), dtype=dtype,
                                                    device=device)),
                            dim=(1, 2))
    ghx, ghw = np.polynomial.hermite.hermgauss(n_quad)
    ghx, ghw = t(ghx), t(ghw / math.sqrt(math.pi))
    mu, log_sig = t(q["mu"]), t(q["log_sigma"])
    sig = torch.exp(log_sig)
    pts = mu[..., None] + math.sqrt(2.0) * sig[..., None] * ghx  # [K, N, G]
    e_pr = torch.sum(ghw * (-0.5 * math.log(2 * math.pi) - 0.5 * pts * pts),
                     dim=(1, 2))
    e_st = w_st * torch.sum(ps * torch.sum(ghw * torch.sigmoid(2.0 * pts),
                                           dim=-1), dim=1)
    expected = torch.sum(w * (e_sc + e_fr + e_pr + e_st))

    # the binary latents' beliefs, [K, M, 2]
    bd = torch.cat([b_s[:, lat_s], b_c, b_f[:, off]], dim=1)

    # conditional-entropy bound
    h_g = torch.sum(log_sig + 0.5 * math.log(2 * math.pi * math.e), dim=1)
    logb = torch.log(torch.clamp_min(bd, 1e-30))
    h_cat = -torch.sum(torch.where(bd > 0, bd * logb,
                                   torch.zeros((), dtype=dtype,
                                               device=device)), dim=-1)
    h_cond = torch.sum(w * (h_g + torch.sum(h_cat, dim=1)))

    # pairwise-overlap (Jensen) bound
    v = torch.exp(2.0 * log_sig)
    var = v[:, None, :] + v[None, :, :]
    log_z = torch.sum(-0.5 * (torch.log(2.0 * math.pi * var)
                              + (mu[:, None, :] - mu[None, :, :]) ** 2 / var),
                      dim=-1)
    ov = torch.sum(bd[:, None] * bd[None, :], dim=-1)        # [K, K, M]
    log_z = log_z + torch.sum(torch.log(torch.clamp_min(ov, 1e-30)), dim=-1)
    h_jensen = -torch.sum(w * torch.logsumexp(lw[None, :] + log_z, dim=1))

    return float(expected + torch.maximum(h_jensen, h_cond))
