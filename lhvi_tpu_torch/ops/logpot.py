"""Batched leapfrog on (possibly tempered) non-quadratic targets (PyTorch
port of ``lhvi_tpu/ops/logpot.py``, the reference's XLA path).

The tempered continuous energy

    E(x) = β·log_prob_cont_batched(x, xd) + (1−β)·[−½ Σ_i (x_i − mid_i)² / s_i²]

and its gradient (``torch.autograd.grad``) drive an n-step leapfrog with
merged half-kicks: SMC's default rejuvenation move. The reference's fused
Pallas kernel for this function (K5, ``plan="auto"`` or a plan object)
arrives with Slice 8; until then those plans raise.
"""

from __future__ import annotations

import torch

_SLICE8 = ("the fused log-potential kernel (K5) arrives with Slice 8, the "
           "fused non-quadratic path (ROADMAP Queue 1 item 10)")


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
            return torch.autograd.grad(torch.sum(logp(Xr)), Xr)[0]

    with torch.no_grad():
        e0 = logp(x)
    p = p + 0.5 * eps * grad(x)
    for i in range(n_steps):
        x = x + eps * inv_mass[None] * p
        p = p + (0.5 if i == n_steps - 1 else 1.0) * eps * grad(x)
    with torch.no_grad():
        e1 = logp(x)
    return x, p, e0, e1


def logpot_leapfrog(fg, x, p, xd, inv_mass, eps, n_steps: int,
                    beta=None, base_mid=None, base_inv_s2=None, plan=None):
    """Batched leapfrog on a (possibly tempered) target.

    x, p: [C, n_cont]; xd: [C, n_disc] (held fixed); eps and beta may be
    floats or 0-d tensors. Returns ``(x1, p1, lp0, lp1)`` where lp is the
    log-density of the tempered target at the start and end points, up to
    an x-independent constant. ``plan=None`` is the only route in this
    slice.
    """
    if plan is not None:
        raise NotImplementedError(f"logpot_leapfrog(plan={plan!r}): "
                                  + _SLICE8)
    use_base = base_mid is not None
    dev = x.device
    if beta is None:
        beta = torch.ones((), device=dev)
    if base_mid is None:
        base_mid = torch.zeros((fg.n_cont,), device=dev)
        base_is2 = torch.zeros((fg.n_cont,), device=dev)
    else:
        base_is2 = base_inv_s2
    return _torch_logpot_leapfrog(fg, x, p, xd, inv_mass, eps, beta,
                                  base_mid, base_is2, n_steps, use_base)
