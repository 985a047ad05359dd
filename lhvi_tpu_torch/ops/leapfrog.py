"""Fused leapfrog for quadratic (information-form) targets (PyTorch port).

Counterpart of ``lhvi_tpu/ops/leapfrog.py``. When a model's continuous part
is fully fused into ``(J, h)``, the leapfrog gradient is ``h − xJ`` and the
whole n-step integration for a tile of chains runs inside ONE kernel
(K1, ``csrc/quad_leapfrog.cu``): positions stay in shared memory for the
whole trajectory, so the state crosses device memory once per proposal
instead of once per step.

``quad_leapfrog`` launches K1 for CUDA tensors and runs the plain version
``_torch_quad_leapfrog`` for CPU tensors; there is no other route.

The sparse (ELL) helpers had no Pallas kernel in the reference either and
are plain torch ops here.
"""

from __future__ import annotations

import torch

from lhvi_tpu_torch.ops import _build


def _torch_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int):
    """Plain version of K1 (batched, merged half-kicks)."""

    def grad(x):
        return h - x @ J

    p = p + 0.5 * eps * grad(x)
    for i in range(n_steps):
        x = x + eps * inv_mass * p
        g = grad(x)
        p = p + (0.5 if i == n_steps - 1 else 1.0) * eps * g
    return x, p


def _check_f32(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def eps_tensor(eps, device) -> torch.Tensor:
    """The step size as a 0-d f32 tensor on ``device`` (a device tensor is
    passed through untouched, so no host sync is needed to read it)."""
    if isinstance(eps, torch.Tensor):
        return eps.reshape(())
    return torch.full((), float(eps), dtype=torch.float32, device=device)


def _cuda_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int):
    C, n = x.shape
    dev = x.device
    eps = eps_tensor(eps, dev)
    for name, t, shape in (("x", x, (C, n)), ("p", p, (C, n)),
                           ("J", J, (n, n)), ("h", h, (n,)),
                           ("inv_mass", inv_mass, (n,)), ("eps", eps, ())):
        _check_f32(name, t, dev, shape)
    xo = torch.empty_like(x)
    po = torch.empty_like(p)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().lhvi_quad_leapfrog(
        x.data_ptr(), p.data_ptr(), J.data_ptr(), h.data_ptr(),
        inv_mass.data_ptr(), eps.data_ptr(), xo.data_ptr(), po.data_ptr(),
        C, n, int(n_steps), stream)
    _build.check(code, "quad_leapfrog")
    quad_leapfrog.launches += 1
    return xo, po


def quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int):
    """Batched leapfrog on the fused quadratic target.

    x, p: [C, n]; J: [n, n]; h, inv_mass: [n]; eps: float or 0-d tensor.
    CUDA tensors go through kernel K1 (``quad_leapfrog.launches`` counts
    its launches); CPU tensors through the plain version.
    """
    if x.is_cuda:
        return _cuda_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps)
    if x.device.type != "cpu":
        raise NotImplementedError(f"quad_leapfrog: no route for {x.device}")
    return _torch_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps)


quad_leapfrog.launches = 0


def ell_matvec(x, diag, col, w):
    """``J @ x`` for a batch in ELL form: x [C, n] → [C, n].

    For small D the neighbor sum unrolls into D gather·FMA ops, which avoids
    materializing the [C, n, D] gather."""
    y = x * diag[None]
    D = col.shape[1]
    if D <= 16:
        for d in range(D):
            y = y + w[None, :, d] * x[:, col[:, d]]
        return y
    return y + torch.sum(w[None] * x[:, col], dim=-1)


def ell_quad_leapfrog(x, p, diag, col, w, h, inv_mass, eps, n_steps: int):
    """Batched position-Verlet leapfrog on a SPARSE (ELL) quadratic target.

    x, p: [C, n]; diag, h, inv_mass: [n]; col/w: [n, D] padded-neighbor
    tables. Returns ``(x1, p1, g0, g1)``: the endpoint gradients let the
    caller form both Hamiltonians without extra matvecs
    (lp = c + ½·x·(h + g)).
    """

    def matvec(x):
        return ell_matvec(x, diag, col, w)

    g0 = h[None] - matvec(x)
    if n_steps == 0:
        return x, p, g0, g0
    m = p + 0.5 * eps * g0
    for _ in range(n_steps - 1):
        x = x + eps * inv_mass[None] * m
        g = h[None] - matvec(x)
        m = m + eps * g
    x = x + eps * inv_mass[None] * m
    g1 = h[None] - matvec(x)
    p1 = m + 0.5 * eps * g1
    return x, p1, g0, g1
