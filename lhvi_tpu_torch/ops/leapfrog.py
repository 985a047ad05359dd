"""Fused leapfrog for quadratic (information-form) targets (PyTorch port).

Counterpart of ``lhvi_tpu/ops/leapfrog.py``. When a model's continuous part
is fully fused into ``(J, h)``, the leapfrog gradient is ``h − xJ`` and the
whole n-step integration runs inside ONE kernel (K1,
``csrc/quad_leapfrog.cu``). Up to n = 256 a warp holds its chains' x, p
and x·J in registers for the whole trajectory, so the state crosses device
memory once per proposal instead of once per step; past 256 one
cooperative grid splits each step's product into 128 × 128 tiles with a
grid barrier a step. :func:`k1_launch` chooses the geometry.

``quad_leapfrog`` launches K1 for CUDA tensors and runs the plain version
``_torch_quad_leapfrog`` for CPU tensors; there is no other route.

The sparse (ELL) helpers had no Pallas kernel in the reference either and
are plain torch ops here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.utils.metrics import count


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


K1_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use
K1_MAX_N = 4096
K1_RESIDENT_MAX_N = 256
K1_RESIDENT_WARPS = 4
K1_J_SMEM_BUDGET = 113 * 1024  # J beside the tile while 2 blocks fit an SM
K1_TILE = 128  # cooperative layout: chains and columns of an output tile
K1_BK = 16     # cooperative layout: k depth of a cp.async stage
K1_COOP_WARPS = 8
K1_COOP_BLOCKS_PER_SM = 2  # __launch_bounds__(256, 2)


class K1Launch(NamedTuple):
    """K1's launch geometry (``csrc/quad_leapfrog.cu``).

    ``layout`` "resident": blocks of ``warps`` warps, each warp holding
    ``chains`` chains for the whole trajectory (a thread their M × NP tile
    of x, p and x·J), ``smem`` bytes of shared memory (the transposed
    position tile, and J when ``j_smem``), ``grid`` blocks. "coop": one
    cooperative grid of ``grid`` blocks of ``warps`` warps over ``chains`` ×
    ``chains`` output tiles, ``smem`` bytes each, ``scratch`` floats of
    padded, transposed copies."""

    layout: str
    chains: int
    warps: int
    smem: int
    grid: int
    j_smem: bool
    scratch: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def k1_tile_stride(M: int) -> int:
    """Row stride (floats) of the resident layout's [n][4M + pad] position
    tile: the pad makes a warp's column-strided vector stores fall on
    distinct banks (``tile_stride`` in the kernel)."""
    return K1_RESIDENT_WARPS * M + (4 if M >= 4 else 2)


def k1_launch(n: int, C: int, sms: int = 132) -> K1Launch:
    """The geometry K1 runs at for ``C`` chains of ``n`` coordinates on a
    card of ``sms`` SMs. n ≤ 256: the resident layout, NP = ceil(n/32)
    columns a lane and 8 chains a warp up to NP = 3, 4 up to 6, else 2
    (an M × NP tile of x, p and the product in registers); J in shared
    memory beside the tile while the block still leaves room for a second
    one. n > 256: the cooperative layout, as many blocks as 128 × 128
    output tiles, at most ``sms`` × 2 (every block resident)."""
    if not 1 <= n <= K1_MAX_N:
        raise ValueError(f"n={n}: K1 takes 1..{K1_MAX_N} coordinates")
    if C < 1:
        raise ValueError(f"C={C}: K1 needs at least one chain")
    if n <= K1_RESIDENT_MAX_N:
        np_ = -(-n // 32)
        M = 8 if np_ <= 3 else (4 if np_ <= 6 else 2)
        tile = _round_up(4 * n * k1_tile_stride(M), 16)
        j_smem = tile + 4 * n * n <= K1_J_SMEM_BUDGET
        smem = tile + (4 * n * n if j_smem else 0)
        return K1Launch("resident", M, K1_RESIDENT_WARPS, smem,
                        -(-C // (K1_RESIDENT_WARPS * M)), j_smem, 0)
    Cpad, kpad, npad = (_round_up(C, K1_TILE), _round_up(n, K1_BK),
                        _round_up(n, K1_TILE))
    tiles = (Cpad // K1_TILE) * (npad // K1_TILE)
    return K1Launch("coop", K1_TILE, K1_COOP_WARPS,
                    2 * K1_BK * 2 * K1_TILE * 4,
                    min(tiles, sms * K1_COOP_BLOCKS_PER_SM), False,
                    kpad * npad + 2 * kpad * Cpad + npad * Cpad)


def _cuda_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int):
    C, n = x.shape
    dev = x.device
    eps = eps_tensor(eps, dev)
    for name, t, shape in (("x", x, (C, n)), ("p", p, (C, n)),
                           ("J", J, (n, n)), ("h", h, (n,)),
                           ("inv_mass", inv_mass, (n,)), ("eps", eps, ())):
        _check_f32(name, t, dev, shape)
    geo = k1_launch(n, C, _build.sm_count(dev))
    xo = torch.empty_like(x)
    po = torch.empty_like(p)
    scratch = barrier = None
    if geo.layout == "coop":
        scratch = torch.empty((geo.scratch,), dtype=torch.float32, device=dev)
        barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().lhvi_quad_leapfrog(
        x.data_ptr(), p.data_ptr(), J.data_ptr(), h.data_ptr(),
        inv_mass.data_ptr(), eps.data_ptr(), xo.data_ptr(), po.data_ptr(),
        C, n, int(n_steps), 0 if geo.layout == "resident" else 1, geo.chains,
        geo.warps, geo.smem, geo.grid, int(geo.j_smem),
        None if scratch is None else scratch.data_ptr(),
        None if barrier is None else barrier.data_ptr(), stream)
    _build.check(code, "quad_leapfrog")
    count("ops.k1.launches")
    return xo, po


def quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int):
    """Batched leapfrog on the fused quadratic target.

    x, p: [C, n]; J: [n, n]; h, inv_mass: [n]; eps: float or 0-d tensor.
    CUDA tensors go through kernel K1 (counter ``ops.k1.launches`` counts
    its launches); CPU tensors through the plain version.
    """
    if x.is_cuda:
        return _cuda_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps)
    if x.device.type != "cpu":
        raise NotImplementedError(f"quad_leapfrog: no route for {x.device}")
    return _torch_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps)


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
