"""Banded (DIA) quadratic targets: detection and the fused HMC proposal
(PyTorch port of ``lhvi_tpu/ops/dia.py``).

Grid, chain and other banded information matrices have a handful of
diagonals: ``J x = diag·x + Σ_k w_k · x[i + o_k]`` for a small static
offset set ``{o_k}``. The host half (``ell_to_dia``, ``pos_to_inv``) is the
reference's numpy code. The device half runs the whole HMC proposal —
momentum draw, trajectory, energies, log-accept — in ONE kernel (K2,
``csrc/dia_proposal.cu``) on latent rows: clusters of blocks split the
embedded row, keep a group of chains' positions in shared memory and
their momenta in registers for the whole trajectory, and read the latent
rows and lane constants through the inverse embedding. The public
leapfrog from given momenta, ``dia_quad_leapfrog``, runs the same
trajectory body in K6 (``csrc/dia_leapfrog.cu``). :func:`dia_launch`
chooses the geometry both run at.

Correctness of wrapped indices: an entry ``w_k[i] ≠ 0`` implies the edge
(i, i+o_k) exists, hence ``0 ≤ i+o_k < n`` — every wrapped-around neighbour
is multiplied by a structural zero (asserted in ``ell_to_dia``), so the
plain version's ``torch.roll`` and the kernel's modular index are exact.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.ops.leapfrog import _check_f32, eps_tensor
from lhvi_tpu_torch.utils.metrics import count

# Widest embedded row K2 and K6 take: at 28,672 lanes a cluster of 8
# blocks holds 3,584 lanes each, with their lane constants and at least two
# chains' double-buffered positions within the H100's 227 KB per block
# (``dia_launch``). Wider banded models take the ELL path (as the reference
# does past its own cap).
DIA_MAX_EMB = 28 * 1024
# K2's and K6's shared memory per block (csrc/dia_traj.cuh kSmemLimit) and
# the momenta a thread holds in registers, lanes x chains (kRegLanes)
DIA_SMEM_LIMIT = 227 * 1024
_REG_LANES = 32
_MAX_THREADS = 512


def ell_to_dia(col: np.ndarray, w: np.ndarray, pos: np.ndarray = None,
               max_offsets: int = 8):
    """Detect a banded structure in padded-neighbor (ELL) tables.

    col/w: [n, D] neighbor tables (``CompiledFG.quad_ell_col/_w``).
    pos: optional [n] EMBEDDING of each latent into a larger banded
    coordinate space — evidence conditioning compacts latent indices, so
    a grid with observed nodes has irregular latent-index offsets, while
    its declaration-order positions (latents + observed interleaved)
    keep the {±1, ±W} template; the embedded vector simply carries inert
    zero lanes at evidence positions.

    Returns ``(offsets, wdia, pos)`` — a static tuple of K ≤ max_offsets
    diagonal offsets, the f32 [K, n_emb] per-diagonal weights with
    ``(J x)[pos[i]] = Σ_k wdia[k, pos[i]]·x_emb[pos[i] + offsets[k]]``
    (diagonal handled separately), and the embedding (``None`` when it
    is the identity) — or ``None`` when the active offsets don't fit the
    budget (then the ELL gather path stands).
    """
    col = np.asarray(col)
    w = np.asarray(w, np.float32)
    n, D = col.shape
    if n == 0:
        return None
    if pos is not None:
        pos = np.asarray(pos, np.int64)
        if np.array_equal(pos, np.arange(n)):
            pos = None
    if pos is None:
        n_emb = n
        posv = np.arange(n, dtype=np.int64)
    else:
        n_emb = int(pos.max()) + 1
        posv = pos
    offs = posv[col] - posv[:, None]  # [n, D] embedded-coordinate offsets
    active = w != 0.0
    if not active.any():
        return (), np.zeros((0, n_emb), np.float32), pos
    uoffs = np.unique(offs[active])
    if len(uoffs) > max_offsets:
        return None
    wdia = np.zeros((len(uoffs), n_emb), np.float32)
    for k, o in enumerate(uoffs):
        contrib = np.where(active & (offs == o), w, 0.0).sum(axis=1)
        np.add.at(wdia[k], posv, contrib)
        # structural-zero invariant that makes the wrapped index exact
        i = np.flatnonzero(wdia[k])
        assert i.size == 0 or (0 <= i.min() + o and i.max() + o < n_emb)
    return tuple(int(o) for o in uoffs), wdia, pos


def pos_to_inv(pos: np.ndarray, n: int) -> np.ndarray:
    """Inverse embedding index: i32 [n_emb] mapping each embedded lane to
    its latent index, with the sentinel ``n`` at gap (evidence) lanes, so
    the embedding is a gather (``_embed_gather``)."""
    pos = np.asarray(pos)
    n_emb = int(pos.max()) + 1
    inv = np.full(n_emb, n, np.int32)
    inv[pos] = np.arange(n, dtype=np.int32)
    return inv


def _embed(a, pos, n_emb: int):
    """Scatter latent-space rows [..., n] into the declaration-order
    embedded space [..., n_emb] (zeros at evidence positions)."""
    out = torch.zeros(a.shape[:-1] + (n_emb,), dtype=a.dtype, device=a.device)
    out[..., pos] = a
    return out


def _embed_gather(a, inv):
    """Gather-based embedding: append one zero column and index by the
    inverse map (gaps hit the sentinel column)."""
    az = torch.cat([a, torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype,
                                   device=a.device)], dim=-1)
    return az[..., inv]


def dia_matvec(x, diag, offsets, wdia, pos=None):
    """``J @ x`` for a batch in DIA form: x [C, n] → [C, n] (torch ops).

    Shift-multiply-accumulate over the K diagonals; ``pos`` embeds and
    extracts around the shifts when the weights live in declaration-order
    coordinates."""
    if pos is not None:
        n_emb = wdia.shape[1]
        y = _embed(x * diag[None], pos, n_emb)
        xe = _embed(x, pos, n_emb)
    else:
        y = x * diag[None]
        xe = x
    for k, o in enumerate(offsets):
        y = y + wdia[k][None] * torch.roll(xe, -o, dims=-1)
    return y[..., pos] if pos is not None else y


def _lp(x, h, g):
    """½·Σ x·(h+g) — the pure-quadratic log-potential up to the constant
    (lp = c + ½·x·(h + g) with g = h − Jx)."""
    return 0.5 * torch.sum(x * (h[None] + g), dim=-1)


def _torch_dia_leapfrog(x, p, diag, offsets, wdia, h, inv_mass, eps,
                        n_steps: int):
    """Plain position-Verlet trajectory on a banded target. Returns
    ``(x1, p1, lp0, lp1)`` — endpoint log-potentials (sans constant)."""

    def matvec(x):
        return dia_matvec(x, diag, offsets, wdia)

    g0 = h[None] - matvec(x)
    lp0 = _lp(x, h, g0)
    if n_steps == 0:
        return x, p, lp0, lp0
    m = p + 0.5 * eps * g0
    for _ in range(n_steps - 1):
        x = x + eps * inv_mass[None] * m
        g = h[None] - matvec(x)
        m = m + eps * g
    x = x + eps * inv_mass[None] * m
    g1 = h[None] - matvec(x)
    p1 = m + 0.5 * eps * g1
    return x, p1, lp0, _lp(x, h, g1)


def _around_pos(run, x, p, diag, offsets, wdia, h, inv_mass, eps,
                n_steps: int, pos):
    """``run`` (a trajectory on EMBEDDED rows) on latent rows: ``pos``
    embeds once around the whole trajectory; evidence lanes are inert
    there (diag = h = im = 0) and lp is embedding-invariant."""
    if pos is not None:
        n_emb = wdia.shape[1]
        x, p, diag, h, inv_mass = (_embed(a, pos, n_emb)
                                   for a in (x, p, diag, h, inv_mass))
    x1, p1, lp0, lp1 = run(x, p, diag, offsets, wdia, h, inv_mass, eps,
                           n_steps)
    if pos is not None:
        x1, p1 = x1[..., pos], p1[..., pos]
    return x1, p1, lp0, lp1


def _plain_dia_quad_leapfrog(x, p, diag, offsets, wdia, h, inv_mass, eps,
                             n_steps: int, pos=None):
    """The plain version of :func:`dia_quad_leapfrog` on any device and
    dtype: ``_torch_dia_leapfrog`` with the same embedding around it."""
    return _around_pos(_torch_dia_leapfrog, x, p, diag, offsets, wdia, h,
                       inv_mass, eps, n_steps, pos)


class DiaLaunch(NamedTuple):
    """K2's and K6's launch geometry (``csrc/dia_traj.cuh``): a cluster of
    ``cluster`` blocks of ``threads`` threads splits the embedded row into
    slices of ``slice`` lanes and integrates ``chains`` chains at once in
    ``smem`` bytes of shared memory per block."""

    cluster: int
    threads: int
    chains: int
    slice: int
    smem: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dia_smem(K: int, chains: int, slice_: int, threads: int) -> int:
    """``csrc/dia_traj.cuh::smem_bytes``: per-warp, per-block and
    per-cluster (8 blocks at most) double partials, the slice's lane
    constants (diag, h, im, latent index and K weights) and two position
    buffers of ``chains`` floats a lane."""
    return (8 * chains * (2 * (threads // 32) + 2 + 2 * 8)
            + 4 * slice_ * (4 + K + 2 * chains))


@functools.lru_cache(maxsize=None)
def dia_launch(n_emb: int, K: int) -> DiaLaunch:
    """The geometry K2 and K6 run at ``n_emb`` embedded lanes and ``K``
    offsets: the most chains per block (8, 4, 2, 1), then the smallest
    cluster (1, 2, 4, 8 blocks), whose slice a block's threads cover with
    at most ``_REG_LANES`` lane-chain momenta each and whose shared memory
    fits ``DIA_SMEM_LIMIT``, with at most 512 threads a block. At the
    128×128 grid (16,384 lanes, K = 4): 8 chains, clusters of 8 blocks of
    512 threads, 2,048 lanes a block."""
    if n_emb > DIA_MAX_EMB:
        raise ValueError(f"n_emb {n_emb} exceeds DIA_MAX_EMB {DIA_MAX_EMB}")
    for chains in (8, 4, 2, 1):
        per = _REG_LANES // chains
        for cluster in (1, 2, 4, 8):
            slice_ = _round_up(-(-n_emb // cluster), 4)
            if slice_ > _MAX_THREADS * per:
                continue
            threads = min(_MAX_THREADS, _round_up(-(-slice_ // per), 32))
            smem = _dia_smem(K, chains, slice_, threads)
            if smem <= DIA_SMEM_LIMIT:
                return DiaLaunch(cluster, threads, chains, slice_, smem)
    raise ValueError(f"no K2/K6 geometry fits {n_emb} lanes, {K} offsets")


def _check_banded(name, x, offsets, wdia, inv):
    """(C, n, n_emb, K) of a kernel call on latent rows, or raise."""
    C, n = x.shape
    K = len(offsets)
    n_emb = n if inv is None else inv.shape[0]
    if n_emb > DIA_MAX_EMB:
        raise ValueError(f"n_emb {n_emb} exceeds DIA_MAX_EMB {DIA_MAX_EMB}")
    if K > 8:
        raise ValueError(f"{K} offsets; {name} takes at most 8")
    if inv is not None and (inv.dtype != torch.int64 or inv.device != x.device
                            or not inv.is_contiguous()):
        raise TypeError(f"{name}: inv must be a contiguous int64 tensor on "
                        f"{x.device}")
    return C, n, n_emb, K


def _inv_of(pos, n: int, n_emb: int):
    """The inverse embedding of ``pos`` on its device (``pos_to_inv``)."""
    inv = torch.full((n_emb,), n, dtype=torch.int64, device=pos.device)
    inv[pos] = torch.arange(n, dtype=torch.int64, device=pos.device)
    return inv


def _cuda_dia_leapfrog(x, p, diag, offsets, wdia, h, im, eps, n_steps: int,
                       inv=None):
    """Launch K6 on LATENT rows: x, p [C, n] → ``(x1, p1 [C, n], lp0, lp1
    [C])``; ``inv`` (int64 [n_emb]) is the inverse embedding, None for the
    identity."""
    C, n, n_emb, K = _check_banded("K6", x, offsets, wdia, inv)
    dev = x.device
    eps = eps_tensor(eps, dev)
    for name, t, shape in (("x", x, (C, n)), ("p", p, (C, n)),
                           ("diag", diag, (n,)), ("wdia", wdia, (K, n_emb)),
                           ("h", h, (n,)), ("inv_mass", im, (n,)),
                           ("eps", eps, ())):
        _check_f32(name, t, dev, shape)
    geo = dia_launch(n_emb, K)
    xo, po = torch.empty_like(x), torch.empty_like(p)
    lp0 = torch.empty((C,), dtype=torch.float32, device=dev)
    lp1 = torch.empty((C,), dtype=torch.float32, device=dev)
    offs = (ctypes.c_int * max(K, 1))(*offsets)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().lhvi_dia_leapfrog(
        x.data_ptr(), p.data_ptr(), diag.data_ptr(), wdia.data_ptr(),
        h.data_ptr(), im.data_ptr(), None if inv is None else inv.data_ptr(),
        eps.data_ptr(), xo.data_ptr(), po.data_ptr(), lp0.data_ptr(),
        lp1.data_ptr(), C, n, n_emb, K, ctypes.cast(offs, ctypes.c_void_p),
        int(n_steps), *geo, stream)
    _build.check(code, "dia_leapfrog")
    count("ops.k6.launches")
    return xo, po, lp0, lp1


def dia_quad_leapfrog(x, p, diag, offsets, wdia, h, inv_mass, eps,
                      n_steps: int, pos=None):
    """Batched leapfrog on a BANDED quadratic target.

    Returns ``(x1, p1, lp0, lp1)`` — endpoint positions/momenta plus the
    endpoint log-potentials WITHOUT the constant. ``pos`` (declaration-
    order embedding) is applied once around the whole trajectory.

    CUDA tensors go through kernel K6 (``csrc/dia_leapfrog.cu``;
    counter ``ops.k6.launches`` counts its launches), f32 only, at most
    ``DIA_MAX_EMB`` embedded lanes and 8 offsets; CPU tensors through the
    plain version ``_torch_dia_leapfrog``. ``n_steps == 0`` returns x and
    p unchanged and lp0 twice on both routes.
    """
    if x.is_cuda:
        inv = None if pos is None else _inv_of(pos, x.shape[-1],
                                               wdia.shape[1])
        return _cuda_dia_leapfrog(x, p, diag, offsets, wdia, h, inv_mass,
                                  eps, n_steps, inv=inv)
    if x.device.type != "cpu":
        raise NotImplementedError(f"dia_quad_leapfrog: no route for {x.device}")
    return _around_pos(_torch_dia_leapfrog, x, p, diag, offsets, wdia, h,
                       inv_mass, eps, n_steps, pos)


# XORed into K2's Philox key so that its counters, laid out (lane quad,
# chain, offset), never reproduce the bits of PyTorch's own Philox draws
# from the same generator, which share its seed.
_KEY_TAG = 0x5851F42D4C957F2D


def _kinetic(im, p):
    return 0.5 * torch.sum(im[None, :] * p * p, dim=-1)


def _momentum_std(im):
    """Per-lane momentum scale 1/√inv_mass; 0 at gap lanes (im = 0), so
    they draw zero momentum and stay inert end to end."""
    return torch.where(im > 0, torch.sqrt(1.0 / torch.clamp(im, min=1e-12)),
                       torch.zeros((), dtype=im.dtype, device=im.device))


def _cuda_dia_proposal(x, diag, offsets, wdia, h, im, eps, n_steps: int,
                       seed: int, offset: int, inv=None, p0=None, u=None):
    """Launch K2 on LATENT rows: x [C, n] → (x1 [C, n], log_acc [C]), with
    ``inv`` (int64 [n_emb]) the inverse embedding, None for the identity;
    diag, h and im are latent too (the kernel embeds them, and forms the
    momentum scale from im). ``p0`` (test mode, [C, n]) replaces the
    in-kernel momentum draw; otherwise momenta come from Philox keyed by
    ``seed`` with counter (lane quad, chain, ``offset``). log_acc is −inf
    where it is not finite. ``u`` ([C] uniforms) makes the kernel write
    the Metropolis-selected state instead of x1: x1 where
    ``log u < log_acc``, else x (counter ``ops.k2.selects``)."""
    C, n, n_emb, K = _check_banded("K2", x, offsets, wdia, inv)
    dev = x.device
    eps = eps_tensor(eps, dev)
    for name, t, shape in (("x", x, (C, n)), ("diag", diag, (n,)),
                           ("wdia", wdia, (K, n_emb)), ("h", h, (n,)),
                           ("inv_mass", im, (n,)), ("eps", eps, ())):
        _check_f32(name, t, dev, shape)
    if p0 is not None:
        _check_f32("p0", p0, dev, (C, n))
    if u is not None:
        _check_f32("u", u, dev, (C,))
    geo = dia_launch(n_emb, K)
    xo = torch.empty_like(x)
    log_acc = torch.empty((C,), dtype=torch.float32, device=dev)
    offs = (ctypes.c_int * max(K, 1))(*offsets)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().lhvi_dia_proposal(
        x.data_ptr(), diag.data_ptr(), wdia.data_ptr(), h.data_ptr(),
        im.data_ptr(), None if inv is None else inv.data_ptr(),
        None if p0 is None else p0.data_ptr(),
        None if u is None else u.data_ptr(), eps.data_ptr(),
        xo.data_ptr(), log_acc.data_ptr(), C, n, n_emb, K,
        ctypes.cast(offs, ctypes.c_void_p), int(n_steps),
        seed & (2**64 - 1), offset & (2**64 - 1), *geo, stream)
    _build.check(code, "dia_proposal")
    count("ops.k2.launches")
    if u is not None:
        count("ops.k2.selects")
    return xo, log_acc


def dia_hmc_proposal(gen, xc, diag, offsets, wdia, h, inv_mass, eps,
                     n_steps: int, pos=None, inv=None, p0=None,
                     select: bool = False, u=None):
    """One full HMC proposal on a banded target: sample momenta,
    integrate the whole trajectory, return ``(x1 [C, n], log_acc [C])``,
    log_acc −inf where it is not finite.

    ``select`` (or given uniforms ``u`` [C]) makes it the whole Metropolis
    step: the first output is then the next state, x1 where
    ``log u < log_acc`` and xc elsewhere. Without ``u`` the uniforms are
    drawn by ``torch.rand((C,), generator=gen)`` after the momenta, as a
    caller drawing them after the proposal would. On CUDA tensors K2 makes
    the select itself (it writes x0 back over the rejected chains' rows),
    so no [C, n] select runs after it.

    Everything between the momentum draw and the accept test runs in
    EMBEDDED coordinates (``pos`` and its inverse ``inv``); gap lanes get
    std 0 via their zero inv_mass.

    CUDA tensors go through kernel K2 (counter ``ops.k2.launches`` counts
    its launches) on the latent rows and latent diag, h and inv_mass: the
    kernel reads them through ``inv`` (once per launch for the constants),
    so no embedded copy is built on the host and a mass refresh in place
    is read by the next call. Momenta are drawn in-kernel from Philox keyed
    by ``gen.initial_seed()`` and ``gen``'s Philox offset, which the call
    advances as a draw of its own would, so consecutive proposals and
    consecutive runs on one generator get fresh momenta. Both are host
    values: no device value is read back. CPU tensors take the plain
    version: one gather each way through ``inv``, ``torch.randn`` momenta
    from ``gen``, then ``_torch_dia_leapfrog``. ``p0`` (latent
    coordinates, [C, n]) replaces the momentum draw on either route, so
    one trajectory can be compared exactly.
    """
    select = select or u is not None

    def uniforms():
        return u if u is not None else torch.rand(
            (xc.shape[0],), generator=gen, device=xc.device)

    if xc.is_cuda:
        seed = offset = 0
        if p0 is None:
            seed, offset = gen.initial_seed() ^ _KEY_TAG, gen.get_offset()
            gen.set_offset(offset + 4)  # CUDA offsets step in fours
        return _cuda_dia_proposal(
            xc.contiguous(), diag.contiguous(), offsets, wdia, h.contiguous(),
            inv_mass.contiguous(), eps, n_steps, seed, offset,
            inv=None if pos is None else inv,
            p0=None if p0 is None else p0.contiguous(),
            u=uniforms().contiguous() if select else None)
    if xc.device.type != "cpu":
        raise NotImplementedError(f"dia_hmc_proposal: no route for "
                                  f"{xc.device}")
    if pos is not None:
        x, diag, h, im = (_embed_gather(a, inv)
                          for a in (xc, diag, h, inv_mass))
        p0 = None if p0 is None else _embed_gather(p0, inv)
    else:
        x, im = xc, inv_mass
    if p0 is None:
        p0 = _momentum_std(im)[None, :] * torch.randn(
            x.shape, generator=gen, dtype=x.dtype)
    x1, p1, lp0, lp1 = _torch_dia_leapfrog(
        x, p0, diag, offsets, wdia, h, im, eps, n_steps)
    log_acc = torch.clamp((lp1 - lp0) + (_kinetic(im, p0)
                                         - _kinetic(im, p1)), max=0.0)
    log_acc = torch.where(torch.isfinite(log_acc), log_acc,
                          torch.full((), -math.inf))
    if pos is not None:
        x1 = x1[..., pos]
    if select:
        x1 = torch.where((torch.log(uniforms()) < log_acc)[:, None], x1, xc)
    return x1, log_acc
