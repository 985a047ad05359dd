"""Fused NUTS trajectory for dense quadratic (information-form) targets
(PyTorch port of ``lhvi_tpu/ops/nuts_traj.py``).

One whole NUTS transition — leapfrog leaves, streaming multinomial
proposal, checkpoint-stack U-turn checks, subtree merges — for every chain
in ONE launch of kernel K3 (``csrc/nuts_traj.cu``). Unlike the reference's
TPU layout, chains do not run in lockstep: each stops at its own depth. A
warp (a block past n = 256) holds several chains at once so that each J
load serves all of them, and refills a slot from its own range of chains
as soon as that slot's chain is done; :func:`k3_launch` chooses the
geometry.

``nuts_trajectory`` launches K3 and takes CUDA tensors only; its plain
version is the engine's lockstep loop, ``engines.nuts._nuts_lockstep``,
and ``engines.nuts._nuts_sweep_batched`` chooses between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.ops.leapfrog import _check_f32, eps_tensor
from lhvi_tpu_torch.utils.metrics import count

# XORed into K3's Philox key so that its counters, laid out (chain, step,
# offset), never reproduce the bits of PyTorch's own Philox draws from the
# same generator, which share its seed (K2 uses a tag of its own).
_KEY_TAG = 0x2545F4914F6CDD1D


def momentum_std(inv_mass):
    """1/√inv_mass, as the reference draws p0 = std·N(0, 1)."""
    return torch.sqrt(1.0 / torch.clamp(inv_mass, min=1e-12))


def _check_uniforms(uniforms, max_depth: int, C: int, device):
    if uniforms is not None:
        _check_f32("uniforms", uniforms, device, (3, 1 << max_depth, C))


K3_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use
SM_SMEM = 228 * 1024        # shared memory of an SM (1 KB of it per block)
K3_MAX_N = 4096
K3_MAX_DEPTH = 20
K3_WARP_MAX_N = 256
K3_MAX_WARPS = 12           # 384 threads a block
K3_MIN_WARPS = 4            # fewer slots before fewer warps than this
K3_BLOCK_SLOTS = 8
K3_BLOCK_THREADS = 512
K3_ROWS = 5                 # far end q, p, g; proposal; subtree proposal


class K3Launch(NamedTuple):
    """K3's launch geometry (``csrc/nuts_traj.cu``).

    ``layout`` "warp": each warp holds ``slots`` chains at once, blocks of
    ``warps`` warps, ``smem`` bytes of shared memory (each warp's sums,
    position tile and per-slot rows), ``grid`` blocks, each warp refilling
    its slots from a contiguous range of chains. "block": a block of 16
    warps holds 8 chains and streams J through two stages of ``k_tile``
    rows."""

    layout: str
    slots: int
    warps: int
    smem: int
    grid: int
    k_tile: int


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def k3_stack_rows(max_depth: int) -> int:
    """Checkpoint rows a slot needs: the popcount of an even leaf index
    below 2^(max_depth − 1) is at most max_depth − 2, so max_depth − 1 rows
    (at least one)."""
    return max_depth - 1 if max_depth > 2 else 1


def k3_blocks_per_sm(np_: int, slots: int) -> int:
    """Blocks of the warp layout an SM holds by registers: two where a
    thread's slots × NP tile is at most 8 (``__launch_bounds__(384, 2)``, 85
    registers a thread), else one (168)."""
    return 2 if slots * np_ <= 8 else 1


def _k3_warp_bytes(n: int, M: int, R: int) -> int:
    """One warp of the warp layout (``warp_bytes`` in the kernel): 2M
    double sums, the [n][M] position tile, M × R rows of n floats."""
    return _round16(16 * M + 4 * n * M + 4 * M * R * n)


def _k3_block_bytes(n: int, kt: int) -> int:
    """The block layout (``block_bytes`` in the kernel): 17 × 16 double
    sums, 8 ballot words, the [n][8] position tile, two J stages of kt rows
    plus 4 floats of alignment slack."""
    stage = (kt * n + 4 + 3) // 4 * 4
    return (8 * 17 * 2 * K3_BLOCK_SLOTS + 4 * K3_BLOCK_SLOTS
            + 4 * n * K3_BLOCK_SLOTS + 8 * stage)


def k3_launch(n: int, max_depth: int, C: int, sms: int = 132) -> K3Launch:
    """The geometry K3 runs at for ``C`` chains of ``n`` coordinates and
    trees of ``max_depth`` on a card of ``sms`` SMs.

    n ≤ 256 takes the warp layout: 4 slots a warp up to NP = ceil(n/32) = 2,
    else 2 (q, p and g of every slot sit in registers), as many blocks an
    SM as the registers allow (``k3_blocks_per_sm``), then the most warps
    (≤ 12) whose shared memory fits that many blocks. A leaf is a chain
    of latencies (the sums, the keepers' uniforms and exp/log), so warps
    an SM count for more than J's reuse across slots. Where the per-slot
    rows of a deep tree leave fewer than 4 warps, one block an SM is tried,
    then half the slots; past one slot and one warp, or past n = 256, the
    block layout: 8 slots in 512 threads, J in the deepest k-tiles (≤ 32
    rows) whose two stages fit. Grids: one wave, never more blocks than
    the chains need. At the bench shape (n = 82, max_depth 4): 2 slots, 12
    warps, 94,848 bytes, two blocks an SM, 264 blocks."""
    if not 1 <= n <= K3_MAX_N:
        raise ValueError(f"n={n}: K3 takes 1..{K3_MAX_N} coordinates")
    if not 0 <= max_depth <= K3_MAX_DEPTH:
        raise ValueError(f"max_depth={max_depth}: K3 takes 0..{K3_MAX_DEPTH}")
    if C < 1:
        raise ValueError(f"C={C}: K3 needs at least one chain")
    R = K3_ROWS + 2 * k3_stack_rows(max_depth)
    if n <= K3_WARP_MAX_N:
        np_ = -(-n // 32)
        M = 4 if np_ <= 2 else 2
        while True:
            wb = _k3_warp_bytes(n, M, R)
            for b in range(k3_blocks_per_sm(np_, M), 0, -1):
                budget = min(K3_SMEM_LIMIT, SM_SMEM // b - 1024)
                W = min(K3_MAX_WARPS, budget // wb)
                if W >= K3_MIN_WARPS or (M == 1 and b == 1 and W >= 1):
                    return K3Launch("warp", M, W, W * wb,
                                    min(-(-C // (W * M)), sms * b), 0)
            if M == 1:
                break
            M //= 2
    kt = max(k for k in range(1, 33)
             if _k3_block_bytes(n, k) <= K3_SMEM_LIMIT)
    return K3Launch("block", K3_BLOCK_SLOTS, K3_BLOCK_THREADS // 32,
                    _k3_block_bytes(n, kt),
                    min(-(-C // K3_BLOCK_SLOTS), sms), kt)


def _cuda_nuts_traj(q0, p0, J, h, inv_mass, eps, max_depth: int,
                    seed: int = 0, offset: int = 0, uniforms=None):
    """Launch K3: → ``(q_prop [C, n], sum_acc [C], n_leaf [C] i32,
    depth [C] i32, diverged [C] bool)``. ``uniforms`` ([3, 2^max_depth, C],
    test mode) replaces the in-kernel Philox draws keyed by ``seed`` with
    counter (chain, step, ``offset``)."""
    C, n = q0.shape
    dev = q0.device
    eps = eps_tensor(eps, dev)
    for name, t, shape in (("q0", q0, (C, n)), ("p0", p0, (C, n)),
                           ("J", J, (n, n)), ("h", h, (n,)),
                           ("inv_mass", inv_mass, (n,)), ("eps", eps, ())):
        _check_f32(name, t, dev, shape)
    _check_uniforms(uniforms, max_depth, C, dev)
    geo = k3_launch(n, int(max_depth), C, _build.sm_count(dev))
    lib = _build.lib()
    qp = torch.empty_like(q0)
    sum_acc = torch.empty((C,), dtype=torch.float32, device=dev)
    n_leaf = torch.empty((C,), dtype=torch.int32, device=dev)
    depth = torch.empty((C,), dtype=torch.int32, device=dev)
    diverged = torch.empty((C,), dtype=torch.bool, device=dev)
    scratch = None
    if geo.layout == "block":
        scratch = torch.empty(
            (lib.lhvi_nuts_traj_scratch(geo.grid, n, int(max_depth)),),
            dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.lhvi_nuts_traj(
        q0.data_ptr(), p0.data_ptr(), J.data_ptr(), h.data_ptr(),
        inv_mass.data_ptr(), eps.data_ptr(),
        None if uniforms is None else uniforms.data_ptr(),
        qp.data_ptr(), sum_acc.data_ptr(), n_leaf.data_ptr(),
        depth.data_ptr(), diverged.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        C, n, int(max_depth), seed & (2**64 - 1), offset & (2**64 - 1),
        0 if geo.layout == "warp" else 1, geo.slots, geo.warps, geo.smem,
        geo.grid, geo.k_tile, stream)
    _build.check(code, "nuts_traj")
    count("ops.k3.launches")
    return qp, sum_acc, n_leaf, depth, diverged


def nuts_trajectory(fg, gen, xc, eps, inv_mass, max_depth: int,
                    uniforms=None):
    """One fused NUTS transition for all chains on a dense pure-quadratic
    target. Returns ``(q_prop [C, n], accept_stat [C], depth [C] i32,
    diverged [C] bool, n_leaf [C] i32)``, ``n_leaf`` the leaves each
    chain integrated until its tree stopped; nothing is read back to the
    host.

    Momenta ``p0 = std·N(0, 1)`` are the first draw from ``gen``, as in
    the reference; K3 (counter ``ops.k3.launches`` counts its launches)
    takes its uniforms from Philox keyed by ``gen.initial_seed()`` and
    ``gen``'s Philox offset, which the call advances as a draw of its own
    would. ``uniforms`` ([3, 2^max_depth, C]: the direction, leaf and
    merge uniforms by step) replaces those draws, so that the lockstep
    loop given the same table follows the same tree. Raises on a tensor
    that is not on a CUDA device.
    """
    if not xc.is_cuda:
        raise NotImplementedError(
            f"nuts_trajectory: K3 takes CUDA tensors, not {xc.device}")
    C, n = xc.shape
    p0 = momentum_std(inv_mass)[None, :] * torch.randn(
        (C, n), generator=gen, device=xc.device)
    seed = offset = 0
    if uniforms is None:
        seed, offset = gen.initial_seed() ^ _KEY_TAG, gen.get_offset()
        gen.set_offset(offset + 4)  # CUDA offsets step in fours
    qp, sum_acc, n_leaf, depth, div = _cuda_nuts_traj(
        xc.contiguous(), p0, fg.quad_J, fg.quad_h, inv_mass.contiguous(),
        eps, max_depth, seed, offset, uniforms)
    acc = sum_acc / torch.clamp(n_leaf, min=1).to(torch.float32)
    return qp, acc, depth, div, n_leaf
