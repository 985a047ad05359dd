"""Fused NUTS trajectory for dense quadratic (information-form) targets
(PyTorch port of ``lhvi_tpu/ops/nuts_traj.py``).

One whole NUTS transition — leapfrog leaves, streaming multinomial
proposal, checkpoint-stack U-turn checks, subtree merges — for every chain
in ONE launch of kernel K3 (``csrc/nuts_traj.cu``). Unlike the reference's
TPU layout, chains do not run in lockstep: each stops at its own depth.

``nuts_trajectory`` launches K3 for CUDA tensors and runs the plain
version, ``engines.nuts._nuts_lockstep``, for CPU tensors; there is no
other route.
"""

from __future__ import annotations

import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.ops.leapfrog import _check_f32, eps_tensor

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


def _cuda_nuts_traj(q0, p0, J, h, inv_mass, eps, max_depth: int,
                    seed: int = 0, offset: int = 0, uniforms=None):
    """Launch K3: → ``(q_prop [C, n], sum_acc [C], n_leaf [C] i32,
    depth [C] i32, diverged [C] bool)``. ``uniforms`` ([3, 2^max_depth, C],
    test mode) replaces the in-kernel Philox draws keyed by ``seed`` with
    counter (chain, step, ``offset``)."""
    C, n = q0.shape
    dev = q0.device
    eps = eps_tensor(eps, dev)
    if n > 4096:
        raise ValueError(f"n={n}: K3 takes at most 4,096 coordinates")
    if not 0 <= max_depth <= 20:
        raise ValueError(f"max_depth={max_depth}: K3 takes 0..20")
    for name, t, shape in (("q0", q0, (C, n)), ("p0", p0, (C, n)),
                           ("J", J, (n, n)), ("h", h, (n,)),
                           ("inv_mass", inv_mass, (n,)), ("eps", eps, ())):
        _check_f32(name, t, dev, shape)
    _check_uniforms(uniforms, max_depth, C, dev)
    lib = _build.lib()
    qp = torch.empty_like(q0)
    sum_acc = torch.empty((C,), dtype=torch.float32, device=dev)
    n_leaf = torch.empty((C,), dtype=torch.int32, device=dev)
    depth = torch.empty((C,), dtype=torch.int32, device=dev)
    diverged = torch.empty((C,), dtype=torch.bool, device=dev)
    n_scratch = lib.lhvi_nuts_traj_scratch(C, n, int(max_depth))
    scratch = (torch.empty((n_scratch,), dtype=torch.float32, device=dev)
               if n_scratch > 0 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.lhvi_nuts_traj(
        q0.data_ptr(), p0.data_ptr(), J.data_ptr(), h.data_ptr(),
        inv_mass.data_ptr(), eps.data_ptr(),
        None if uniforms is None else uniforms.data_ptr(),
        qp.data_ptr(), sum_acc.data_ptr(), n_leaf.data_ptr(),
        depth.data_ptr(), diverged.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        C, n, int(max_depth), seed & (2**64 - 1), offset & (2**64 - 1),
        stream)
    _build.check(code, "nuts_traj")
    nuts_trajectory.launches += 1
    return qp, sum_acc, n_leaf, depth, diverged


def nuts_trajectory(fg, gen, xc, eps, inv_mass, max_depth: int,
                    uniforms=None):
    """One fused NUTS transition for all chains on a dense pure-quadratic
    target. Returns ``(q_prop [C, n], accept_stat [C], depth [C] i32,
    diverged [C] bool)``; nothing is read back to the host.

    Momenta ``p0 = std·N(0, 1)`` are the first draw from ``gen``, as in
    the reference. CUDA tensors then go through K3
    (``nuts_trajectory.launches`` counts its launches), whose uniforms come
    from Philox keyed by ``gen.initial_seed()`` and ``gen``'s Philox
    offset, which the call advances as a draw of its own would. CPU tensors
    go through the plain version. ``uniforms`` ([3, 2^max_depth, C]: the
    direction, leaf and merge uniforms by step) replaces the uniform draws
    on either route, so both follow the same tree.
    """
    if xc.is_cuda:
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
        return qp, acc, depth, div
    if xc.device.type != "cpu":
        raise NotImplementedError(f"nuts_trajectory: no route for {xc.device}")
    from lhvi_tpu_torch.engines.nuts import _nuts_sweep_batched

    return _nuts_sweep_batched(fg, gen, xc, None, eps, inv_mass, max_depth,
                               traj_kernel=False, uniforms=uniforms)


nuts_trajectory.launches = 0
