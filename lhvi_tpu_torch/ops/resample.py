"""The SMC weight pipeline and systematic resampling (PyTorch port of
``lhvi_tpu/ops/resample.py``).

Every SMC temperature runs a chain of small [N]-shaped steps between the
big state arrays: log-weight max, exp, normalization, ESS and the
cumulative sum the resampler searches. ``weight_pipeline`` runs them all
in ONE launch of kernel K4 (``csrc/weights.cu``) on CUDA tensors, and the
plain version ``_torch_weight_pipeline`` on CPU tensors; there is no other
route. Up to 262,144 weights one thread-block cluster holds the vector in
registers and reads it once; past that one cooperative grid does.
:func:`k4_launch` chooses the geometry. ``searchsorted`` and the parent
gather stay outside the kernel, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.ops.leapfrog import _check_f32, _round_up
from lhvi_tpu_torch.utils.metrics import count


def _torch_weight_pipeline(log_w):
    """Plain version of K4: (lw_norm, cum, step_z, ess)."""
    m = torch.max(log_w)
    w = torch.exp(log_w - m)
    s = torch.sum(w)
    step_z = m + torch.log(s)
    lwn = log_w - step_z
    wn = w / s
    ess = 1.0 / torch.sum(wn * wn)
    return lwn, torch.cumsum(wn, dim=0), step_z, ess


K4_MAX_CLUSTER = 16                  # blocks (past 8: non-portable)
K4_BLOCK_THREADS = (256, 512, 1024)  # threads of a cluster block
K4_PER_THREAD = (4, 8, 16)           # weights a thread holds in registers
K4_CLUSTER_MAX_N = K4_MAX_CLUSTER * K4_BLOCK_THREADS[-1] * K4_PER_THREAD[-1]
K4_GRID_THREADS = 512                # grid layout: threads of a block
K4_GRID_PER_THREAD = 4               # grid layout: weights a thread a chunk
K4_GRID_BLOCKS_PER_SM = 2            # __launch_bounds__(512, 2)


class K4Launch(NamedTuple):
    """K4's launch geometry (``csrc/weights.cu``).

    ``layout`` "cluster": one cluster of ``cluster`` blocks (``grid`` ==
    ``cluster``) of ``threads`` threads, thread t of block b holding the
    ``per_thread`` weights from (b·threads + t)·per_thread. "grid": one
    cooperative grid of ``grid`` blocks of ``threads`` threads, block b
    owning the weights from b·R (R = ceil(n / grid) rounded up to 4, so
    every range starts 16-byte aligned), ``per_thread`` weights a thread a
    chunk, and ``scratch`` floats of zeroed global scratch (a block's (max,
    Σw, Σw²) in doubles, then the barrier word)."""

    layout: str
    cluster: int
    threads: int
    per_thread: int
    grid: int
    scratch: int


def k4_launch(n: int, sms: int = 132) -> K4Launch:
    """The geometry K4 runs at for ``n`` weights on a card of ``sms`` SMs.
    Up to 262,144 weights, the cluster layout: the fewest weights a thread
    (4, 8, 16), then the fewest threads a block (256, 512, 1,024), that
    let 16 blocks hold n, and as many blocks as n needs; where one block
    holds n, the next power of two ≥ n/4 threads (at least a warp). Many
    small blocks beat a few large ones (``chip_smoke.py --profile``'s
    sweep): each SM loads, exponentiates and scans a smaller share. Past
    it: the grid layout, two 512-thread blocks an SM (all resident)."""
    if n < 1:
        raise ValueError(f"n={n}: K4 needs at least one weight")
    if n <= K4_CLUSTER_MAX_N:
        E = next(e for e in K4_PER_THREAD
                 if n <= K4_MAX_CLUSTER * K4_BLOCK_THREADS[-1] * e)
        T = next(t for t in K4_BLOCK_THREADS if n <= K4_MAX_CLUSTER * t * E)
        if n <= T * E:
            q = -(-n // E)
            return K4Launch("cluster", 1, max(32, 1 << (q - 1).bit_length()),
                            E, 1, 0)
        S = -(-n // (T * E))
        return K4Launch("cluster", S, T, E, S, 0)
    G = sms * K4_GRID_BLOCKS_PER_SM
    return K4Launch("grid", 1, K4_GRID_THREADS, K4_GRID_PER_THREAD, G,
                    6 * G + 2)


@functools.lru_cache(maxsize=256)
def _k4_geometry(n: int, device: int) -> K4Launch:
    return k4_launch(n, _build.sm_count(device))


def _k4_ptrs(log_w, lwn_ptr: int, cum_ptr: int, stats_ptr: int,
             geo: K4Launch, scratch=None):
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object, several microseconds of a call that lasts a few more
    code = _build.lib().lhvi_weight_pipeline(
        log_w.data_ptr(), lwn_ptr, cum_ptr, stats_ptr, log_w.shape[0],
        0 if geo.layout == "cluster" else 1, geo.cluster, geo.threads,
        geo.per_thread, geo.grid,
        None if scratch is None else scratch.data_ptr(),
        torch._C._cuda_getCurrentRawStream(log_w.device.index))
    _build.check(code, "weight_pipeline")


def _k4(log_w, lwn, cum, stats, geo: K4Launch, scratch=None):
    """One launch of K4 at ``geo`` into the given outputs (the launcher
    alone: no allocation, no count); raises if the launcher refuses."""
    _k4_ptrs(log_w, lwn.data_ptr(), cum.data_ptr(), stats.data_ptr(), geo,
             scratch)


def _cuda_weight_pipeline(log_w):
    # K4 runs once a temperature in a host-bound loop, so the wrapper keeps
    # its own host time small: one output buffer [lwn | cum] (cum starts
    # 16-byte aligned), its pointers by arithmetic, the geometry cached per
    # N and card. The stats have a buffer of their own: the engine keeps
    # every temperature's ess, and a view would keep that temperature's lwn
    # and cum alive with it.
    (n,) = log_w.shape
    dev = log_w.device
    _check_f32("log_w", log_w, dev, (n,))
    geo = _k4_geometry(n, dev.index)
    n4 = _round_up(n, 4)
    out = torch.empty((2 * n4,), dtype=torch.float32, device=dev)
    stats = torch.empty((2,), dtype=torch.float32, device=dev)
    scratch = (torch.zeros((geo.scratch,), dtype=torch.float32, device=dev)
               if geo.scratch else None)
    p = out.data_ptr()
    _k4_ptrs(log_w, p, p + 4 * n4, stats.data_ptr(), geo, scratch)
    count("ops.k4.launches")
    lwn, _, cum, _ = out.split_with_sizes([n, n4 - n, n, n4 - n])
    step_z, ess = stats.unbind()
    return lwn, cum, step_z, ess


def weight_pipeline(log_w):
    """(log_w unnormalized [N]) → (lw_norm [N], cum [N], step_z, ess).

    ``cum`` is the inclusive cumulative of the normalized weights — feed it
    to :func:`systematic_parents`. ``step_z`` and ``ess`` are 0-d tensors on
    ``log_w``'s device. CUDA tensors go through kernel K4
    (counter ``ops.k4.launches`` counts its launches); CPU tensors through
    the plain version.
    """
    if log_w.is_cuda:
        return _cuda_weight_pipeline(log_w)
    if log_w.device.type != "cpu":
        raise NotImplementedError(f"weight_pipeline: no route for {log_w.device}")
    return _torch_weight_pipeline(log_w)


def systematic_parents(u0, cum, n: int):
    """Parent indices i64 [n] from a cumulative-weight vector and one
    uniform ``u0`` (a 0-d tensor on ``cum``'s device, so no host read):
    positions (k + u0)/n, binary search, clipped into range."""
    pos = (torch.arange(n, dtype=cum.dtype, device=cum.device) + u0) / n
    idx = torch.searchsorted(cum, pos)
    return torch.clamp(idx, 0, cum.shape[0] - 1)
