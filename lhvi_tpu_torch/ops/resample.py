"""The SMC weight pipeline and systematic resampling (PyTorch port of
``lhvi_tpu/ops/resample.py``).

Every SMC temperature runs a chain of small [N]-shaped steps between the
big state arrays: log-weight max, exp, normalization, ESS and the
cumulative sum the resampler searches. ``weight_pipeline`` runs them all
in ONE launch of kernel K4 (``csrc/weights.cu``) on CUDA tensors, and the
plain version ``_torch_weight_pipeline`` on CPU tensors; there is no other
route. ``searchsorted`` and the parent gather stay outside the kernel, as
in the reference.
"""

from __future__ import annotations

import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.ops.leapfrog import _check_f32


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


def _cuda_weight_pipeline(log_w):
    (n,) = log_w.shape
    dev = log_w.device
    _check_f32("log_w", log_w, dev, (n,))
    lwn = torch.empty_like(log_w)
    cum = torch.empty_like(log_w)
    stats = torch.empty((2,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().lhvi_weight_pipeline(
        log_w.data_ptr(), lwn.data_ptr(), cum.data_ptr(), stats.data_ptr(),
        n, stream)
    _build.check(code, "weight_pipeline")
    weight_pipeline.launches += 1
    return lwn, cum, stats[0], stats[1]


def weight_pipeline(log_w):
    """(log_w unnormalized [N]) → (lw_norm [N], cum [N], step_z, ess).

    ``cum`` is the inclusive cumulative of the normalized weights — feed it
    to :func:`systematic_parents`. ``step_z`` and ``ess`` are 0-d tensors on
    ``log_w``'s device. CUDA tensors go through kernel K4
    (``weight_pipeline.launches`` counts its launches); CPU tensors through
    the plain version.
    """
    if log_w.is_cuda:
        return _cuda_weight_pipeline(log_w)
    if log_w.device.type != "cpu":
        raise NotImplementedError(f"weight_pipeline: no route for {log_w.device}")
    return _torch_weight_pipeline(log_w)


weight_pipeline.launches = 0


def systematic_parents(u0, cum, n: int):
    """Parent indices i64 [n] from a cumulative-weight vector and one
    uniform ``u0`` (a 0-d tensor on ``cum``'s device, so no host read):
    positions (k + u0)/n, binary search, clipped into range."""
    pos = (torch.arange(n, dtype=cum.dtype, device=cum.device) + u0) / n
    idx = torch.searchsorted(cum, pos)
    return torch.clamp(idx, 0, cum.shape[0] - 1)
