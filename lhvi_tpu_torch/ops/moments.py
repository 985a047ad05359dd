"""The sampler's per-draw moment and streamed-diagnostics update on the card.

Every kept draw of ``run_hmc``, ``run_nuts`` and ``sample_checkpointed`` in
moments mode folds the chains' continuous state ``xc [C, n]`` into the
running sums of the mean and variance and, with ``stream_diag``, into nine
``[C, n]`` accumulators of split-R̂ and ESS (``engines/hmc.py``'s
``_MomentStream``). Two hand-written passes (``csrc/moments.cu``) do it,
each the CUDA branch of one engine function whose plain torch code is its
twin:

- K7, :func:`stream_diag_update`, behind ``hmc._stream_diag_update``: one
  launch reads ``xc`` and the accumulators the draw changes and writes
  them anew, bitwise equal to the twin; the engine decides which those are
  and passes them by role;
- K8, :func:`moment_sums`, behind ``hmc._moment_sums``: one read of ``xc``
  for both sums, over the chain axis in a fixed order.

Both are bound by bytes; neither replaces a Pallas kernel (the JAX package
leaves the stream to XLA's fusion). The wrappers take f32 contiguous CUDA
tensors and raise on anything else; :func:`k7_launch` and :func:`k8_launch`
choose the geometries.
"""

from __future__ import annotations

import functools
import operator
from typing import NamedTuple

import torch

from lhvi_tpu_torch.ops import _build
from lhvi_tpu_torch.ops.leapfrog import _check_f32
from lhvi_tpu_torch.utils.metrics import count

K7_THREADS = 256       # threads a block (csrc/moments.cu kDiagThreads)
K7_BLOCKS_PER_SM = 8   # the grid-stride loop's blocks an SM
K8_THREADS = 256       # csrc/moments.cu kSumThreads
K8_LANES = 8           # threads side by side along a row (kSumLanes)


class K7Launch(NamedTuple):
    """K7's geometry: ``vec`` elements a thread an iteration (4: float4
    loads and stores, every array 16-byte aligned; 1 otherwise), a
    grid-stride loop of ``grid`` blocks of ``threads``."""

    vec: int
    threads: int
    grid: int


class K8Launch(NamedTuple):
    """K8's geometry: a block of ``threads`` owns ``K8_LANES`` × ``vec``
    columns over every chain; ``grid`` blocks cover the row."""

    vec: int
    threads: int
    grid: int


def k7_launch(numel: int, aligned: bool, sms: int = 132) -> K7Launch:
    """K7 over ``numel`` elements on a card of ``sms`` SMs: float4 where
    ``aligned``, as many blocks as the vectors need up to
    ``K7_BLOCKS_PER_SM`` an SM (the rest by the grid-stride loop)."""
    vec = 4 if aligned else 1
    units = max(1, -(-max(numel // vec, 1) // K7_THREADS))
    return K7Launch(vec, K7_THREADS, min(units, K7_BLOCKS_PER_SM * sms))


def k8_launch(n: int, aligned: bool) -> K8Launch:
    """K8 over rows of ``n`` columns: float4 where ``n % 4 == 0`` and the
    array is ``aligned``, one block a tile of ``K8_LANES`` × ``vec``
    columns (488 blocks at the grid cells' 15,600 latents)."""
    vec = 4 if aligned and n % 4 == 0 else 1
    return K8Launch(vec, K8_THREADS, -(-n // (K8_LANES * vec)))


@functools.lru_cache(maxsize=64)
def _k7_geometry(numel: int, aligned: bool, device: int) -> K7Launch:
    return k7_launch(numel, aligned, _build.sm_count(device))


def _check(names, tensors, device, shape):
    # one combined test a tensor on the path every draw takes; the
    # message comes from _check_f32
    for name, t in zip(names, tensors):
        if (t.dtype != torch.float32 or t.shape != shape
                or t.device != device or not t.is_contiguous()):
            _check_f32(name, t, device, tuple(shape))


def stream_diag_update(xc, mean=None, m2=None, prev=None, cross=None,
                       bm_cur=None, bm_mean=None, bm_m2=None, *, cnt: int = 0,
                       bm_len: int = 0, batch_no: int = 0) -> tuple:
    """K7: fold one draw ``xc [C, n]`` into the accumulators given, each of
    ``xc``'s shape (the pass is elementwise), and return
    ``(mean, m2, cross, bm_cur, bm_mean, bm_m2)`` after it, fresh tensors,
    ``None`` for each part not given:

    - ``mean``, ``m2``: a Welford pair, ``xc`` its ``cnt``-th draw;
    - ``prev``, ``cross``: ``cross + xc · prev``;
    - ``bm_cur``: ``bm_cur + xc``, the sum of the current batch of
      ``bm_len`` draws;
    - ``bm_mean``, ``bm_m2`` (with ``bm_cur``): the batch closes here, its
      mean folded into this Welford pair as batch ``batch_no`` and the sum
      returned as zeros.

    Each element is the plain ``hmc._plain_stream_diag_update``'s sequence
    of f32 operations, so the results are its bits. One launch, none where
    no part is given. Counted as ``ops.k7.launches``."""
    parts = {"mean": mean, "m2": m2, "prev": prev, "cross": cross,
             "bm_cur": bm_cur, "bm_mean": bm_mean, "bm_m2": bm_m2}
    pair, lag = mean is not None, cross is not None
    bm, edge = bm_cur is not None, bm_mean is not None
    if ((pair and (m2 is None or cnt < 1)) or (lag and prev is None)
            or (bm and bm_len < 1)
            or (edge and (not bm or bm_m2 is None or batch_no < 1))):
        raise ValueError("stream_diag_update: a part is given without what "
                         "it needs")
    given = {k: v for k, v in parts.items() if v is not None}
    if not given:
        return (None,) * 6
    _check(("xc", *given), (xc, *given.values()), xc.device, xc.shape)

    def fresh(on):
        return torch.empty_like(xc) if on else None

    outs = (fresh(pair), fresh(pair), fresh(lag), fresh(bm), fresh(edge),
            fresh(edge))
    numel = xc.numel()
    if numel == 0:
        return outs

    def ptr(t):
        return None if t is None else t.data_ptr()

    ins = [ptr(t) for t in (prev, mean, m2, cross, bm_cur, bm_mean, bm_m2)]
    out_ptrs = [ptr(t) for t in outs]
    x = xc.data_ptr()
    # float4 only if every array starts on a 16-byte boundary
    low = functools.reduce(operator.or_, (p for p in ins + out_ptrs if p), x)
    geo = _k7_geometry(numel, not low & 15, xc.device.index)
    code = _build.lib().lhvi_stream_diag(
        x, *ins, *out_ptrs, numel, cnt, bm_len, batch_no, geo.vec,
        geo.threads, geo.grid,
        torch._C._cuda_getCurrentRawStream(xc.device.index))
    _build.check(code, "stream_diag_update")
    count("ops.k7.launches")
    return outs


def moment_sums(s1, s2, xc) -> tuple:
    """K8: ``(s1 + Σ_c xc, s2 + Σ_c xc²)`` for ``xc [C, n]`` and ``s1``,
    ``s2 [n]``, as ``hmc._plain_moment_sums``, in fresh tensors: one read
    of ``xc``, each column summed over the chains in double in a fixed
    order (bitwise repeatable) and rounded once before it is added.
    Counted as ``ops.k8.launches``."""
    if xc.dim() != 2:
        raise ValueError(f"xc must be [C, n], got {tuple(xc.shape)}")
    C, n = xc.shape
    dev = xc.device
    _check(("xc",), (xc,), dev, xc.shape)
    _check(("s1", "s2"), (s1, s2), dev, (n,))
    s1_out, s2_out = torch.empty_like(s1), torch.empty_like(s2)
    if n == 0:
        return s1_out, s2_out
    x = xc.data_ptr()
    geo = k8_launch(n, not x & 15)
    code = _build.lib().lhvi_moment_sums(
        x, s1.data_ptr(), s2.data_ptr(), s1_out.data_ptr(), s2_out.data_ptr(),
        C, n, geo.vec, geo.threads, geo.grid,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(code, "moment_sums")
    count("ops.k8.launches")
    return s1_out, s2_out
