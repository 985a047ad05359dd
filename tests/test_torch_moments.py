"""The moment and streamed-diagnostics update's dispatch rule on the CPU.

On a CUDA tensor ``hmc._stream_diag_update`` launches K7 and
``hmc._moment_sums`` K8 (``ops/moments.py``); on a CPU tensor both take
their plain twins and launch nothing. The CUDA branch of
``_stream_diag_update`` decides what K7 folds and passes the rest through,
which is held here against the twin with K7's op replaced by its contract
in ATen ops; the kernels are held to the twins on the card in
``tests/test_torch_cuda_kernels.py``.
"""

import pytest
import torch

import lhvi_tpu_torch as lt
from lhvi_tpu_torch.engines import hmc, nuts
from lhvi_tpu_torch.engines.resumable import sample_checkpointed
from lhvi_tpu_torch.models.toy import gaussian_grid
from lhvi_tpu_torch.ops import moments
from lhvi_tpu_torch.utils.metrics import counters

_KERNELS = ("ops.k7.launches", "ops.k8.launches")


@pytest.fixture(scope="module")
def grid6():
    g, _ = gaussian_grid(6, 6, seed=0, evidence_frac=0.2)
    return lt.compile_graph(g, "cpu")


def _query(engine, fg, tmp_path):
    gen = torch.Generator().manual_seed(0)
    kw = dict(n_chains=8, n_warmup=6, n_samples=20)
    if engine == "hmc":
        return hmc.run_hmc(fg, gen, hmc.HMCConfig(), collect="moments",
                           stream_diag=True, **kw)
    if engine == "nuts":
        return nuts.run_nuts(fg, gen, nuts.NUTSConfig(max_depth=3),
                             collect="moments", stream_diag=True, **kw)
    return sample_checkpointed(fg, gen, hmc.HMCConfig(), chunk_size=10,
                               ckpt_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("engine", ["hmc", "nuts", "checkpointed"])
def test_moment_stream_on_cpu_takes_the_plain_twins(grid6, tmp_path, engine):
    """Every draw of a moments query on CPU tensors is counted in
    ``hmc.draws`` and launches neither K7 nor K8."""
    before = counters()
    _query(engine, grid6, tmp_path)
    after = counters()
    assert after["hmc.draws"] - before["hmc.draws"] == 20
    for k in _KERNELS:
        assert after[k] == before[k]


def _stream(C, n, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((C, n), generator=g) + 3.0 for _ in range(S)]


def _plain_fold(xc, mean=None, m2=None, prev=None, cross=None,
                bm_cur=None, bm_mean=None, bm_m2=None, *, cnt=0, bm_len=0,
                batch_no=0):
    """``moments.stream_diag_update``'s contract in ATen ops, on any
    device: each part given is folded, ``None`` for each part not given."""
    out = [None] * 6
    if mean is not None:
        d = xc - mean
        out[0] = mean + d / float(cnt)
        out[1] = m2 + d * (xc - out[0])
    if cross is not None:
        out[2] = cross + xc * prev
    if bm_cur is not None:
        out[3] = bm_cur + xc
        if bm_mean is not None:
            b = out[3] / bm_len
            d = b - bm_mean
            out[4] = bm_mean + d / float(batch_no)
            out[5] = bm_m2 + d * (b - out[4])
            out[3] = torch.zeros_like(out[3])
    return tuple(out)


@pytest.mark.parametrize("S", [200, 201, 28, 3, 2, 1])
def test_fused_stream_diag_branch_is_the_twins(S, monkeypatch):
    """The CUDA branch's decision, with K7's op replaced by its contract in
    ATen ops, over a whole stream (both halves, the odd tail draw, every
    batch boundary, no batches at all): at every draw the accumulators it
    writes anew are those the plain twin writes anew, bit for bit, the
    rest are passed through, ``prev`` is the draw, and every batch closes
    once."""
    calls = []

    def fold(*a, **kw):
        calls.append(kw["batch_no"])
        return _plain_fold(*a, **kw)

    monkeypatch.setattr(moments, "stream_diag_update", fold)
    half = S // 2
    bm_len, n_batches = hmc._bm_schedule(S)
    a = b = hmc._stream_diag_init(3, 5, "cpu")
    for t, xc in enumerate(_stream(3, 5, S)):
        na = hmc._fused_stream_diag_update(a, t, xc, half, bm_len, n_batches)
        nb = hmc._plain_stream_diag_update(b, t, xc, half, bm_len,
                                           n_batches)
        assert ([p is q for p, q in zip(na, a)]
                == [p is q for p, q in zip(nb, b)]), t
        assert na.prev is xc
        for p, q in zip(na, nb):
            assert torch.equal(p, q), t
        a, b = na, nb
    assert len(calls) == S
    assert [c for c in calls if c] == list(range(1, n_batches + 1))


def test_cpu_tensors_take_the_plain_twins_bitwise():
    """``_stream_diag_update`` and ``_moment_sums`` on CPU tensors are
    their twins, bit for bit, over a stream with batches."""
    S, half = 29, 14
    bm_len, n_batches = hmc._bm_schedule(S)
    a = b = hmc._stream_diag_init(4, 7, "cpu")
    s1 = s2 = r1 = r2 = torch.zeros(7)
    for t, xc in enumerate(_stream(4, 7, S, seed=1)):
        a = hmc._stream_diag_update(a, t, xc, half, bm_len, n_batches)
        b = hmc._plain_stream_diag_update(b, t, xc, half, bm_len, n_batches)
        s1, s2 = hmc._moment_sums(s1, s2, xc)
        r1, r2 = hmc._plain_moment_sums(r1, r2, xc)
    for x, y in zip((*a, s1, s2), (*b, r1, r2)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("C,n,aligned", [(1024, 15600, True),
                                         (16384, 15600, True), (3, 17, True),
                                         (1, 1, True), (64, 4096, False),
                                         (5, 100_003, True)])
def test_moment_kernel_geometries_cover_the_arrays(C, n, aligned):
    """K7's grid-stride loop has at least one block and at most eight an
    SM, float4 only where aligned; K8's column tiles cover the row exactly
    once (the launcher refuses anything else), float4 only where the row
    is a multiple of 4."""
    sms = 132
    g7 = moments.k7_launch(C * n, aligned, sms)
    assert g7.vec == (4 if aligned else 1)
    assert 1 <= g7.grid <= moments.K7_BLOCKS_PER_SM * sms
    vectors = max(C * n // g7.vec, 1)
    assert (g7.grid == moments.K7_BLOCKS_PER_SM * sms
            or g7.grid * g7.threads >= vectors)
    assert (g7.grid - 1) * g7.threads < vectors  # no block without work
    g8 = moments.k8_launch(n, aligned)
    w = moments.K8_LANES * g8.vec
    assert g8.vec == (4 if aligned and n % 4 == 0 else 1)
    assert (g8.grid - 1) * w < n <= g8.grid * w
    assert g8.threads % moments.K8_LANES == 0
    if (C, n) == (1024, 15600):
        assert (g8.vec, g8.grid) == (4, 488)
