"""The port's SMC weight pipeline and systematic resampler held to the JAX
reference on identical inputs.

The plain version of kernel K4 (``_torch_weight_pipeline``, which the
wrapper runs on CPU tensors) is compared with the reference's jnp pipeline
and with its Pallas kernel run through the Pallas TPU interpreter, as
``tests/test_resample_kernel.py`` runs it, at the tolerances of that file.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lhvi_tpu.ops import resample as ref_rs  # noqa: E402

from lhvi_tpu_torch.ops import resample as rs  # noqa: E402
from lhvi_tpu_torch.utils.metrics import counters  # noqa: E402


def _check(got, want, n):
    lwn, cum, z, ess = got
    np.testing.assert_allclose(lwn.numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(cum.numpy(), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_allclose(float(z), float(want[2]), atol=1e-5)
    np.testing.assert_allclose(float(ess), float(want[3]), rtol=1e-5)
    np.testing.assert_allclose(float(cum[-1]), 1.0, atol=1e-4)
    assert 1.0 - 1e-4 <= float(ess) <= n * (1 + 1e-4)


def _edge_weights(case):
    """Log-weights that reach the pipeline's edges: entries at -inf (zero
    weight), one dominant weight (ESS → 1), and N = 129 (one past a
    128-lane row of the reference's tiling)."""
    rng = np.random.default_rng(3)
    if case == "neg_inf":
        lw = rng.normal(scale=3.0, size=300).astype(np.float32)
        lw[::7] = -np.inf
        lw[100:160] = -np.inf
    elif case == "dominant":
        lw = rng.normal(size=500).astype(np.float32)
        lw[123] = 60.0
    else:
        lw = rng.normal(scale=3.0, size=129).astype(np.float32)
    return lw


@pytest.mark.parametrize("n", [7, 128, 1000])
@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
def test_weight_pipeline_matches_reference(n, ref):
    lw = np.random.default_rng(0).normal(scale=3.0, size=n).astype(np.float32)
    _reference_case(lw, ref)


@pytest.mark.parametrize("case", ["neg_inf", "dominant", "n129"])
@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
def test_weight_pipeline_edges_match_reference(case, ref):
    lw = _edge_weights(case)
    got = _reference_case(lw, ref)
    if case == "neg_inf":  # zero weights: lwn -inf, cum flat across them
        dead = np.flatnonzero(~np.isfinite(lw[1:])) + 1
        assert np.all(np.isneginf(got[0].numpy()[dead]))
        np.testing.assert_array_equal(got[1].numpy()[dead],
                                      got[1].numpy()[dead - 1])
    if case == "dominant":
        np.testing.assert_allclose(float(got[3]), 1.0, atol=1e-6)


def _reference_case(lw, ref):
    n = lw.shape[0]
    if ref == "jnp":
        want = ref_rs._jnp_weight_pipeline(jnp.asarray(lw), n)
    else:
        with pltpu.force_tpu_interpret_mode():
            want = ref_rs._pallas_weight_pipeline(jnp.asarray(lw), n)
    before = counters()["ops.k4.launches"]
    got = rs.weight_pipeline(torch.from_numpy(lw))
    assert counters()["ops.k4.launches"] == before  # CPU: the plain version
    assert got[2].shape == () and got[3].shape == ()
    _check(got, want, n)
    return got


def _k4_ranges(geo, n):
    """The [start, stop) of the weights each block owns, as
    ``csrc/weights.cu`` cuts them: cluster blocks of threads·per_thread;
    grid blocks of ceil(n / grid) rounded up to 4."""
    if geo.layout == "cluster":
        R = geo.threads * geo.per_thread
    else:
        R = (-(-n // geo.grid) + 3) // 4 * 4
    return [(min(n, b * R), min(n, (b + 1) * R)) for b in range(geo.grid)]


_K4_SMEM_BYTES = 968  # static shared memory of a block (csrc/weights.cu)

# K4's layout boundaries: one block up to 1,024; a cluster of 256-, 512-
# and 1,024-thread blocks up to 16,384, 32,768 and 65,536 (4 weights a
# thread), then 8 and 16 weights a thread up to 131,072 and 262,144; the
# grid past it
_K4_BOUNDS = [b + d for b in (1024, 16384, 32768, 65536, 131072, 262144)
              for d in (-1, 0, 1)]


@pytest.mark.parametrize("n", sorted(set(
    [1, 2, 31, 32, 33, 4095, 4096, 4097, 100003]
    + _K4_BOUNDS + [2**26])))
def test_k4_launch_geometry(n):
    """K4's geometry covers N exactly once, fits the card (227 KB of shared
    memory, 255 registers a thread, 65,536 an SM, clusters of at most 16
    blocks of at most 1,024 threads) and takes the grid layout only past
    the cluster's capacity."""
    sms = 132
    geo = rs.k4_launch(n, sms)
    ranges = _k4_ranges(geo, n)
    assert len(ranges) == geo.grid
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # disjoint
    assert _K4_SMEM_BYTES <= 227 * 1024
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
    assert 2 * geo.per_thread <= 255  # a thread's weights and their exps
    assert geo.per_thread % 4 == 0    # whole 16-byte loads
    if geo.layout == "cluster":
        assert n <= rs.K4_CLUSTER_MAX_N
        assert 1 <= geo.cluster == geo.grid <= rs.K4_MAX_CLUSTER
        assert geo.scratch == 0
        # each thread's run of per_thread weights, once each, no empty block
        per_block = geo.threads * geo.per_thread
        assert geo.cluster * per_block >= n > (geo.cluster - 1) * per_block
        assert all(b - a <= per_block for a, b in ranges)
        assert geo.threads * 2 * geo.per_thread <= 65536
        E = min(e for e in rs.K4_PER_THREAD
                if n <= rs.K4_MAX_CLUSTER * rs.K4_BLOCK_THREADS[-1] * e)
        assert geo.per_thread == E
        if n <= 1024:  # one block, the fewest warps a power of two covers
            assert geo.cluster == 1 and geo.threads < 2 * max(32, n / 4)
        else:  # the fewest threads a block that let 16 blocks hold n
            assert geo.threads == min(t for t in rs.K4_BLOCK_THREADS
                                      if n <= rs.K4_MAX_CLUSTER * t * E)
    else:
        assert n > rs.K4_CLUSTER_MAX_N
        assert geo.cluster == 1 and geo.per_thread == rs.K4_GRID_PER_THREAD
        assert geo.grid == sms * rs.K4_GRID_BLOCKS_PER_SM
        assert geo.scratch == 6 * geo.grid + 2  # 3 doubles a block + barrier
        assert all(a % 4 == 0 for a, _ in ranges)  # 16-byte aligned starts
    if n <= 300000:  # the element-by-element owner count
        own = np.zeros(n, dtype=np.int64)
        for a, b in ranges:
            own[a:b] += 1
        assert np.all(own == 1)


def test_k4_launch_rejects_empty():
    with pytest.raises(ValueError):
        rs.k4_launch(0)


def test_weight_pipeline_hand_math():
    lw = torch.tensor([0.0, float(np.log(3.0)), 0.0])  # weights ∝ [1, 3, 1]
    lwn, cum, z, ess = rs.weight_pipeline(lw)
    w = np.array([0.2, 0.6, 0.2])
    np.testing.assert_allclose(np.exp(lwn.numpy()), w, rtol=1e-6)
    np.testing.assert_allclose(cum.numpy(), np.cumsum(w), rtol=1e-6)
    np.testing.assert_allclose(float(z), np.log(5.0), rtol=1e-6)
    np.testing.assert_allclose(float(ess), 1.0 / np.sum(w * w), rtol=1e-6)


@pytest.mark.parametrize("n", [7, 512])
def test_systematic_parents_match_reference(n):
    """The same cumulative weights and the same u0 (the reference's draw
    from its key) give identical parent indices, and offspring counts
    track n·w within ±1."""
    lw = np.random.default_rng(1).normal(size=n).astype(np.float32)
    lwn, cum_r, _, _ = ref_rs._jnp_weight_pipeline(jnp.asarray(lw), n)
    key = jax.random.PRNGKey(7)
    want = np.asarray(ref_rs.systematic_parents(key, cum_r, n))
    u0 = torch.tensor(float(jax.random.uniform(key, ())))
    got = rs.systematic_parents(u0, torch.from_numpy(np.array(cum_r)), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    counts = np.bincount(got.numpy(), minlength=n)
    assert np.all(np.abs(counts - n * np.exp(np.asarray(lwn))) <= 1.0 + 1e-6)
