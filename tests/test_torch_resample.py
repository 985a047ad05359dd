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


def _check(got, want, n):
    lwn, cum, z, ess = got
    np.testing.assert_allclose(lwn.numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(cum.numpy(), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_allclose(float(z), float(want[2]), atol=1e-5)
    np.testing.assert_allclose(float(ess), float(want[3]), rtol=1e-5)
    np.testing.assert_allclose(float(cum[-1]), 1.0, atol=1e-4)
    assert 1.0 - 1e-4 <= float(ess) <= n * (1 + 1e-4)


@pytest.mark.parametrize("n", [7, 128, 1000])
@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
def test_weight_pipeline_matches_reference(n, ref):
    lw = np.random.default_rng(0).normal(scale=3.0, size=n).astype(np.float32)
    if ref == "jnp":
        want = ref_rs._jnp_weight_pipeline(jnp.asarray(lw), n)
    else:
        with pltpu.force_tpu_interpret_mode():
            want = ref_rs._pallas_weight_pipeline(jnp.asarray(lw), n)
    before = rs.weight_pipeline.launches
    got = rs.weight_pipeline(torch.from_numpy(lw))
    assert rs.weight_pipeline.launches == before  # CPU: the plain version
    assert got[2].shape == () and got[3].shape == ()
    _check(got, want, n)


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
