"""The benchmark's BASELINE config 2 grid (``portbench/configs/
gauss_grid10.json``): its plain reference rebuilds the program's dense
information form, and the program's NUTS answers agree with the
reference's exact posterior on the CPU's lockstep loop."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.registry import Registry

REG = Registry()


def _cfg(**kw):
    cfg = REG.json("configs", "gauss_grid10")
    return dict(cfg, **kw)


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_reference_information_form_is_the_programs(seed):
    """For the configuration's inputs (82 latents on every seed), the
    reference's dense (J_LL, h_L) equals ``compile_graph``'s ``quad_J`` and
    ``quad_h`` (the dense form: no ELL, no bands) to float32 rounding, with
    the latents matched through the build's layout."""
    ref = REG.module("reference", "gauss_grid10")
    model = REG.module("models", "gauss_grid10")
    cfg = _cfg()
    inputs = ref.make_inputs(cfg, seed)
    built = model.build(cfg, inputs, "cpu")
    fg, layout = built["fg"], built["layout"]
    assert fg.n_cont == cfg["n_latent"] == 82 and not fg.quad_sparse
    J, h = ref.information_form(cfg, inputs)
    Jp = fg.meta.np_global["quad_J"].astype(np.float64)
    hp = fg.meta.np_global["quad_h"].astype(np.float64)
    np.testing.assert_allclose(Jp[np.ix_(layout, layout)], J, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(hp[layout], h, rtol=1e-6, atol=1e-6)
    mean, var = ref.posterior(cfg, inputs)
    np.testing.assert_allclose(J @ mean, h, atol=1e-10)
    assert (var > 0).all()


def test_reference_exact_draws_meet_the_posterior():
    """The control's exact draws in float64 give the exact moments within
    five standard errors of i.i.d. draws."""
    ref = REG.module("reference", "gauss_grid10")
    cfg = _cfg()
    inputs = ref.make_inputs(cfg, 5)
    mean, var = ref.posterior(cfg, inputs)
    C, S = 512, 40
    m, v, diag = ref.exact_moments(cfg, inputs, C, 0, S, seed=1,
                                   dtype=torch.float64)
    assert np.all(np.abs(m - mean) <= 5 * np.sqrt(var / (C * S)))
    assert np.all(np.abs(v / var - 1) <= 5 * math.sqrt(2 / (C * S)))
    assert np.all(np.abs(diag["rhat"] - 1) < 0.02)


def test_run_nuts_on_a_4x4_copy_agrees_with_the_exact_posterior():
    """``run_nuts`` on the CPU (the lockstep loop, K3's plain twin) on a
    seeded 4 × 4 copy of the configuration: every latent's mean within 5
    Monte Carlo standard errors of the exact one and every variance within
    5 of its relative standard error, at an integrated autocorrelation
    time of 3 draws (NUTS on this target mixes faster), and the streamed
    split-R̂ within 0.05 of 1."""
    from lhvi_tpu_torch.engines import nuts

    ref = REG.module("reference", "gauss_grid10")
    model = REG.module("models", "gauss_grid10")
    cfg = _cfg(rows=4, cols=4, n_observed=3, n_latent=13)
    inputs = ref.make_inputs(cfg, 7)
    built = model.build(cfg, inputs, "cpu")
    mean, var = ref.posterior(cfg, inputs)
    C, S, tau = 128, 300, 3.0
    moments, _, diag = nuts.run_nuts(
        built["fg"], torch.Generator().manual_seed(3),
        nuts.NUTSConfig(max_depth=5, init_step_size=0.12), n_chains=C,
        n_warmup=200, n_samples=S, collect="moments")
    lay = built["layout"]
    m = moments["mean"].double().numpy()[lay]
    v = moments["var"].double().numpy()[lay]
    n_eff = C * S / tau
    assert np.all(np.abs(m - mean) <= 5 * np.sqrt(var / n_eff)), (m - mean)
    assert np.all(np.abs(v / var - 1) <= 5 * math.sqrt(2 / n_eff)), v / var
    assert np.all(np.abs(diag["rhat"].numpy() - 1) < 0.05)
