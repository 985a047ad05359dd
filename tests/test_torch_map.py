"""The port's hybrid MaxWalkSAT (``lhvi_tpu_torch/engines/map_search.py``)
held to the JAX reference (``lhvi_tpu/engines/map_search.py``) on the CPU.

Deterministic: the energies (log-probabilities) of given walkers and the
greedy branch from given states, against the reference's own pieces
(``log_prob`` under ``vmap``, ``disc_logits`` with ``select_last``,
``jax.grad`` of ``log_prob``), rtol 1e-5. Statistical: the search's
answers against exact modes at tests/test_nuts_map.py:44-70's thresholds.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.ops.select import select_last  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
from lhvi_tpu_torch.engines.map_search import (  # noqa: E402
    HybridMaxWalkSAT,
    MWSConfig,
    greedy_step,
)
from lhvi_tpu_torch.potentials import GaussianPotential  # noqa: E402
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402

from test_torch_compile import _rand_ref_graph, _mirror  # noqa: E402


def _pairs():
    out = []
    g_ref, _ = ref_toy.hybrid_chain()
    g, _ = toy.hybrid_chain()
    out.append(("hybrid_chain", ref_compile(g_ref), lt.compile_graph(g, "cpu")))
    for seed in (0, 3):
        g_ref = _rand_ref_graph(np.random.default_rng(seed))
        out.append((f"rand{seed}", ref_compile(g_ref),
                    lt.compile_graph(_mirror(g_ref), "cpu")))
    return out


_PAIRS = _pairs()


def _walkers(fg, W, seed):
    rng = np.random.default_rng(seed)
    lo, hi = fg.cont_lo.numpy(), fg.cont_hi.numpy()
    xc = rng.uniform(lo, hi, size=(W, fg.n_cont)).astype(np.float32)
    xd = np.floor(rng.uniform(size=(W, fg.n_disc))
                  * fg.disc_sizes.numpy()).astype(np.int64)
    return xc, xd


def _ref_greedy(ref, cfg, xc, xd):
    """The reference's greedy branch (map_search.py:49-66), one walker."""
    grad_fn = jax.grad(ref.log_prob)
    if ref.n_disc:
        logits = ref.disc_logits(xc, xd)
        cur = select_last(logits, xd)
        gain = jnp.max(logits, axis=1) - cur
        v = jnp.argmax(gain)
        best_val = jnp.argmax(logits[v]).astype(jnp.int32)
        xd = xd.at[v].set(jnp.where(gain[v] > 0, best_val, xd[v]))
    for _ in range(cfg.n_grad):
        g = jnp.nan_to_num(grad_fn(xc, xd))
        xc = jnp.clip(xc + cfg.grad_step * g, ref.cont_lo, ref.cont_hi)
    return xc, xd


@pytest.mark.parametrize("case", range(len(_PAIRS)),
                         ids=[p[0] for p in _PAIRS])
def test_energies_and_greedy_step_match_reference(case):
    """Given walkers: their energies (rtol 1e-5), and one greedy step (the
    same discrete reassignment; continuous states within rtol 1e-5)."""
    _, ref, fg = _PAIRS[case]
    xc, xd = _walkers(fg, 16, case)
    e_ref = np.asarray(jax.vmap(ref.log_prob)(jnp.asarray(xc),
                                              jnp.asarray(xd, jnp.int32)))
    e = fg.log_prob_batched(torch.from_numpy(xc), torch.from_numpy(xd))
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(e_ref).max()))
    cfg = MWSConfig(grad_step=0.05, n_grad=3)
    gc, gd = greedy_step(fg, cfg, torch.from_numpy(xc), torch.from_numpy(xd))
    rc, rd = jax.vmap(lambda c, d: _ref_greedy(ref, cfg, c, d))(
        jnp.asarray(xc), jnp.asarray(xd, jnp.int32))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5,
                               atol=1e-5)


def test_mws_finds_gaussian_mode():
    """tests/test_nuts_map.py:44-55: the mode of a correlated Gaussian
    within 0.1."""
    dom = lt.Domain([-20, 20], continuous=True)
    a, b = lt.RV(dom, name="a"), lt.RV(dom, name="b")
    g = lt.Graph([a, b], [lt.F(GaussianPotential(
        [1.5, -0.5], [[1.0, 0.4], [0.4, 1.0]]), [a, b])])
    eng = HybridMaxWalkSAT(lt.compile_graph(g, "cpu"),
                           MWSConfig(n_walkers=32, n_steps=200)).run(
        torch.Generator().manual_seed(0))
    assert abs(eng.map(a) - 1.5) < 0.1
    assert abs(eng.map(b) + 0.5) < 0.1


def test_mws_hybrid_chain_map():
    """tests/test_nuts_map.py:58-70: the joint mode of hybrid_chain (the
    discrete value exactly, the continuous ones within 0.15 of the dense
    grid's mode); an observed RV's map is its value."""
    g, (d, x1, x2) = toy.hybrid_chain()
    want = ExactPosterior(g, cont_grid=201).map_state()
    fg = lt.compile_graph(g, "cpu")
    eng = HybridMaxWalkSAT(fg, MWSConfig(n_walkers=64, n_steps=400,
                                         grad_step=0.1)).run(
        torch.Generator().manual_seed(1))
    assert eng.map(d) == want[d]
    assert abs(eng.map(x1) - want[x1]) < 0.15
    assert abs(eng.map(x2) - want[x2]) < 0.15
    assert eng.energy == pytest.approx(float(fg.log_prob(
        torch.tensor(eng.xc), torch.tensor(eng.xd))), rel=1e-5)
