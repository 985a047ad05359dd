"""The PyTorch port's compiler held to the JAX reference.

The same graph (built from the same seed by each package's own model
function, or mirrored object by object from a reference graph) compiles
in both packages. The host tables come from the same numpy code on both
sides, so they must be EQUAL; the log-probabilities are f32 sums taken in
another order, so they agree to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import lhvi_tpu.models.toy as ref_toy  # noqa: E402
import lhvi_tpu.potentials as ref_pot  # noqa: E402
from lhvi_tpu import Domain as RDomain, F as RF, Graph as RGraph, RV as RRV  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
import lhvi_tpu_torch.potentials as pot  # noqa: E402
from lhvi_tpu_torch.utils.convert import QUAD_TABLES, compiled_from_numpy  # noqa: E402

# (model function, compile kwargs): 10×10 and 64×64 land on the dense
# form, the 32×32 grid at quad_max_n=256 on ELL refined to DIA,
# hybrid_chain keeps discrete and MLN buckets beside the fused form
CASES = {
    "grid10": (lambda m: m.gaussian_grid(10, 10, seed=0, evidence_frac=0.2), {}),
    "grid64": (lambda m: m.gaussian_grid(64, 64, seed=0, evidence_frac=0.2), {}),
    "grid32_dia": (lambda m: m.gaussian_grid(32, 32, seed=0, evidence_frac=0.2),
                   {"quad_max_n": 256}),
    "hybrid_chain": (lambda m: m.hybrid_chain(), {}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    build, kw = CASES[request.param]
    g_ref, _ = build(ref_toy)
    g, _ = build(toy)
    return request.param, ref_compile(g_ref, **kw), lt.compile_graph(g, "cpu", **kw)


def _np(a):
    return None if a is None else np.asarray(a)


def _quad_tables(fg):
    return {
        "quad_J": _np(fg.quad_J), "quad_h": _np(fg.quad_h),
        "quad_c": _np(fg.quad_c), "quad_diag": _np(fg.quad_diag),
        "quad_ell_col": _np(fg.quad_ell_col), "quad_ell_w": _np(fg.quad_ell_w),
        "quad_dia_offsets": fg.quad_dia_offsets,
        "quad_dia_w": _np(fg.quad_dia_w), "quad_dia_pos": _np(fg.quad_dia_pos),
        "quad_dia_inv": _np(fg.quad_dia_inv),
        "cont_lo": _np(fg.cont_lo), "cont_hi": _np(fg.cont_hi),
        "n_cont": fg.n_cont,
    }


def _assert_same(a, b, what):
    if a is None or b is None or isinstance(a, (tuple, int)):
        assert a == b, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    # index tables are int64 in the port and int32 in the reference
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_ir_tables_equal_reference(pair):
    """Host mirrors and the fused information form are EQUAL: the same
    numpy code ran on both sides."""
    name, ref, fg = pair
    for attr in ("n_cont", "n_disc", "max_v", "has_quad", "lp_bucket_idx",
                 "quad_sparse", "cont_pure_quad"):
        assert getattr(fg, attr) == getattr(ref, attr), (name, attr)
    assert len(fg.meta.np_buckets) == len(ref.meta.np_buckets)
    for i, (b, rb) in enumerate(zip(fg.meta.np_buckets, ref.meta.np_buckets)):
        assert set(b) == set(rb)
        for k in b:
            if k == "params":
                assert set(b[k]) == set(rb[k])
                for pk in b[k]:
                    _assert_same(b[k][pk], rb[k][pk], (name, i, pk))
            else:
                _assert_same(b[k], rb[k], (name, i, k))
        # the device tensors hold the host mirrors' values
        _assert_same(fg.buckets[i].cont_idx.numpy(), b["cont_idx"], (name, i))
        _assert_same(fg.buckets[i].scale.numpy(), b["scale"], (name, i))
    # the conflict coloring (color_of) included
    assert set(ref.meta.np_global) == set(fg.meta.np_global)
    for k, v in fg.meta.np_global.items():
        _assert_same(v, ref.meta.np_global[k], (name, k))
    rt, pt = _quad_tables(ref), _quad_tables(fg)
    for k in QUAD_TABLES:
        _assert_same(pt[k], rt[k], (name, k))


def _states(fg, rng, C):
    xc = rng.normal(0.0, 2.0, (C, fg.n_cont)).astype(np.float32)
    sizes = np.asarray(fg.meta.np_global["disc_sizes"])
    xd = (rng.uniform(size=(C, fg.n_disc)) * sizes[None]).astype(np.int32)
    return xc, xd


def test_log_prob_batched_matches_reference(pair):
    """f32 sums in another order: rtol 1e-5."""
    name, ref, fg = pair
    xc, xd = _states(fg, np.random.default_rng(0), 5)
    txc, txd = torch.from_numpy(xc), torch.from_numpy(xd).long()
    jxc, jxd = jnp.asarray(xc), jnp.asarray(xd)
    for fn in ("log_prob_batched", "log_prob_cont_batched"):
        got = getattr(fg, fn)(txc, txd).numpy()
        want = np.asarray(getattr(ref, fn)(jxc, jxd))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=(name, fn))
    if fg.has_quad:
        np.testing.assert_allclose(fg.quad_log_prob_batched(txc).numpy(),
                                   np.asarray(ref.quad_log_prob_batched(jxc)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(fg.log_prob(txc[0], txd[0])),
                               float(ref.log_prob(jxc[0], jxd[0])),
                               rtol=1e-5, err_msg=name)


def test_compiled_from_numpy_matches_own_compile(pair):
    """The reference's tables carried across build the port's own IR."""
    name, ref, fg = pair
    assert ref.has_quad
    conv = compiled_from_numpy(_quad_tables(ref), "cpu")
    assert conv.cont_pure_quad and conv.n_disc == 0
    mine, theirs = _quad_tables(fg), _quad_tables(conv)
    for k in QUAD_TABLES:
        _assert_same(theirs[k], mine[k], (name, k))
    assert (conv.quad_J.dtype, conv.quad_h.dtype) == (torch.float32,) * 2


# ---- randomized hybrid graphs, mirrored into the port's classes ----------

def _rand_ref_graph(rng):
    """Random hybrid graph in the REFERENCE classes: every potential type,
    arities 1-3, MLN formulas in land/lor/lneg arithmetic (which runs on
    jax and torch arrays alike), a hard constraint, random evidence."""
    n_disc = int(rng.integers(1, 4))
    n_cont = int(rng.integers(2, 5))
    disc = []
    for i in range(n_disc):
        size = int(rng.integers(2, 4))
        base = int(rng.integers(-1, 2))
        disc.append(RRV(RDomain(list(range(base, base + size))), name=f"d{i}"))
    cont = [RRV(RDomain([-8, 8], continuous=True), name=f"x{i}")
            for i in range(n_cont)]
    fs = [RF(ref_pot.GaussianPotential([0.0], [[4.0]]), [x]) for x in cont]
    for d in disc:
        t = rng.uniform(0.2, 1.0, size=len(d.domain.values))
        fs.append(RF(ref_pot.TablePotential(list(t / t.sum())), [d]))
    a, b = (cont[i] for i in rng.choice(n_cont, 2, replace=False))
    A = rng.normal(size=(2, 2))
    fs += [
        RF(ref_pot.LinearGaussianPotential(float(rng.normal()), 1.0), [a, b]),
        RF(ref_pot.XYPotential(float(rng.normal()), 1.5), [b, a]),
        RF(ref_pot.QuadraticPotential(-(A @ A.T + np.eye(2)),
                                      rng.normal(size=2), 0.3), [a, b]),
        RF(ref_pot.ImageNodePotential(0.7), [a, b]),
        RF(ref_pot.ImageEdgePotential(1.5, 2.0), [b, a]),
        RF(ref_pot.GaussianPotential([0.5, -0.5], [[2.0, 0.3], [0.3, 1.0]]),
           [a, b]),
    ]
    d0, d1 = disc[0], disc[-1]
    fs += [
        RF(ref_pot.MLNPotential(
            lambda v: ref_pot.lor(ref_pot.land(v[0], v[1]), ref_pot.lneg(v[1])),
            w=float(rng.uniform(0.2, 1.0)), formula_name="soft"), [d0, d1]),
        RF(ref_pot.MLNPotential(
            lambda v: -((v[1] - 0.5 * v[0]) ** 2), w=0.4,
            formula_name="mix"), [d1, a]),
        RF(ref_pot.MLNPotential(
            lambda v: ref_pot.limp(v[0] * 0.5, v[1] * 0.25), w=None,
            formula_name="hard"), [d0, b]),
        RF(ref_pot.TablePotential(
            rng.uniform(0.2, 1.0, size=(len(d0.domain.values),
                                        len(d1.domain.values)))), [d0, d1]),
    ]
    rvs = disc + cont
    for rv in rng.permutation(np.array(rvs, dtype=object))[: len(rvs) // 4]:
        if rv.domain.continuous:
            rv.value = float(rng.normal())
        else:
            rv.value = rv.domain.values[int(rng.integers(len(rv.domain.values)))]
    return RGraph(rvs, fs)


def _mirror(g_ref):
    """The same graph in the port's classes: RVs and domains rebuilt,
    potentials re-classed with their parameters copied verbatim."""
    m = {}
    for rv in g_ref.rvs:
        d = rv.domain
        dom = lt.Domain(d.values, continuous=d.continuous,
                        integral_points=d.integral_points)
        m[id(rv)] = lt.RV(dom, value=rv.value, name=rv.name)
    fs = []
    for f in g_ref.factors:
        p = object.__new__(getattr(pot, type(f.potential).__name__))
        p.__dict__.update(f.potential.__dict__)
        fs.append(lt.F(p, [m[id(rv)] for rv in f.nb]))
    return lt.Graph([m[id(rv)] for rv in g_ref.rvs], fs)


@pytest.mark.parametrize("seed", range(8))
def test_randomized_graphs_log_prob_matches_reference(seed):
    """Bucketed/padded IR on random hybrid graphs: host tables equal, the
    batched log-probs agree to rtol 1e-5 (atol 1e-5 for values near 0)."""
    g_ref = _rand_ref_graph(np.random.default_rng(seed))
    ref = ref_compile(g_ref)
    fg = lt.compile_graph(_mirror(g_ref), "cpu")
    assert fg.lp_bucket_idx == ref.lp_bucket_idx
    for b, rb in zip(fg.meta.np_buckets, ref.meta.np_buckets):
        for k in b:
            if k != "params":
                _assert_same(b[k], rb[k], (seed, k))
    np.testing.assert_array_equal(_np(fg.quad_J), _np(ref.quad_J))
    xc, xd = _states(fg, np.random.default_rng(100 + seed), 6)
    for fn in ("log_prob_batched", "log_prob_cont_batched"):
        got = getattr(fg, fn)(torch.from_numpy(xc), torch.from_numpy(xd).long())
        want = getattr(ref, fn)(jnp.asarray(xc), jnp.asarray(xd))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=(seed, fn))
