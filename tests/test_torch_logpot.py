"""The port's non-quadratic leapfrog (``ops/logpot.py``), its fused-kernel
plan and the host tapes (``ops/logpot_tape.py``) held to the JAX reference.

The same models, built from the same seeds by each package's own model
functions, compile to EQUAL host tables. The plan is eligible exactly
where the reference's is. One leapfrog through the plan's CPU twin (the
tape evaluator K5 mirrors) and through the autograd path equals the
reference's XLA path and its Pallas kernel (``pltpu.force_tpu_interpret_mode``,
as ``tests/test_logpot_kernel.py`` runs it) at rtol = atol = 2e-4, the
reference's own bound for its kernel. Energies and gradients of the tapes
equal autograd over ``log_prob_cont_batched`` at 1e-5 (f32 sums in
another order).
"""

import functools
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import lhvi_tpu.models.image as ref_img  # noqa: E402
import lhvi_tpu.models.relational as ref_rel  # noqa: E402
import lhvi_tpu.models.toy as ref_toy  # noqa: E402
import lhvi_tpu.potentials as ref_pot  # noqa: E402
from lhvi_tpu import Domain as RDomain, F as RF, Graph as RGraph, RV as RRV  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.ops import logpot as ref_logpot  # noqa: E402
from lhvi_tpu.relational.data import load_evidence as ref_load  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.image as img  # noqa: E402
import lhvi_tpu_torch.models.relational as rel  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
import lhvi_tpu_torch.potentials as pot  # noqa: E402
from lhvi_tpu_torch.engines import smc  # noqa: E402
from lhvi_tpu_torch.ops import logpot  # noqa: E402
from lhvi_tpu_torch.ops.logpot_tape import (  # noqa: E402
    MAX_NODES,
    tape_forward,
    tape_reverse,
    trace_planar,
)
from lhvi_tpu_torch.relational.data import load_evidence  # noqa: E402

REF = dict(Domain=RDomain, RV=RRV, F=RF, Graph=RGraph, pot=ref_pot,
           toy=ref_toy, rel=ref_rel, img=ref_img, load=ref_load)
PORT = dict(Domain=lt.Domain, RV=lt.RV, F=lt.F, Graph=lt.Graph, pot=pot,
            toy=toy, rel=rel, img=img, load=load_evidence)


def _robot(n):
    def build(m):
        text, _ = m["rel"].robot_scan_evidence(n, seed=0)
        return m["rel"].robot_map(n, evidence=m["load"](text)).ground()[0]
    return build


def _denoise(rows):
    return lambda m: m["img"].denoise_grid(rows, rows, seed=0)[0]


def _friends(m):
    rg = m["rel"].friends_smokers(n_people=4, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    return rg.ground()[0]


def _tied_and_valued(m):
    """A continuous latent named twice by one factor (tied slots), a
    discrete domain whose values are not its indices, an observed
    discrete slot and an observed continuous slot."""
    D, RV, F, M = m["Domain"], m["RV"], m["F"], m["pot"].MLNPotential
    s = RV(D([-1.0, 1.0]), name="s")
    o = RV(D([-1.0, 1.0]), name="o")
    o.value = 1.0
    x = RV(D([-4.0, 4.0], continuous=True), name="x")
    y = RV(D([-4.0, 4.0], continuous=True), name="y")
    e = RV(D([-4.0, 4.0], continuous=True), name="e")
    e.value = 0.7
    return m["Graph"]([s, o, x, y, e], [
        F(M(lambda a: -(a[0] * a[1]) / 4.0 - a[0] ** 2 / 8.0, w=0.9,
            formula_name="tied"), [x, x]),
        F(M(lambda a: -((a[1] - a[0]) ** 2) / 2.0, w=1.1,
            formula_name="pull"), [s, y]),
        F(M(lambda a: -((a[2] - a[0] * a[1]) ** 2) / 3.0, w=0.6,
            formula_name="mix"), [s, o, x]),
        F(M(lambda a: -torch.abs(a[0] - a[1]) / 2.0, w=0.5,
            formula_name="robust"), [y, e]),
    ])


def _planar(group):
    """Every potential type with a planar kernel on continuous slots, in
    two models (the reference's footprint gate admits about six buckets);
    compiled with ``fuse_quadratic=False`` (``_UNFUSED``), so the
    Gaussian-type buckets reach the plan instead of the quadratic form."""

    def build(m):
        D, RV, F, P = m["Domain"], m["RV"], m["F"], m["pot"]
        dom = D([-3.0, 3.0], continuous=True)
        x1, x2, x3 = (RV(dom, name=f"x{i}") for i in (1, 2, 3))
        y = RV(dom, name="y")
        y.value = 0.4
        if group == "a":
            fs = [F(P.GaussianPotential([0.5, -0.2], [[2.0, 0.3], [0.3, 1.5]]),
                    [x1, x2]),
                  F(P.LinearGaussianPotential(coeff=0.7, sig=1.3), [x1, x3]),
                  F(P.QuadraticPotential([[-0.5, 0.1], [0.1, -0.4]],
                                         [0.2, -0.1], 0.3), [x2, x3])]
        else:
            fs = [F(P.XYPotential(coeff=0.6, sig=2.0), [x1, x2]),
                  F(P.ImageNodePotential(alpha=0.1), [x3, y]),
                  F(P.ImageEdgePotential(distance_cap=0.4, scale=0.05),
                    [x1, x3]),
                  F(P.MLNPotential(lambda a: -(a[0] - 1.0) ** 2 / 2.0, w=0.8,
                                   formula_name="pull"), [x2])]
        return m["Graph"]([x1, x2, x3, y], fs)
    return build


_UNFUSED = {"planar_a", "planar_b"}

MODELS = {
    "robot10": _robot(10),
    "robot24": _robot(24),
    "robot100": _robot(100),
    "robot150": _robot(150),
    "denoise6": _denoise(6),
    "denoise11": _denoise(11),
    "denoise12": _denoise(12),
    "denoise16": _denoise(16),
    "friends4": _friends,
    "hybrid_chain": lambda m: m["toy"].hybrid_chain()[0],
    "grid6": lambda m: m["toy"].gaussian_grid(6, 6, seed=0)[0],
    "tied_and_valued": _tied_and_valued,
    "planar_a": _planar("a"),
    "planar_b": _planar("b"),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    kw = {"fuse_quadratic": False} if name in _UNFUSED else {}
    return (ref_compile(MODELS[name](REF), **kw),
            lt.compile_graph(MODELS[name](PORT), "cpu", **kw))


def _states(fg, C, seed):
    """The reference test's inputs (tests/test_logpot_kernel.py:40-51)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, fg.n_cont)).astype(np.float32)
    p = rng.normal(size=(C, fg.n_cont)).astype(np.float32)
    sizes = np.asarray(fg.meta.np_global["disc_sizes"])
    xd = (rng.integers(0, sizes[None, :], (C, fg.n_disc)) if fg.n_disc
          else np.zeros((C, 0))).astype(np.int64)
    return x, p, xd


@pytest.mark.parametrize("name", ["robot24", "denoise6", "tied_and_valued",
                                  "planar_a", "planar_b"])
def test_ir_tables_equal_reference(name):
    """The host mirrors the plan is built from are EQUAL, and every bucket
    has a planar kernel exactly where the reference's has one."""
    ref, fg = _pair(name)
    assert (fg.n_cont, fg.n_disc, fg.cont_bucket_idx) == (
        ref.n_cont, ref.n_disc, tuple(ref.cont_bucket_idx))
    for i, (b, rb) in enumerate(zip(fg.meta.np_buckets, ref.meta.np_buckets)):
        assert set(b) == set(rb)
        for k in b:
            if k == "params":
                for pk in rb[k]:
                    np.testing.assert_array_equal(b[k][pk], rb[k][pk])
            else:
                np.testing.assert_array_equal(b[k], rb[k], err_msg=(name, i, k))
        assert ((fg.buckets[i].kernel_planar is None)
                == (ref.buckets[i].kernel_planar is None)), (name, i)
        assert fg.buckets[i].pattern == tuple(ref.buckets[i].pattern)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("max_bytes", [8 << 20, 1 << 10])
def test_plan_is_none_exactly_where_the_reference_is(name, max_bytes):
    """Eligibility (no xc-dependent bucket, ELL quad form, no planar
    kernel, footprint over ``max_bytes``) and the footprint estimate
    itself match the reference's ``logpot_plan``."""
    ref, fg = _pair(name)
    want = ref_logpot.logpot_plan(ref, max_bytes=max_bytes)
    got = logpot.logpot_plan(fg, max_bytes=max_bytes)
    assert (got is None) == (want is None), name
    if got is not None:
        assert logpot._footprint(fg, fg.cont_bucket_idx,
                                 256) == want.vmem_bytes
    if name in ("denoise16", "denoise12", "grid6") or max_bytes == 1 << 10:
        assert got is None


@pytest.mark.parametrize("formula,match", [
    (lambda a: torch.sin(a[0]) * a[1], "sin"),
    (lambda a: a[1] if a[0] > 0.0 else -a[1], "control flow"),
    (lambda a: a[0] ** a[1], "exponent"),
    (lambda a: torch.where(a[0] > 0.0, a[1], -a[1]), "where"),
    (lambda a: a[0].clamp(0.0, 1.0) * a[1], "clamp"),
])
def test_untraceable_formula_raises(formula, match):
    """A formula outside the tape's op set makes both plans RAISE, naming
    what it met (None would send the model off the kernel silently)."""
    dom = lt.Domain([-2.0, 2.0], continuous=True)
    x, y = lt.RV(dom, name="x"), lt.RV(dom, name="y")
    g = lt.Graph([x, y], [
        lt.F(pot.MLNPotential(formula, w=0.5, formula_name="f"), [x, y]),
        lt.F(pot.GaussianPotential([0.0], [[1.0]]), [x])])
    fg = lt.compile_graph(g, "cpu")
    for make in (logpot.logpot_plan, logpot.kernel_plan):
        with pytest.raises(NotImplementedError, match=match):
            make(fg)


_OP_FORMULAS = {
    "arith": lambda a: (a[0] * a[1] - a[0] / (a[1] + 3.0)) + (-a[0]) * 2.5,
    "pow": lambda a: a[0] ** 2 + (a[1] + 3.0) ** 0.5 + a[0] ** 3
    - (a[1] + 4.0) ** -1 + (a[0] + 5.0) ** 1.7,
    "exp_log": lambda a: torch.exp(-0.5 * a[0]) + torch.log(a[1] * a[1] + 1.0),
    "abs_min_max": lambda a: -torch.minimum(torch.abs(a[0] - a[1]), a[2])
    + torch.maximum(a[0], 0.3 * a[1]),
    "compare": lambda a: (a[0] > 0.0) * a[1] + (a[0] <= a[1]) * a[0] * a[0]
    - (a[2] == 1.0) * a[1] + (a[2] != 0.0) * 0.5 + (a[1] >= 0.2) * (a[0] < 1.0),
}


@pytest.mark.parametrize("name", sorted(_OP_FORMULAS))
def test_tape_matches_autograd_on_each_op(name):
    """One tape per op family, forward and reverse, against torch and its
    autograd on the same slots (ties and zeros of abs/min/max included:
    both split a tie evenly and give abs'(0) = 0). rtol 1e-6."""
    f = _OP_FORMULAS[name]
    tape = trace_planar(lambda params, s: f(s), (True, True, True), {})
    rng = np.random.default_rng(3)
    v = rng.normal(size=(3, 4, 16)).astype(np.float32)
    v[2] = np.round(v[2])  # integer-valued third slot for the comparisons
    v[0, :, :4] = v[1, :, :4]  # ties
    v[0, :, 4:6] = 0.0
    v[1, :, 4:6] = 0.0
    slots = [torch.tensor(s, requires_grad=True) for s in v]
    want = f(slots)
    seed = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    grads = torch.autograd.grad(want, slots, seed, allow_unused=True)
    vals = tape_forward(tape, [s.detach() for s in slots], [],
                        torch.zeros((16, 0)))
    np.testing.assert_allclose(vals[-1].numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    adj = tape_reverse(tape, vals, seed)
    for i, g in enumerate(grads):
        got = adj.get(i, torch.zeros_like(seed))
        want_g = torch.zeros_like(seed) if g is None else g
        np.testing.assert_allclose(got.numpy(), want_g.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} slot {i}")


@pytest.mark.parametrize("name", ["robot10", "denoise6", "friends4",
                                  "hybrid_chain", "tied_and_valued",
                                  "planar_a", "planar_b"])
def test_tape_energy_grad_matches_autograd(name):
    """K5's plain twin against autograd over ``log_prob_cont_batched``:
    E + quad_c equals the log-density and ∇E its gradient (tol 1e-5 ·
    max(1, |value|): f32 sums in another order)."""
    _, fg = _pair(name)
    plan = logpot.logpot_plan(fg)
    assert plan is not None
    x, _, xd = _states(fg, 13, seed=len(name))
    x, xd = torch.from_numpy(x), torch.from_numpy(xd)
    e, g = logpot.tape_energy_grad(plan, x, plan.disc_values(xd))
    xr = x.clone().requires_grad_(True)
    lp = fg.log_prob_cont_batched(xr, xd)
    (gw,) = torch.autograd.grad(lp.sum(), xr)
    want_e = lp.detach().double().numpy()
    got_e = e.numpy() + float(fg.quad_c)
    assert np.all(np.abs(got_e - want_e) <= 1e-5 * np.maximum(1, np.abs(want_e)))
    np.testing.assert_allclose(g.numpy(), gw.numpy(), rtol=1e-5, atol=1e-5)


def _plan_source_rows(fg):
    """(bucket position, source row) of each plan row, in the layout the
    plan documents: the rows reading a latent continuous slot bucket by
    bucket, then the evidence-only rows; padded rows (scale 0) dropped."""
    act, cst = [], []
    for bi, i in enumerate(fg.cont_bucket_idx):
        np_b = fg.meta.np_buckets[i]
        rows = np.flatnonzero(np_b["scale"] > 0)
        lat = (np_b["cont_mask"][rows] > 0).any(axis=1)
        act += [(bi, r) for r in rows[lat]]
        cst += [(bi, r) for r in rows[~lat]]
    return act + cst


@pytest.mark.parametrize("name", ["robot10", "tied_and_valued"])
def test_disc_values_follow_the_reference(name):
    """The plan's per-row discrete slot values (``plan.disc_values``)
    equal the reference's ``disc_slot_values`` (observed slots through
    their value tables), row by row."""
    ref, fg = _pair(name)
    _, _, xd = _states(fg, 5, seed=1)
    want = ref_logpot.disc_slot_values(ref, jnp.asarray(xd.astype(np.int32)))
    plan = logpot.logpot_plan(fg)
    dv = plan.disc_values(torch.from_numpy(xd))
    order = _plan_source_rows(fg)
    assert len(want) == len(plan.buckets) and len(order) == plan.n_rows
    for bi, (bp, w_b) in enumerate(zip(plan.buckets, want)):
        rows = [k for k, (b, _) in enumerate(order) if b == bi]
        src = [r for b, r in order if b == bi]
        assert bp.rows.tolist() == rows
        assert len(w_b) == len(bp.pattern) - sum(bp.pattern)
        for d, w_s in enumerate(w_b):
            np.testing.assert_array_equal(dv[:, bp.rows, d].numpy(),
                                          np.asarray(w_s)[:, src])


@pytest.mark.parametrize("name,tempered,C", [
    ("robot10", False, 16), ("robot10", True, 13),
    ("denoise6", False, 13), ("denoise6", True, 16)])
def test_leapfrog_matches_reference_and_its_kernel(name, tempered, C):
    """One leapfrog, four routes on the same inputs: the port's plan twin
    and autograd path against the reference's XLA path and its Pallas
    kernel in interpret mode (tests/test_logpot_kernel.py:54-150; C = 13
    is a padded chain block there). rtol = atol = 2e-4."""
    ref, fg = _pair(name)
    steps, eps = (5, 0.03) if not tempered else (4, 0.05)
    x, p, xd = _states(fg, C, seed=C)
    im = np.ones(fg.n_cont, np.float32)
    kw_r, kw_p = {}, {}
    if tempered:
        mid = 0.5 * (np.asarray(ref.cont_lo) + np.asarray(ref.cont_hi))
        is2 = np.full(fg.n_cont, 0.25, np.float32)
        kw_r = dict(beta=0.37, base_mid=jnp.asarray(mid),
                    base_inv_s2=jnp.asarray(is2))
        kw_p = dict(beta=torch.tensor(0.37),
                    base_mid=torch.from_numpy(mid.astype(np.float32)),
                    base_inv_s2=torch.from_numpy(is2))
    ra = (ref, jnp.asarray(x), jnp.asarray(p),
          jnp.asarray(xd.astype(np.int32)), jnp.asarray(im), eps, steps)
    want_xla = ref_logpot.logpot_leapfrog(*ra, plan=None, **kw_r)
    with pltpu.force_tpu_interpret_mode():
        want_pl = ref_logpot.logpot_leapfrog(
            *ra, plan=ref_logpot.logpot_plan(ref), **kw_r)
    pa = (fg, torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(xd),
          torch.from_numpy(im), eps, steps)
    got_plan = logpot.logpot_leapfrog(*pa, plan=logpot.logpot_plan(fg), **kw_p)
    got_auto = logpot.logpot_leapfrog(*pa, plan=None, **kw_p)
    for got in (got_plan, got_auto):
        for want in (want_xla, want_pl):
            for what, a, b in zip(("x1", "p1", "lp0", "lp1"), got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=2e-4, atol=2e-4,
                                           err_msg=f"{name} {what}")


def test_plan_cache_and_auto_routing():
    """``plan="auto"``: one cached plan per compiled graph; on CPU tensors
    it resolves to the autograd path, as the reference's does off the TPU
    (bit-identical results to ``plan=None``)."""
    _, fg = _pair("robot10")
    p1 = logpot.logpot_plan_cached(fg)
    assert p1 is not None and logpot.logpot_plan_cached(fg) is p1
    assert logpot.logpot_plan_cached(_pair("denoise6")[1]) is not p1
    x, p, xd = (torch.from_numpy(a) for a in _states(fg, 6, seed=0))
    im = torch.ones(fg.n_cont)
    a = logpot.logpot_leapfrog(fg, x, p, xd, im, 0.05, 3, plan="auto")
    b = logpot.logpot_leapfrog(fg, x, p, xd, im, 0.05, 3, plan=None)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError):
        logpot.logpot_leapfrog(fg, x, p, xd, im, 0.05, 3, plan="fused")


def test_smc_fused_logpot_takes_the_plan_path(monkeypatch):
    """``run_smc(fused_logpot=True)`` on denoise_grid(6, 6) moves through
    the plan (forced on CPU tensors, where K5's twin runs) and gives the
    unfused log Z within Monte Carlo error: over three seeds per route,
    the means agree within 5 standard errors of their difference. The
    seed-to-seed sd of log Z is 0.85 (unfused) and 0.89 (fused) at 512
    particles on the adaptive schedule (16 seeds each), so the bound is
    5 · 0.9 · √(2/3) = 3.7."""
    _, fg = _pair("denoise6")
    calls = []
    orig = logpot._plan_leapfrog
    monkeypatch.setattr(logpot, "_resolve_plan",
                        lambda fg_, plan, x: logpot.logpot_plan_cached(fg_)
                        if plan == "auto" else plan)
    monkeypatch.setattr(logpot, "_plan_leapfrog",
                        lambda *a: calls.append(1) or orig(*a))
    lz = {}
    for fused in (True, False):
        cfg = smc.SMCConfig(n_particles=512, n_temps=400, adaptive=True,
                            fused_logpot=fused)
        n0 = len(calls)
        lz[fused] = [smc.sample(fg, torch.Generator().manual_seed(s), cfg).log_z
                     for s in range(3)]
        assert (len(calls) > n0) == fused
        assert np.all(np.isfinite(lz[fused]))
    assert abs(np.mean(lz[True]) - np.mean(lz[False])) < 3.7, lz


def _ell_chain():
    """A Gaussian chain of six latents in the ELL form, plus an MLN
    factor outside the quadratic form."""
    dom = lt.Domain([-3.0, 3.0], continuous=True)
    xs = [lt.RV(dom, name=f"x{i}") for i in range(6)]
    fs = [lt.F(pot.LinearGaussianPotential(coeff=0.7, sig=1.3), [a, b])
          for a, b in zip(xs, xs[1:])]
    fs += [lt.F(pot.GaussianPotential([0.0], [[1.0]]), [xs[0]]),
           lt.F(pot.MLNPotential(lambda a: -(a[0] - 1.0) ** 2 / 2.0, w=0.8,
                                 formula_name="pull"), [xs[3]])]
    fg = lt.compile_graph(lt.Graph(xs, fs), "cpu", quad_max_n=4)
    assert fg.quad_sparse and not fg.cont_pure_quad
    return fg


class _NoPlanar(pot.MLNPotential):
    def kernel_planar(self, pattern):
        return None


def _no_planar():
    dom = lt.Domain([-2.0, 2.0], continuous=True)
    x, y = lt.RV(dom, name="x"), lt.RV(dom, name="y")
    return lt.compile_graph(lt.Graph([x, y], [
        lt.F(_NoPlanar(lambda a: -(a[0] - a[1]) ** 2, w=0.5,
                       formula_name="f"), [x, y])]), "cpu")


@pytest.mark.parametrize("name", ["robot24", "denoise6", "denoise11",
                                  "tied_and_valued"])
def test_kernel_plan_equals_the_reference_gated_plan(name):
    """Where the reference's gate admits a graph, K5's own plan holds the
    same tables and tapes."""
    _, fg = _pair(name)
    a, b = logpot.logpot_plan(fg), logpot.kernel_plan(fg)
    assert a is not None and b is not None
    assert (a.n_active, a.acm, a.adm, a.pm) == (b.n_active, b.acm, b.adm, b.pm)
    for k in ("bucket_tape", "tape_pack", "cidx", "cconst", "prm", "w",
              "row_order", "segs", "color_ptr", "dvar", "dlat", "dconst",
              "dtab"):
        assert torch.equal(getattr(a, k), getattr(b, k)), (name, k)
    assert [bp.tape for bp in a.buckets] == [bp.tape for bp in b.buckets]


@pytest.mark.parametrize("name,tempered", [("denoise12", False),
                                           ("denoise16", True)])
def test_kernel_plan_past_the_reference_gate(name, tempered):
    """Grids over the reference's 8 MB TPU estimate fit K5's shared
    memory: K5's plan exists there, and one leapfrog through its CPU twin
    equals the port's autograd path and the reference's XLA path at
    rtol = atol = 2e-4."""
    ref, fg = _pair(name)
    assert logpot.logpot_plan(fg) is None
    plan = logpot.kernel_plan(fg)
    assert plan is not None and plan.n_rows == sum(
        int((fg.meta.np_buckets[i]["scale"] > 0).sum())
        for i in fg.cont_bucket_idx)
    x, p, xd = _states(fg, 7, seed=5)
    im = np.ones(fg.n_cont, np.float32)
    kw_r, kw_p = {}, {}
    if tempered:
        mid = 0.5 * (np.asarray(ref.cont_lo) + np.asarray(ref.cont_hi))
        is2 = np.full(fg.n_cont, 0.25, np.float32)
        kw_r = dict(beta=0.37, base_mid=jnp.asarray(mid),
                    base_inv_s2=jnp.asarray(is2))
        kw_p = dict(beta=torch.tensor(0.37),
                    base_mid=torch.from_numpy(mid.astype(np.float32)),
                    base_inv_s2=torch.from_numpy(is2))
    want = ref_logpot.logpot_leapfrog(
        ref, jnp.asarray(x), jnp.asarray(p), jnp.asarray(xd.astype(np.int32)),
        jnp.asarray(im), 0.03, 4, plan=None, **kw_r)
    pa = (fg, torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(xd),
          torch.from_numpy(im), 0.03, 4)
    for got in (logpot.logpot_leapfrog(*pa, plan=plan, **kw_p),
                logpot.logpot_leapfrog(*pa, plan=None, **kw_p)):
        for what, a, b in zip(("x1", "p1", "lp0", "lp1"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{name} {what}")


@pytest.mark.parametrize("case,match", [("ell", "ELL"),
                                        ("no_planar", "planar kernel"),
                                        ("shared_memory", "shared memory")])
def test_kernel_plan_raises_where_k5_cannot_run(case, match, monkeypatch):
    """K5's plan RAISES where K5 cannot run the graph (the reference's
    plan is None there, or its gate says nothing of K5's limit), so
    ``fused_logpot=True`` never leaves the kernel silently."""
    if case == "ell":
        fg = _ell_chain()
    elif case == "no_planar":
        fg = _no_planar()
    else:  # one robot chain's state against a block of 16 bytes
        fg = _pair("robot10")[1]
        monkeypatch.setattr(logpot, "K5_SMEM_LIMIT", 16)
    assert logpot.logpot_plan(fg) is None or case == "shared_memory"
    with pytest.raises(NotImplementedError, match=match):
        logpot.kernel_plan(fg)


def test_auto_on_cuda_tensors_is_the_kernel_plan():
    """On CUDA tensors ``plan="auto"`` is K5's own (cached) plan: a grid
    over the reference's gate gets one, and a graph K5 cannot run raises
    instead of running autograd. On CPU tensors it stays the autograd
    path. (The routing reads only ``x.is_cuda``; a stand-in carries it.)"""
    on_card = types.SimpleNamespace(is_cuda=True)
    _, fg = _pair("denoise16")
    plan = logpot._resolve_plan(fg, "auto", on_card)
    assert plan is not None and plan is logpot.logpot_plan_cached(fg)
    assert logpot._resolve_plan(fg, "auto", torch.zeros(1)) is None
    for bad in (_ell_chain(), _no_planar()):
        with pytest.raises(NotImplementedError):
            logpot._resolve_plan(bad, "auto", on_card)
        assert logpot._resolve_plan(bad, "auto", torch.zeros(1)) is None


@functools.lru_cache(maxsize=None)
def _port(name):
    """The port's compile of a model alone (no reference compile)."""
    kw = {"fuse_quadratic": False} if name in _UNFUSED else {}
    return lt.compile_graph(MODELS[name](PORT), "cpu", **kw)


_K5_GRAPHS = ["robot10", "robot100", "robot150", "denoise6", "denoise11",
              "denoise16"]


@pytest.mark.parametrize("C", [1, 13, 4099, 16384])
@pytest.mark.parametrize("name", _K5_GRAPHS)
def test_k5_launch_covers_every_chain_within_shared_memory(name, C):
    """K5's geometry (``k5_launch``) on the robot and denoising graphs:
    blocks of a power-of-two number of chains (at most 32, and no more
    than C needs) cover every chain exactly once, threads are whole warps
    (at most 1,024), and the shared bytes are the kernel's reckoning
    (``_k5_smem``), within 227 KB. At the main shapes the tile is 32
    chains: 14 warps on robot_map(100) (one colour of 14 rows) with the
    tables and J staged, 32 warps on the 11×11 grid."""
    plan = logpot.kernel_plan(_port(name))
    geo = logpot.k5_launch(plan, C)
    blocks = -(-C // geo.chains)
    assert geo.chains & (geo.chains - 1) == 0 and 1 <= geo.chains <= 32
    assert geo.chains < 2 * C
    assert blocks * geo.chains >= C > (blocks - 1) * geo.chains
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
    assert geo.smem == logpot._k5_smem(plan, geo.threads, geo.chains,
                                       geo.stage, geo.j_smem)
    assert geo.smem <= logpot.K5_SMEM_LIMIT
    assert logpot.k5_launch(plan, C) is geo
    if C >= 4099:
        assert geo.chains == 32
    if (name, C) == ("robot100", 16384):
        assert geo.threads == 14 * 32 and geo.stage and geo.j_smem
    if name == "denoise11" and C >= 4099:
        assert geo.threads == 1024 and geo.stage


def _sized_plan(n, L, has_quad):
    """A stand-in plan with the sizes ``k5_launch`` reads: n latents, one
    bucket of 64 rows in one colour, tapes of L nodes, 2 slots."""
    return types.SimpleNamespace(
        n_cont=n, n_rows=64, acm=2, pm=2, tape_pack=torch.zeros((L, 4)),
        buckets=[None], seg_list=[(0, 0, 64)], color_list=[0, 1, 1],
        n_colors=1, max_tape=L, has_quad=has_quad, launch_cache={})


@pytest.mark.parametrize("n", [1, 121, 1408, 2048])
def test_k5_launch_over_tape_lengths(n):
    """Every tape length the tracer admits (1–128 nodes), at latent counts
    up to the widest the reference's gate can admit (its estimate pads to
    2,048 lanes without a quadratic form and to 1,408 with one): one chain
    and one warp fit K5's shared memory (``kernel_plan``'s admission), and
    the tile ``k5_launch`` picks at C ∈ {1, 13, 4,099, 16,384} covers every
    chain within 227 KB."""
    for L in range(1, MAX_NODES + 1):
        plan = _sized_plan(n, L, has_quad=n <= 1408)
        assert logpot._k5_smem(plan, 32, 1, False, False) <= \
            logpot.K5_SMEM_LIMIT
        for C in (1, 13, 4099, 16384):
            geo = logpot.k5_launch(plan, C)
            assert -(-C // geo.chains) * geo.chains >= C
            assert geo.threads % 32 == 0 and geo.threads <= 1024
            assert geo.smem <= logpot.K5_SMEM_LIMIT


@pytest.mark.parametrize("name", ["robot10", "robot24", "robot100",
                                  "robot150", "denoise6", "denoise11",
                                  "denoise12", "denoise16", "friends4",
                                  "hybrid_chain", "tied_and_valued",
                                  "planar_a", "planar_b"])
def test_kernel_plan_admits_the_reference_gate_and_main_graphs(name):
    """K5's plan exists wherever the reference's gate admits a graph, on
    the robot maps (10, 100, 150 segments) and the 6×6, 11×11 and 16×16
    denoising grids, and on the 12×12 grid past that gate, with a launch
    geometry at 4,099 chains."""
    fg = _port(name)
    assert (logpot.logpot_plan(fg) is not None or name in _K5_GRAPHS
            or name == "denoise12")
    plan = logpot.kernel_plan(fg)
    assert plan is not None
    assert logpot.k5_launch(plan, 4099).smem <= logpot.K5_SMEM_LIMIT
