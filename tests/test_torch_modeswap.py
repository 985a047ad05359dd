"""The port's collapsed orbit-flip move (``lhvi_tpu_torch/engines/modeswap.py``)
and its wiring into HMC, NUTS and SMC, held to the JAX reference
(``lhvi_tpu/engines/modeswap.py``) on the CPU.

Deterministic:
- the plan equals the reference's where the IRs match table for table
  (the spin clique and an uncoupled class through ``compile_graph``), and
  matches by key on the 16-person pod model through each package's
  ``fast_compile`` (members, F, the direct rows and their weights);
- ``_direct_lp`` and the collapsed ``delta`` on identical ``(xc, xd,
  xd_p)`` within rtol 1e-5, the reference's side from its own
  ``planned_logits``, ``_direct_lp`` and ``logsumexp``;
- ``color_plan_bytes``' structure (groups, colours, widths, element
  counts; the port's int64 tables make its bytes differ).

Statistical (torch's Philox cannot reproduce threefry): the move under
HMC, NUTS and SMC against exact enumeration, the ``every`` gate and the
pod clique's unlock, at tests/test_modeswap.py's thresholds.

Port-only pins of the two deliberate divergences (ROADMAP Queue 3): a
masked variable whose logits are all −inf gives no NaN in ``delta``; a
NaN in a weighted direct row makes ``delta`` NaN, so the move rejects.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lhvi_tpu as ref_pkg  # noqa: E402
import lhvi_tpu.engines.modeswap as ref_ms  # noqa: E402
import lhvi_tpu.potentials as ref_pot  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.engines.hmc import planned_logits as ref_planned_logits  # noqa: E402
from lhvi_tpu.fg.compile import color_plan_bytes as ref_color_plan_bytes  # noqa: E402
from lhvi_tpu.models.relational import friends_smokers as ref_fs  # noqa: E402
from lhvi_tpu.relational.fast import fast_compile as ref_fast_compile  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.potentials as pot  # noqa: E402
from lhvi_tpu_torch.engines import hmc, modeswap, nuts, smc  # noqa: E402
from lhvi_tpu_torch.fg.compile import color_plan_bytes  # noqa: E402
from lhvi_tpu_torch.models.relational import friends_smokers  # noqa: E402
from lhvi_tpu_torch.relational.fast import fast_compile  # noqa: E402
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402

# the DSL of each package: (Domain, RV, F, Graph, MLNPotential, leq)
REF = (ref_pkg.Domain, ref_pkg.RV, ref_pkg.F, ref_pkg.Graph,
       ref_pot.MLNPotential, ref_pot.leq)
PORT = (lt.Domain, lt.RV, lt.F, lt.Graph, pot.MLNPotential, pot.leq)


def spin_clique(dsl, n=4, w=2.5, bias=0.4, extra=()):
    """tests/test_modeswap.py:22-36's clique in one package's classes: n
    exchangeable binary spins, all-pairs ferromagnetic coupling w, a
    shared bias toward 1. ``extra`` lists functions that return more
    (rvs, factors) to append."""
    Domain, RV, F, Graph, MLN, leq = dsl
    dom = Domain([0, 1])
    spins = [RV(dom, name=f"s{i}") for i in range(n)]
    fs = [F(MLN(lambda a: leq(a[0], a[1]), w=w), [spins[i], spins[j]])
          for i in range(n) for j in range(i + 1, n)]
    fs += [F(MLN(lambda a: a[0], w=bias), [s]) for s in spins]
    rvs = list(spins)
    for build in extra:
        more_rvs, more_fs = build(dsl, spins)
        rvs += more_rvs
        fs += more_fs
    return Graph(rvs, fs)


def _spin_pair(**kw):
    return spin_clique(REF, **kw), spin_clique(PORT, **kw)


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


# ---- the plan -----------------------------------------------------------


def test_plan_equals_reference_spin_clique():
    """tests/test_modeswap.py:39-53: one group of the four spins, F empty,
    every real row in the direct term; the port's plan equals the
    reference's field for field."""
    g_ref, g = _spin_pair()
    ref_fg, fg = ref_compile(g_ref), lt.compile_graph(g, "cpu")
    ref, plan = ref_ms.build_mode_swap_plan(ref_fg), modeswap.build_mode_swap_plan(fg)
    assert (plan.n_groups, plan.n_vars, plan.has_f, plan.direct_buckets) == (
        ref.n_groups, ref.n_vars, ref.has_f, ref.direct_buckets)
    np.testing.assert_array_equal(_np(plan.vars_), _np(ref.vars_))
    np.testing.assert_array_equal(np.array(plan.vmax), _np(ref.vmax))
    np.testing.assert_array_equal(_np(plan.f_mask), _np(ref.f_mask))
    for w, rw in zip(plan.w_direct, ref.w_direct):
        np.testing.assert_array_equal(_np(w), _np(rw))
    assert plan.direct_buckets == fg.disc_bucket_idx
    assert sorted(_np(plan.vars_)[0].tolist()) == [0, 1, 2, 3]


def test_plan_skips_uncoupled_classes():
    """tests/test_modeswap.py:56-63: independent spins get no plan (in
    both packages), and the engines then warn and run plain Gibbs."""
    def uncoupled(dsl):
        Domain, RV, F, Graph, MLN, _ = dsl
        spins = [RV(Domain([0, 1]), name=f"u{i}") for i in range(4)]
        return Graph(spins, [F(MLN(lambda a: a[0], w=0.7), [s])
                             for s in spins])

    fg = lt.compile_graph(uncoupled(PORT), "cpu")
    assert ref_ms.build_mode_swap_plan(ref_compile(uncoupled(REF))) is None
    assert modeswap.build_mode_swap_plan(fg) is None
    with pytest.warns(UserWarning, match="no-op"):
        _, _, diag = hmc.run_hmc(fg, torch.Generator().manual_seed(0),
                                 hmc.HMCConfig(mode_swap=True), n_chains=4,
                                 n_warmup=2, n_samples=3)
    assert "mode_swap_accept" not in diag


def _pod(fs, n=16, observed=4):
    rg = fs(n_people=n, hybrid=True)
    for i in range(observed):
        rg.observe("smokes", (f"p{i}",), i % 2)
    return rg


@pytest.fixture(scope="module")
def pod16():
    """The 16-person pod model through each package's ``fast_compile``,
    with each package's plan and the keys of its latent slots."""
    rg_ref, rg = _pod(ref_fs), _pod(friends_smokers)
    ref_fg, fg = ref_fast_compile(rg_ref), fast_compile(rg, "cpu")
    _, index = rg.ground()

    def keys(f):
        out = {"c": [None] * f.n_cont, "d": [None] * f.n_disc}
        for key in index:
            try:
                kind, i = f.meta.loc(key)
            except KeyError:  # not referenced by any ground factor
                continue
            if kind in out:
                out[kind][i] = key
        return out

    return (ref_fg, ref_ms.build_mode_swap_plan(ref_fg), keys(ref_fg),
            fg, modeswap.build_mode_swap_plan(fg), keys(fg))


def _plan_by_key(fg, plan, keys):
    """Per group: member keys, F keys, and the direct rows as (bucket
    kind, latent slot keys, weight), sorted."""
    out = []
    vars_, fm = _np(plan.vars_), _np(plan.f_mask)
    for g in range(plan.n_groups):
        members = {keys["d"][v] for v in vars_[g] if v < fg.n_disc}
        f_keys = {keys["d"][v] for v in np.flatnonzero(fm[g])}
        rows = []
        for w, bi in zip(plan.w_direct, plan.direct_buckets):
            np_b = fg.meta.np_buckets[bi]
            wg = _np(w)[g]
            for r in np.flatnonzero(wg):
                sl = tuple(keys["c"][i] for i, m in zip(
                    np_b["cont_idx"][r], np_b["cont_mask"][r]) if m > 0)
                sl += tuple(keys["d"][i] for i, m in zip(
                    np_b["disc_idx"][r], np_b["disc_mask"][r]) if m > 0)
                rows.append((fg.buckets[bi].kind, sl, float(wg[r])))
        out.append((members, f_keys, sorted(rows)))
    return out


def test_plan_matches_reference_by_key_pod16(pod16):
    """tests/test_modeswap.py:66-100 on the port: F is independent (no
    two members share a real row), the direct rows are exactly the real
    rows touching G and no F member, and groups, F and direct rows equal
    the reference's key for key."""
    ref_fg, ref, ref_keys, fg, plan, keys = pod16
    assert plan is not None and plan.n_groups == ref.n_groups
    assert plan.has_f == ref.has_f
    assert _plan_by_key(fg, plan, keys) == _plan_by_key(ref_fg, ref, ref_keys)
    fm = _np(plan.f_mask)
    for gi in range(plan.n_groups):
        fset = np.concatenate([fm[gi], np.zeros(1, bool)])
        for np_b in fg.meta.np_buckets:
            real = np_b["scale"] > 0
            didx = np.where(np_b["disc_mask"] > 0, np_b["disc_idx"], fg.n_disc)
            assert (fset[didx[real]].sum(axis=1) <= 1).all()
    # the F cells list exactly the colour classes holding an F member
    for gi, cells in enumerate(plan.f_cells):
        held = set()
        for ci, j in cells:
            v = _np(fg.color_plan.groups[ci].vars_[j])
            held |= set(v[v < fg.n_disc].tolist())
        assert set(np.flatnonzero(fm[gi]).tolist()) <= held


def _ref_delta(ref_fg, plan, g, xc, xd, xd_p, beta):
    """The reference's collapsed log-ratio (modeswap.py:313-360) from its
    own planned_logits (disc_logits without a colour plan), _direct_lp and
    logsumexp."""
    V = ref_fg.max_v
    valid = jnp.arange(V)[None, :] < ref_fg.disc_sizes[:, None]

    def temper(L):
        return jnp.where(valid[None], beta * L, -1e30)

    fm = plan.f_mask[g]
    lse = jax.scipy.special.logsumexp
    if plan.has_f:
        pl = jax.vmap(ref_fg.disc_logits if ref_fg.color_plan is None
                      else lambda c, d: ref_planned_logits(ref_fg, c, d))
        S = jnp.sum(fm[None] * lse(temper(pl(xc, xd)), axis=-1), axis=-1)
        Sp = jnp.sum(fm[None] * lse(temper(pl(xc, xd_p)), axis=-1), axis=-1)
    else:
        S = Sp = jnp.zeros(xc.shape[0])
    w = [t[g] for t in plan.w_direct]
    d0 = ref_ms._direct_lp(ref_fg, xc, xd, w, plan.direct_buckets)
    d1 = ref_ms._direct_lp(ref_fg, xc, xd_p, w, plan.direct_buckets)
    delta = np.asarray((Sp - S) + beta * (d1 - d0))
    # the size of the terms delta is the difference of: its f32 rounding
    scale = float(np.max(np.abs(np.asarray(S)))
                  + beta * np.max(np.abs(np.asarray(d0))))
    return np.asarray(d0), np.asarray(d1), delta, scale


def _states(fg, plan, C, seed):
    """Random (xc, xd) and the flipped xd_p of group 0 (a ↔ b per chain)."""
    rng = np.random.default_rng(seed)
    xc = rng.normal(size=(C, fg.n_cont)).astype(np.float32)
    xd = rng.integers(0, 2, size=(C, fg.n_disc)).astype(np.int64)
    member = _np(plan.member)[0]
    xd_p = np.where(member[None], 1 - xd, xd)
    return xc, xd, xd_p


@pytest.mark.parametrize("beta", [1.0, 0.4])
@pytest.mark.parametrize("which", ["spin_clique", "pod16"])
def test_direct_lp_and_delta_match_reference(which, beta, pod16):
    """Identical (xc, xd, xd_p): ``_direct_lp`` within rtol 1e-5, and
    ``delta`` within 1e-5 of the size of the sums it is the difference of
    (Σ_F logsumexp and the direct term: f32 rounding of a difference). On
    the pod model the port reads F's logits from the colour cells that
    hold F only."""
    if which == "pod16":
        ref_fg, ref, _, fg, plan, _ = pod16
    else:
        g_ref, g = _spin_pair(extra=[_neighbor])
        ref_fg, fg = ref_compile(g_ref), lt.compile_graph(g, "cpu")
        ref = ref_ms.build_mode_swap_plan(ref_fg)
        plan = modeswap.build_mode_swap_plan(fg)
        assert plan.has_f
    xc, xd, xd_p = _states(fg, plan, 6, 7)
    d0, d1, want, scale = _ref_delta(ref_fg, ref, 0, jnp.asarray(xc),
                              jnp.asarray(xd, jnp.int32),
                              jnp.asarray(xd_p, jnp.int32), beta)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    w = [x[0] for x in plan.w_direct]
    for got, ref_v, xs in ((modeswap._direct_lp(fg, t(xc), t(xd), w,
                                                plan.direct_buckets), d0, xd),
                           (modeswap._direct_lp(fg, t(xc), t(xd_p), w,
                                                plan.direct_buckets), d1, xd_p)):
        np.testing.assert_allclose(got.numpy(), ref_v, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(ref_v).max()))
    delta, _ = modeswap.collapsed_delta(fg, t(xc), t(xd), t(xd_p), plan, 0,
                                        beta)
    np.testing.assert_allclose(delta.numpy(), want, rtol=1e-5,
                               atol=1e-5 * (1 + scale))


def _neighbor(dsl, spins):
    """A binary neighbour of spin 0 with other values (0, 2): outside the
    spins' domain class, so it lands in F."""
    Domain, RV, F, _, MLN, leq = dsl
    f = RV(Domain([0, 2]), name="f")
    return [f], [F(MLN(lambda a: leq(a[0], a[1]), w=0.8), [spins[0], f])]


def test_color_plan_bytes_matches_reference_structure(pod16):
    """Groups, colours and widths equal the reference's, and so do the
    element counts of each group's tables (the bytes differ: the port's
    integer tables are int64)."""
    ref_fg, _, _, fg, _, _ = pod16
    got, want = color_plan_bytes(fg), ref_color_plan_bytes(ref_fg)
    assert got["n_groups"] == want["n_groups"]
    for a, b, grp in zip(got["per_group"], want["per_group"],
                         ref_fg.color_plan.groups):
        assert (a["n_colors"], a["n_vars"]) == (b["n_colors"], b["n_vars"])
        leaves = jax.tree_util.tree_leaves(
            (grp.vars_, grp.sizes, grp.vals_, grp.bucket_tabs))
        assert a["n_elements"] == sum(int(x.size) for x in leaves)
    assert got["total_bytes"] == sum(g["bytes"] for g in got["per_group"])
    assert got["total_bytes"] >= want["total_bytes"]


# ---- the move on the samplers, against enumeration ------------------------


def _spin(n=4, w=2.5, bias=0.4):
    g = spin_clique(PORT, n, w, bias)
    return g, g.rvs, ExactPosterior(g), lt.compile_graph(g, "cpu")


@pytest.mark.parametrize("w,bias,seed,atol", [(2.5, 0.4, 3, 0.04),
                                              (6.0, 0.25, 4, 0.05)])
def test_hmc_mode_swap_matches_enumeration(w, bias, seed, atol):
    """tests/test_modeswap.py:103-144: marginals of the locked clique
    within 0.04 (w = 2.5) and 0.05 (w = 6, where plain Gibbs never
    crosses and the exact answer mixes the two modes)."""
    g, spins, exact, fg = _spin(4, w, bias)
    res = hmc.sample(fg, torch.Generator().manual_seed(seed), n_chains=1024,
                     n_warmup=30, n_samples=120, collect="moments",
                     cfg=hmc.HMCConfig(mode_swap=True))
    assert float(res.diag["mode_swap_accept"]) > 0.05
    for s in spins:
        np.testing.assert_allclose(res.disc_marginal(s),
                                   exact.disc_marginal(s), atol=atol)
    assert 0.15 < exact.disc_marginal(spins[0])[1] < 0.85


def test_hmc_mode_swap_every_gate():
    """tests/test_modeswap.py:147-166: ``mode_swap_every=3`` stays exact
    (within 0.06) and the acceptance per application is still tracked.
    The gate fires on about a third of the transitions."""
    g, spins, exact, fg = _spin(4, 6.0, 0.25)
    res = hmc.sample(fg, torch.Generator().manual_seed(11), n_chains=1024,
                     n_warmup=30, n_samples=120, collect="moments",
                     cfg=hmc.HMCConfig(mode_swap=True, mode_swap_every=3))
    p1 = res.disc_marginal(spins[0])[1]
    assert abs(p1 - exact.disc_marginal(spins[0])[1]) < 0.06
    assert float(res.diag["mode_swap_accept"]) > 0.02
    gate = modeswap.gate_generator(torch.Generator().manual_seed(0))
    cfg = hmc.HMCConfig(mode_swap=True, mode_swap_every=3)
    fg2 = hmc._ensure_mode_swap_plan(fg, cfg)[0]
    xc, xd = fg2.init_state_batched(torch.Generator().manual_seed(1), 8)
    n = sum(modeswap.maybe_mode_swap(fg2, cfg, torch.Generator(), gate, xc,
                                     xd)[2] for _ in range(300))
    assert 70 < n < 130, n


def test_nuts_and_smc_mode_swap_match_enumeration():
    """tests/test_modeswap.py:169-233: NUTS-within-Gibbs (w = 5, within
    0.06) and SMC's tempered move (w = 4, within 0.05)."""
    g, spins, exact, fg = _spin(4, 5.0, 0.3)
    res = nuts.sample(fg, torch.Generator().manual_seed(9), n_chains=1024,
                      n_warmup=30, n_samples=120, collect="moments",
                      cfg=nuts.NUTSConfig(mode_swap=True))
    assert abs(res.disc_marginal(spins[0])[1]
               - exact.disc_marginal(spins[0])[1]) < 0.06
    assert float(res.diag["mode_swap_accept"]) > 0.02
    g, spins, exact, fg = _spin(4, 4.0, 0.3)
    res = smc.sample(fg, torch.Generator().manual_seed(7),
                     smc.SMCConfig(n_particles=2048, n_temps=25, n_moves=2,
                                   mode_swap=True))
    for s in spins:
        np.testing.assert_allclose(res.disc_marginal(s),
                                   exact.disc_marginal(s), atol=0.05)


def test_pod_clique_unlocks(pod16):
    """tests/test_modeswap.py:269-292: at 16 people without the move some
    free smokes latents freeze per chain at values that disagree across
    chains; with it that set is empty (same budget, same seed)."""
    fg = pod16[3]

    def frozen_disagreeing(mode_swap):
        _, xd, _ = hmc.run_hmc(
            fg, torch.Generator().manual_seed(0),
            hmc.HMCConfig(n_leapfrog=4, mode_swap=mode_swap),
            n_chains=8, n_warmup=40, n_samples=120, collect="samples")
        xd = xd.numpy()
        frozen = (xd.var(axis=0) == 0).all(axis=0)
        return int((frozen & (xd[0].std(axis=0) > 0)).sum())

    assert frozen_disagreeing(False) > 0
    assert frozen_disagreeing(True) == 0


# ---- the two deliberate divergences --------------------------------------


def _dead_var(dsl, spins):
    """A variable touching nothing of the clique whose only factor is −inf
    at every value (a scale of 1e9 overflows f32): its logits are all
    −inf."""
    Domain, RV, F, _, MLN, _ = dsl
    z = RV(Domain([0, 3]), name="z")  # outside the spins' domain class
    return [z], [F(MLN(lambda a: a[0] * 0.0 - math.inf, w=1.0,
                       formula_name="dead"), [z])]


def test_masked_all_neg_inf_logits_give_no_nan():
    """Fault 1 (reference modeswap.py:351-352): a masked-out variable
    whose tempered logits are all −inf. The reference's ``fmask · lse``
    gives 0·(−inf) = NaN; the port's ``where`` gives the finite delta of
    the graph without it."""
    g_ref, g = _spin_pair(extra=[_neighbor, _dead_var])
    scales_ref = {id(g_ref.factors[-1]): 1e9}
    scales = {id(g.factors[-1]): 1e9}
    ref_fg = ref_compile(g_ref, scales=scales_ref, gibbs_plan=False)
    fg = lt.compile_graph(g, "cpu", scales=scales)
    fg = __import__("dataclasses").replace(fg, color_plan=None)
    plan = modeswap.build_mode_swap_plan(fg)
    ref = ref_ms.build_mode_swap_plan(ref_fg)
    assert plan.has_f and not _np(plan.f_mask)[0, -1]
    xc, xd, xd_p = _states(fg, plan, 6, 3)
    L = fg.disc_logits(torch.from_numpy(xc), torch.from_numpy(xd))
    assert torch.isinf(L[:, -1]).all()
    _, _, want, _ = _ref_delta(ref_fg, ref, 0, jnp.asarray(xc),
                            jnp.asarray(xd, jnp.int32),
                            jnp.asarray(xd_p, jnp.int32), 1.0)
    assert np.isnan(want).all()
    delta, _ = modeswap.collapsed_delta(
        fg, torch.from_numpy(xc), torch.from_numpy(xd), torch.from_numpy(xd_p),
        plan, 0, 1.0)
    assert torch.isfinite(delta).all()
    # the same as the graph without the dead variable
    g2 = spin_clique(PORT, extra=[_neighbor])
    fg2 = lt.compile_graph(g2, "cpu")
    fg2 = __import__("dataclasses").replace(fg2, color_plan=None)
    d2, _ = modeswap.collapsed_delta(
        fg2, torch.from_numpy(xc), torch.from_numpy(xd[:, :-1]),
        torch.from_numpy(xd_p[:, :-1]), modeswap.build_mode_swap_plan(fg2),
        0, 1.0)
    np.testing.assert_allclose(delta.numpy(), d2.numpy(), rtol=1e-6)


def test_nan_in_a_weighted_direct_row_rejects():
    """Fault 2 (reference modeswap.py:284): a NaN in a weighted direct row.
    The reference's ``nan_to_num`` counts it as 0 (neutral); the port
    keeps it NaN, so ``log u < NaN`` rejects and no chain moves."""
    def nan_row(dsl, spins):
        _, _, F, _, MLN, _ = dsl
        return [], [F(MLN(lambda a: a[0] * math.nan, w=1.0,
                          formula_name="nan_bias"), [spins[3]])]

    g_ref, g = _spin_pair(w=1.0, extra=[nan_row])
    ref_fg, fg = ref_compile(g_ref), lt.compile_graph(g, "cpu")
    plan, ref = modeswap.build_mode_swap_plan(fg), ref_ms.build_mode_swap_plan(ref_fg)
    xc, xd, xd_p = _states(fg, plan, 64, 5)
    _, _, want, _ = _ref_delta(ref_fg, ref, 0, jnp.asarray(xc),
                            jnp.asarray(xd, jnp.int32),
                            jnp.asarray(xd_p, jnp.int32), 1.0)
    assert np.isfinite(want).all()
    delta, _ = modeswap.collapsed_delta(
        fg, torch.from_numpy(xc), torch.from_numpy(xd), torch.from_numpy(xd_p),
        plan, 0, 1.0)
    assert torch.isnan(delta).all()
    xd_t = torch.from_numpy(xd)
    out, acc = modeswap.mode_swap_sweep(fg, torch.Generator().manual_seed(0),
                                        torch.from_numpy(xc), xd_t, plan)
    assert float(acc) == 0.0 and torch.equal(out, xd_t)
