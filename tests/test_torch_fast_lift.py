"""The port's array-IR path (``relational/fast.py::fast_compile``,
``lift/fast.py::refine_ir``/``fast_lift``, ``vi.infer_c2f_fast``) held to
the JAX reference and to the port's own object path.

The host code is the reference's numpy code (64-bit hash folds in
``uint64``), so the tables of ``fast_compile`` and ``fast_lift`` and the
partitions of ``refine_ir`` are EQUAL to the reference's. Against the
port's ``compile_graph`` (the reference's tests/test_fuzz_fast_compile.py
on the port): log-probabilities at mapped states within rtol 1e-5, atol
1e-5, discrete full-conditional logits and the colour plan's logits within
1e-4. The rest are the reference's tests/test_fast_lift.py (without its
LBP case) and the ``infer_c2f_fast`` cases of test_c2f.py on the port, at
their thresholds.
"""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lhvi_tpu.lift.fast import fast_lift as ref_fast_lift  # noqa: E402
from lhvi_tpu.lift.fast import refine_ir as ref_refine_ir  # noqa: E402
from lhvi_tpu.models.relational import friends_smokers as ref_fs  # noqa: E402
from lhvi_tpu.relational.fast import fast_compile as ref_fast_compile  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
from lhvi_tpu_torch import Domain  # noqa: E402
from lhvi_tpu_torch.engines import vi  # noqa: E402
from lhvi_tpu_torch.engines.hmc import planned_logits  # noqa: E402
from lhvi_tpu_torch.lift.color import color_refine, lifting_report  # noqa: E402
from lhvi_tpu_torch.lift.fast import fast_lift, fast_lifting_report, refine_ir  # noqa: E402
from lhvi_tpu_torch.models.relational import (  # noqa: E402
    friends_smokers,
    robot_map,
    robot_scan_evidence,
)
from lhvi_tpu_torch.potentials import MLNPotential, TablePotential  # noqa: E402
from lhvi_tpu_torch.relational.data import load_evidence  # noqa: E402
from lhvi_tpu_torch.relational.fast import fast_compile  # noqa: E402
from lhvi_tpu_torch.relational.graph import RelationalGraph  # noqa: E402
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402

from test_fuzz_compile import _rand_graph  # noqa: E402
from test_fuzz_lift import _k_copies  # noqa: E402
from test_torch_compile import _mirror  # noqa: E402
from test_torch_lift import _broadcast  # noqa: E402


def _fs(fs, n, observed=3):
    rg = fs(n_people=n, hybrid=True)
    for i in range(observed):
        rg.observe("smokes", (f"p{i}",), i % 2)
    return rg


def _assert_tables_equal(fg, ref, what):
    """Host mirrors, global tables and the device tensors of the port equal
    the reference's (index tables int64 here, int32 there)."""
    for attr in ("n_cont", "n_disc", "max_v", "n_colors", "has_quad",
                 "lp_bucket_idx"):
        assert getattr(fg, attr) == getattr(ref, attr), (what, attr)
    assert len(fg.buckets) == len(ref.buckets)
    for i, (b, rb) in enumerate(zip(fg.meta.np_buckets, ref.meta.np_buckets)):
        assert set(b) == set(rb)
        for k in b:
            pairs = ([(b[k][p], rb[k][p]) for p in b[k]] if k == "params"
                     else [(b[k], rb[k])])
            for x, y in pairs:
                np.testing.assert_array_equal(x, y, err_msg=(what, i, k))
        tb, rtb = fg.buckets[i], ref.buckets[i]
        assert (tb.pattern, tb.cont_lat, tb.disc_lat) == (
            rtb.pattern, rtb.cont_lat, rtb.disc_lat)
        assert (tb.kernel_planar is None) == (rtb.kernel_planar is None)
        np.testing.assert_array_equal(tb.disc_idx.numpy(), b["disc_idx"])
        np.testing.assert_array_equal(tb.scale.numpy(), b["scale"])
    assert set(fg.meta.np_global) == set(ref.meta.np_global)
    for k, v in fg.meta.np_global.items():
        np.testing.assert_array_equal(v, ref.meta.np_global[k], err_msg=k)


@pytest.mark.parametrize("n", [6, 12])
def test_fast_compile_and_fast_lift_tables_equal_reference(n):
    """``fast_compile``, ``refine_ir`` (truncated and at the fixpoint) and
    ``fast_lift`` give the reference's tables exactly."""
    ref = ref_fast_compile(_fs(ref_fs, n))
    fg = fast_compile(_fs(friends_smokers, n), "cpu")
    _assert_tables_equal(fg, ref, "fast_compile")
    for rounds in (1, 2, 10_000):
        got, want = refine_ir(fg, rounds), ref_refine_ir(ref, rounds)
        for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
            np.testing.assert_array_equal(a, b)
        lifted = fast_lift(fg, max_rounds=rounds)
        _assert_tables_equal(lifted, ref_fast_lift(ref, max_rounds=rounds),
                             ("fast_lift", rounds))
        np.testing.assert_array_equal(lifted.meta._c, want[0])


def test_fast_compile_queries_by_key():
    fg = fast_compile(_fs(friends_smokers, 6), "cpu")
    assert fg.meta.loc(("smokes", ("p0",))) == ("obs", -1)
    assert fg.meta.obs_value(("smokes", ("p1",))) == 1.0
    kind, i = fg.meta.loc(("cancer", ("p1",)))
    assert kind == "d" and 0 <= i < fg.n_disc
    assert fg.meta.value_index(("cancer", ("p1",)), 1) == 1
    assert fg.meta.disc_size(("cancer", ("p1",))) == 2
    with pytest.raises(TypeError):
        fg.meta.loc("cancer")


# --- tests/test_fuzz_fast_compile.py on the port --------------------------


def _mapping(index, fg_obj, fg_fast):
    """Permutations mapping object-path latent slots -> fast-path slots."""
    cont = np.zeros(fg_obj.n_cont, np.int64)
    disc = np.zeros(fg_obj.n_disc, np.int64)
    for key, rv in index.items():
        kind_o, i_o = fg_obj.meta.loc(rv)
        kind_f, i_f = fg_fast.meta.loc(key)
        assert kind_o == kind_f, (key, kind_o, kind_f)
        if kind_o == "c":
            cont[i_o] = i_f
        elif kind_o == "d":
            disc[i_o] = i_f
    return cont, disc


def _check_equivalent(rg, index_graph, seed):
    g, index = index_graph
    fg_o = lt.compile_graph(g, "cpu", fuse_quadratic=False)
    fg_f = fast_compile(rg, "cpu")
    assert fg_f.n_cont == fg_o.n_cont and fg_f.n_disc == fg_o.n_disc
    cont, disc = _mapping(index, fg_o, fg_f)

    rng = np.random.default_rng(seed)
    for _ in range(3):
        xc_o = rng.normal(size=fg_o.n_cont).astype(np.float32)
        xd_o = (rng.integers(0, fg_o.disc_sizes.numpy()) if fg_o.n_disc
                else np.zeros(0, np.int64))
        xc_f = np.zeros(fg_f.n_cont, np.float32)
        xd_f = np.zeros(fg_f.n_disc, np.int64)
        xc_f[cont] = xc_o
        xd_f[disc] = xd_o
        to = lambda a: torch.as_tensor(a)  # noqa: E731
        lo = float(fg_o.log_prob(to(xc_o), to(xd_o).long()))
        lf = float(fg_f.log_prob(to(xc_f), to(xd_f)))
        np.testing.assert_allclose(lf, lo, rtol=1e-5, atol=1e-5)
        if fg_o.n_disc:
            V = min(fg_o.max_v, fg_f.max_v)
            lg_o = fg_o.disc_logits(to(xc_o), to(xd_o).long()).numpy()
            lg_f = fg_f.disc_logits(to(xc_f), to(xd_f)).numpy()
            np.testing.assert_allclose(lg_f[disc][:, :V], lg_o[:, :V],
                                       rtol=1e-4, atol=1e-4)

    # the fast path's own Gibbs colour plan reproduces its disc_logits
    if fg_f.n_disc and fg_f.color_plan is not None:
        xc = torch.zeros((fg_f.n_cont,))
        xd = torch.zeros((fg_f.n_disc,), dtype=torch.int64)
        lg_a = planned_logits(fg_f, xc, xd).numpy()
        lg_b = fg_f.disc_logits(xc, xd).numpy()
        big = lg_b < -1e29
        np.testing.assert_allclose(np.where(big, 0.0, lg_a),
                                   np.where(big, 0.0, lg_b),
                                   rtol=1e-4, atol=1e-4)


def _build_from_generator(rng):
    """The random model family of tests/test_fuzz_fast_compile.py, in the
    port's classes (the same rng calls, so one seed gives one model)."""
    rg = RelationalGraph()
    n_sorts = int(rng.integers(1, 3))
    sort_consts = {}
    sorts = []
    for s in range(n_sorts):
        consts = [f"s{s}c{i}" for i in range(int(rng.integers(2, 5)))]
        sort_consts[f"S{s}"] = consts
        sorts.append(f"S{s}")

    bool_dom = Domain([0, 1])
    cont_dom = Domain([-5, 5], continuous=True)
    preds = []
    for p in range(int(rng.integers(2, 4))):
        arity = int(rng.integers(1, 3))
        dom = bool_dom if rng.integers(0, 2) else cont_dom
        preds.append(rg.predicate(f"P{p}", dom, arity=arity))

    lv_of = {}
    for t in range(int(rng.integers(1, 4))):
        n_atoms = int(rng.integers(1, 3))
        atoms, var_names = [], []
        for a in range(n_atoms):
            pred = preds[int(rng.integers(0, len(preds)))]
            args = []
            for sl in range(pred.arity):
                sort = lv_of.setdefault(
                    (pred.name, sl), sorts[int(rng.integers(0, len(sorts)))])
                vn = (f"t{t}_{sort}" if rng.integers(0, 2)
                      else f"t{t}_{sort}_{a}{sl}")
                if vn not in rg.lvs:
                    rg.lv(vn, sort_consts[sort])
                args.append(vn)
                var_names.append((vn, sort))
            atoms.append(pred(*args))
        use_con = bool(rng.integers(0, 2)) and len(
            set(v for v, _ in var_names)) > 1
        con = (lambda sub: len(set(sub.values())) > 1) if use_con else None
        if all(not a.pred.domain.continuous for a in atoms):
            shape = tuple(2 for _ in atoms)
            pot = TablePotential(rng.uniform(0.2, 1.0, size=shape))
        else:
            pot = MLNPotential(
                lambda xs: -sum((x - 0.5) ** 2 for x in xs) / 8.0,
                w=0.7, formula_name=f"f{t}")
        rg.param_factor(pot, atoms, constraint=con)

    p0 = preds[0]
    ev_sorts = [lv_of.get((p0.name, sl)) for sl in range(p0.arity)]
    if all(s is not None for s in ev_sorts):
        combos = list(itertools.product(*[sort_consts[s] for s in ev_sorts]))
        rng.shuffle(combos)
        for consts in combos[: len(combos) // 3]:
            v = (int(rng.integers(0, 2))
                 if not p0.domain.continuous else float(rng.normal()))
            rg.observe(p0, consts, v)
    return rg


@pytest.mark.parametrize("seed", range(8))
def test_fast_compile_matches_object_path_on_fuzzed_models(seed):
    rg = _build_from_generator(np.random.default_rng(7000 + seed))
    _check_equivalent(rg, rg.ground(), seed)


def test_fast_compile_matches_on_friends_smokers():
    rg = _fs(friends_smokers, 6)
    _check_equivalent(rg, rg.ground(), 42)


def test_fast_compile_matches_on_robot_map():
    text, _ = robot_scan_evidence(8, seed=0)
    rg = robot_map(8, evidence=load_evidence(text))
    _check_equivalent(rg, rg.ground(), 43)


# --- tests/test_fast_lift.py on the port (without its LBP case) -----------


def _partition(groups):
    return set(frozenset(s) for s in groups.values())


def _same_partition_as_object_path(g, fg):
    rvc, _ = color_refine(g)
    vcol_c, vcol_d, _ = refine_ir(fg)
    obj = {}
    for rv in g.rvs:
        if rv.observed:
            continue
        kind, i = fg.meta.loc(rv)
        obj.setdefault(rvc[id(rv)], set()).add((kind, i))
    fast = {}
    for i, c in enumerate(vcol_c):
        fast.setdefault(("c", int(c)), set()).add(("c", i))
    for i, c in enumerate(vcol_d):
        fast.setdefault(("d", int(c)), set()).add(("d", i))
    assert _partition(obj) == _partition(fast)


def test_partition_matches_object_path():
    g, _ = _fs(friends_smokers, 8).ground()
    _same_partition_as_object_path(g, lt.compile_graph(g, "cpu"))


@pytest.mark.parametrize("seed", range(6))
def test_partition_matches_on_random_copied_graphs(seed):
    rng = np.random.default_rng(4100 + seed)
    g = _mirror(_k_copies(_rand_graph(rng), int(rng.integers(2, 5))))
    _same_partition_as_object_path(g, lt.compile_graph(g, "cpu"))


@pytest.mark.parametrize("rounds", [1, None])
@pytest.mark.parametrize("seed", range(6))
def test_fast_lift_elbo_equals_grounded(seed, rounds):
    """Truncated (a C2F stage) or at the fixpoint: the lifted ELBO with
    orbit-tied params equals the grounded ELBO, rtol 1e-4, atol 2e-3."""
    rng = np.random.default_rng(4200 + seed)
    g = _mirror(_k_copies(_rand_graph(rng), int(rng.integers(2, 5))))
    fg_g = lt.compile_graph(g, "cpu")
    fg_l = fast_lift(fg_g, max_rounds=10_000 if rounds is None else rounds)
    assert fg_g.n_cont + fg_g.n_disc > 0
    assert fg_l.n_cont + fg_l.n_disc <= fg_g.n_cont + fg_g.n_disc

    cfg = vi.VIConfig(K=3)
    p_l = vi.init_params(fg_l, torch.Generator().manual_seed(seed), cfg)
    p_g = _broadcast(fg_l, fg_g, g, p_l, cfg.K)
    e_l = float(vi.elbo(fg_l, p_l, n_quad=7))
    e_g = float(vi.elbo(fg_g, p_g, n_quad=7))
    np.testing.assert_allclose(e_l, e_g, rtol=1e-4, atol=2e-3)


def test_fast_compile_fast_lift_closed_form():
    """No object graph anywhere: an observed smoker pins P(cancer) =
    σ(1.2) = 0.7685, an observed non-smoker gives exactly 1/2."""
    rg = friends_smokers(n_people=12, hybrid=True)
    rg.observe("smokes", ("p0",), 0)
    rg.observe("smokes", ("p1",), 1)
    fg = fast_lift(fast_compile(rg, "cpu"))

    g, _ = friends_smokers(n_people=12, hybrid=True).ground()
    rep = fast_lifting_report(fast_compile(friends_smokers(
        n_people=12, hybrid=True), "cpu"))
    assert rep["n_rv_orbits"] == lifting_report(g)["n_rv_orbits"]

    res = vi.infer(fg, torch.Generator().manual_seed(0),
                   vi.VIConfig(K=2, n_iters=400, lr=0.08))
    m1 = res.disc_marginal(("cancer", ("p1",)))
    m0 = res.disc_marginal(("cancer", ("p0",)))
    assert abs(m1[1] - 0.7685) < 0.03
    assert abs(m0[1] - 0.5) < 0.03
    assert res.belief(1, ("cancer", ("p1",))) == pytest.approx(m1[1])
    assert res.map(("cancer", ("p1",))) == 1


# --- the infer_c2f_fast cases of tests/test_c2f.py ------------------------


def test_c2f_fast_matches_exact_on_small_mln():
    def model():
        rg = friends_smokers(n_people=3, hybrid=False,
                             w_smokes_cancer=0.7, w_friends=0.4)
        rg.observe("smokes", ("p0",), 1)
        return rg

    fg = fast_compile(model(), "cpu")
    g, index = model().ground()
    exact = ExactPosterior(g)
    res = vi.infer_c2f_fast(fg, 0, vi.VIConfig(K=2, n_iters=2400, lr=5e-2),
                            schedule=(1, None, "ground"))
    for key in [("cancer", ("p0",)), ("smokes", ("p1",))]:
        err = np.abs(res.disc_marginal(key)
                     - exact.disc_marginal(index[key])).max()
        assert err < 0.1, (key, res.disc_marginal(key))


def test_c2f_fast_stages_refine_and_final_is_grounded():
    rg = friends_smokers(n_people=6, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    fg = fast_compile(rg, "cpu")
    n1 = fast_lift(fg, max_rounds=1).n_disc
    nf = fast_lift(fg).n_disc
    assert n1 <= nf <= fg.n_disc
    assert n1 < fg.n_disc

    res = vi.infer_c2f_fast(fg, 1, vi.VIConfig(K=2, n_iters=600),
                            schedule=(None, "ground"))
    assert res.fg.n_disc == fg.n_disc  # the final stage IS the input graph
    assert np.isfinite(res.trace).all()
    p = res.disc_marginal(("smokes", ("p2",)))
    assert abs(p.sum() - 1.0) < 1e-5


def test_c2f_fast_schedule_validation():
    """Empty schedules raise, and so does a fine-to-coarse one instead of
    silently picking a warm-start writer."""
    rg = friends_smokers(n_people=4, hybrid=False)
    rg.observe("smokes", ("p0",), 1)
    fg = fast_compile(rg, "cpu")
    cfg = vi.VIConfig(K=2, n_iters=20)
    with pytest.raises(ValueError):
        vi.infer_c2f_fast(fg, 0, cfg, schedule=())
    with pytest.raises(ValueError):
        vi.infer_c2f_fast(fg, 0, cfg, schedule=("ground", 1))


@pytest.mark.parametrize("n_iters,length", [(100, 100), (2, 3)])
def test_c2f_fast_iters_total(n_iters, length):
    """The final stage absorbs the remainder (100 = 33 + 33 + 34); below
    one step a stage, each stage runs its minimum of one."""
    fg = fast_compile(friends_smokers(n_people=3, hybrid=False), "cpu")
    res = vi.infer_c2f_fast(fg, 0, vi.VIConfig(K=2, n_iters=n_iters),
                            schedule=(1, None, "ground"))
    assert len(res.trace) == length
