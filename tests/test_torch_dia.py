"""The banded (DIA) path of the port held to the JAX reference.

Band detection is the same numpy code on both sides, so its outputs are
EQUAL. Matvecs and trajectories are f32 arithmetic in another summation
order: rtol 1e-5 (atol 1e-5 where entries are near 0, e.g. gap lanes).
K2's momenta are drawn by Philox on the card and are compared only
statistically there (chip_smoke.py); here p0 is given to both sides. The
public leapfrog ``dia_quad_leapfrog`` (K6 on the card) runs its plain
version on CPU tensors, held here to the reference's Pallas kernel in
interpret mode and to its public op.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.ops import dia as ref_dia  # noqa: E402
from lhvi_tpu.ops.leapfrog import ell_matvec as ref_ell_matvec  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
from lhvi_tpu_torch.ops import dia  # noqa: E402
from lhvi_tpu_torch.ops.leapfrog import ell_matvec  # noqa: E402
from lhvi_tpu_torch.utils.metrics import counters  # noqa: E402


@pytest.fixture(scope="module")
def grids():
    """32×32 evidence grid: dense (oracle J) and forced ELL → DIA, in the
    reference; the port's own DIA compile of the same graph."""
    g_ref, _ = ref_toy.gaussian_grid(32, 32, seed=0, evidence_frac=0.2)
    ref_dense = ref_compile(g_ref, quad_max_n=10_000)
    ref_sparse = ref_compile(g_ref, quad_max_n=256)
    g, _ = toy.gaussian_grid(32, 32, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu", quad_max_n=256)
    assert fg.quad_dia_offsets == (-32, -1, 1, 32)
    assert fg.n_cont == 802 and fg.quad_dia_w.shape == (4, 1024)
    return ref_dense, ref_sparse, fg


def test_band_detection_equals_reference(grids):
    _, ref, fg = grids
    col, w = np.asarray(ref.quad_ell_col), np.asarray(ref.quad_ell_w)
    pos = np.asarray(ref.quad_dia_pos)
    rng = np.random.default_rng(3)
    full_pos = np.sort(rng.choice(2 * len(pos), len(pos), replace=False))
    # latent coordinates (evidence-compacted) and a random embedding break
    # the band; the declaration-order embedding restores it
    for p in (None, pos, full_pos):
        got, want = dia.ell_to_dia(col, w, pos=p), ref_dia.ell_to_dia(col, w, pos=p)
        assert (got is None) == (want is None)
        assert (want is None) == (p is not pos)
        if want is None:
            continue
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[2] is None) == (want[2] is None)
        if got[2] is not None:
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_array_equal(dia.pos_to_inv(got[2], len(col)),
                                          ref_dia.pos_to_inv(want[2], len(col)))
    # a dense row pattern is rejected by both
    n = 32
    dcol = np.tile(np.arange(n, dtype=np.int32), (n, 1))
    assert dia.ell_to_dia(dcol, np.ones((n, n), np.float32)) is None


def test_dia_matvec_equals_ell_and_dense(grids):
    """DIA matvec = ELL matvec = dense J·x on the same states."""
    ref_dense, _, fg = grids
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(7, fg.n_cont)).astype(np.float32))
    got = dia.dia_matvec(x, fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w,
                         fg.quad_dia_pos)
    ell = ell_matvec(x, fg.quad_diag, fg.quad_ell_col, fg.quad_ell_w)
    dense = x.numpy().astype(np.float64) @ np.asarray(ref_dense.quad_J,
                                                      np.float64).T
    np.testing.assert_allclose(got.numpy(), ell.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ell.numpy(), np.asarray(ref_ell_matvec(
            jnp.asarray(x.numpy()), *(jnp.asarray(np.asarray(a)) for a in (
                fg.quad_diag, fg.quad_ell_col, fg.quad_ell_w)))),
        rtol=1e-5, atol=1e-5)


def _embedded_inputs(fg, rng, C):
    n_emb = fg.quad_dia_w.shape[1]
    pos = fg.quad_dia_pos.numpy()

    def emb(a):
        out = np.zeros(a.shape[:-1] + (n_emb,), np.float32)
        out[..., pos] = a
        return out

    x = rng.normal(0.0, 2.0, (C, fg.n_cont)).astype(np.float32)
    p = rng.normal(size=(C, fg.n_cont)).astype(np.float32)
    im = rng.uniform(0.5, 1.5, fg.n_cont).astype(np.float32)
    return x, p, im, emb


@pytest.mark.parametrize("n_steps", [0, 1, 6])
def test_plain_dia_leapfrog_matches_reference(grids, n_steps):
    _, _, fg = grids
    x, p, im, emb = _embedded_inputs(fg, np.random.default_rng(1), 9)
    ins = [emb(a) for a in (x, p, fg.quad_diag.numpy(), fg.quad_h.numpy(), im)]
    wdia = fg.quad_dia_w.numpy()
    ref = ref_dia._jnp_dia_leapfrog(
        jnp.asarray(ins[0]), jnp.asarray(ins[1]), jnp.asarray(ins[2]),
        fg.quad_dia_offsets, jnp.asarray(wdia), jnp.asarray(ins[3]),
        jnp.asarray(ins[4]), 0.07, n_steps)
    t = [torch.from_numpy(a) for a in ins]
    got = dia._torch_dia_leapfrog(t[0], t[1], t[2], fg.quad_dia_offsets,
                                  torch.from_numpy(wdia), t[3], t[4], 0.07,
                                  n_steps)
    for a, b, name in zip(got, ref, ("x1", "p1", "lp0", "lp1")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=(name, n_steps))


def test_dia_hmc_proposal_given_p0_matches_reference(grids):
    """The wrapper's log-accept for a given p0 equals the reference's
    proposal algebra (dia.py:516-532) on the same momenta, forward from a
    dispersed state (downhill: log_acc clips to 0) and back from its
    endpoint with reversed momenta (uphill: log_acc < 0). Tolerance
    1e-5·(|lp0| + ke0): log_acc is the difference of two f32 energy sums
    of that size."""
    _, _, fg = grids
    x, p, im, emb = _embedded_inputs(fg, np.random.default_rng(2), 8)
    pos = fg.quad_dia_pos.numpy()
    wdia = jnp.asarray(fg.quad_dia_w.numpy())
    ime = jnp.asarray(emb(im))
    dge, he = (jnp.asarray(emb(a.numpy())) for a in (fg.quad_diag, fg.quad_h))
    ke = lambda q: 0.5 * jnp.sum(ime[None] * q * q, axis=-1)  # noqa: E731
    negative = 0
    for direction in ("forward", "reversed"):
        xe, pe = jnp.asarray(emb(x)), jnp.asarray(emb(p))
        x1r, p1r, lp0, lp1 = ref_dia._jnp_dia_leapfrog(
            xe, pe, dge, fg.quad_dia_offsets, wdia, he, ime, 0.05, 6)
        lacc_ref = np.asarray(jnp.minimum(0.0, (lp1 - lp0) + (ke(pe) - ke(p1r))))
        x1, lacc = dia.dia_hmc_proposal(
            None, torch.from_numpy(x), fg.quad_diag, fg.quad_dia_offsets,
            fg.quad_dia_w, fg.quad_h, torch.from_numpy(im), 0.05, 6,
            pos=fg.quad_dia_pos, inv=fg.quad_dia_inv, p0=torch.from_numpy(p))
        scale = np.abs(np.asarray(lp0)) + np.asarray(ke(pe))
        assert np.all(np.abs(lacc.numpy() - lacc_ref) <= 1e-5 * scale), direction
        assert np.all(lacc.numpy() <= 0.0)
        np.testing.assert_allclose(x1.numpy(), np.asarray(x1r)[:, pos],
                                   rtol=1e-5, atol=1e-5, err_msg=direction)
        negative += int(np.sum(lacc_ref < 0))
        x = np.array(x1r)[:, pos]
        p = -np.array(p1r)[:, pos]
    assert negative >= 8  # the uphill leg exercises the unclipped algebra


def test_dia_hmc_proposal_cpu_draw_is_plain(grids):
    """Without p0 the CPU route draws std·randn momenta from the generator
    and never touches the kernel counter; std is 0 at gap lanes."""
    _, _, fg = grids
    x = torch.zeros(4, fg.n_cont)
    im = torch.full((fg.n_cont,), 2.0)
    before = counters()["ops.k2.launches"]
    a = dia.dia_hmc_proposal(torch.Generator().manual_seed(5), x,
                             fg.quad_diag, fg.quad_dia_offsets,
                             fg.quad_dia_w, fg.quad_h, im, 0.05, 4,
                             pos=fg.quad_dia_pos, inv=fg.quad_dia_inv)
    b = dia.dia_hmc_proposal(torch.Generator().manual_seed(5), x,
                             fg.quad_diag, fg.quad_dia_offsets,
                             fg.quad_dia_w, fg.quad_h, im, 0.05, 4,
                             pos=fg.quad_dia_pos, inv=fg.quad_dia_inv)
    assert counters()["ops.k2.launches"] == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.isfinite(a[0]).all() and (a[1] <= 0).all()


def test_dia_hmc_proposal_cpu_select_is_mh_accept(grids):
    """With ``select`` the plain route makes the engine's Metropolis step:
    bitwise ``hmc._mh_accept`` on the proposal's own outputs, with given
    uniforms and with uniforms drawn from the generator after the momenta
    (the generator ends in the same state as a proposal followed by the
    engine's own draw). A chain with a non-finite energy (an inf in its
    row) gets log_acc −inf and comes back as x0, bit for bit. Near the
    mode with ε = 0.9 some proposals are accepted and some rejected."""
    from lhvi_tpu_torch.engines import hmc

    _, _, fg = grids
    n, C = fg.n_cont, 16
    J = dia.dia_matvec(torch.eye(n, dtype=torch.float64),
                       fg.quad_diag.double(), fg.quad_dia_offsets,
                       fg.quad_dia_w.double(), pos=fg.quad_dia_pos)
    mode = torch.linalg.solve(J, fg.quad_h.double())
    rng = np.random.default_rng(6)
    x = (mode[None] + torch.from_numpy(rng.normal(size=(C, n)))).float()
    x[3, 100] = float("inf")
    im = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=C).astype(np.float32))

    def call(gen, **kw):
        return dia.dia_hmc_proposal(
            gen, x, fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w,
            fg.quad_h, im, 0.9, 6, pos=fg.quad_dia_pos, inv=fg.quad_dia_inv,
            **kw)

    x1, lacc = call(None, p0=p)
    xs, ls = call(None, p0=p, u=u)
    assert torch.equal(xs, hmc._mh_accept(x, x1, lacc, u)[0])
    assert torch.equal(ls, lacc) and lacc[3] == -float("inf")
    assert torch.equal(xs[3], x[3])
    took = (torch.log(u) < lacc).sum()
    assert 0 < took < C - 1
    g_pair, g_sel = (torch.Generator().manual_seed(5) for _ in range(2))
    x1, lacc = call(g_pair)
    want = hmc._mh_accept(x, x1, lacc, torch.rand((C,), generator=g_pair))[0]
    xs, ls = call(g_sel, select=True)
    assert torch.equal(xs, want) and torch.equal(ls, lacc)
    assert torch.equal(g_sel.get_state(), g_pair.get_state())
    assert torch.equal(xs[3], x[3])


@pytest.fixture(scope="module")
def grid16():
    """tests/test_dia.py's 16×16 grid (15% evidence) forced onto the banded
    path, in both packages."""
    g_ref, _ = ref_toy.gaussian_grid(16, 16, seed=0, evidence_frac=0.15)
    g, _ = toy.gaussian_grid(16, 16, seed=0, evidence_frac=0.15)
    ref = ref_compile(g_ref, quad_max_n=64)
    fg = lt.compile_graph(g, "cpu", quad_max_n=64)
    assert fg.quad_dia_offsets == ref.quad_dia_offsets == (-16, -1, 1, 16)
    assert fg.quad_dia_w.shape == (4, 256) and fg.n_cont < 256
    return ref, fg


@pytest.mark.parametrize("n_steps", [1, 5])
def test_dia_quad_leapfrog_matches_pallas_kernel(grid16, n_steps):
    """The public op on CPU tensors (embedded rows, no ``pos``) against the
    reference's K6, ``_pallas_dia_leapfrog``, in interpret mode (as
    tests/test_dia.py:84-111 runs it) on the same rows: rtol/atol 1e-5,
    f32 arithmetic in another summation order. No launch is counted."""
    _, fg = grid16
    x, p, im, emb = _embedded_inputs(fg, np.random.default_rng(7), 9)
    ins = [emb(a) for a in (x, p, fg.quad_diag.numpy(), fg.quad_h.numpy(), im)]
    wdia = fg.quad_dia_w.numpy()
    with pltpu.force_tpu_interpret_mode():
        want = ref_dia._pallas_dia_leapfrog(
            *(jnp.asarray(a) for a in ins[:3]), jnp.asarray(wdia),
            jnp.asarray(ins[3]), jnp.asarray(ins[4]), jnp.asarray(0.07),
            fg.quad_dia_offsets, n_steps)
    t = [torch.from_numpy(a) for a in ins]
    before = counters()["ops.k6.launches"]
    got = dia.dia_quad_leapfrog(t[0], t[1], t[2], fg.quad_dia_offsets,
                                torch.from_numpy(wdia), t[3], t[4], 0.07,
                                n_steps)
    assert counters()["ops.k6.launches"] == before
    for a, b, name in zip(got, want, ("x1", "p1", "lp0", "lp1")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=(name, n_steps))


@pytest.mark.parametrize("n_steps", [0, 1, 8])
def test_dia_quad_leapfrog_with_pos_matches_reference(grid16, n_steps):
    """The public op on latent rows with ``pos`` against the reference's
    ``dia_quad_leapfrog`` (rtol/atol 1e-5); the plain helper is the same
    function; ``n_steps = 0`` returns x and p exactly and lp0 twice
    (tests/test_dia.py:76-81)."""
    ref, fg = grid16
    rng = np.random.default_rng(8)
    n = fg.n_cont
    x = rng.normal(0.0, 2.0, (5, n)).astype(np.float32)
    p = rng.normal(size=(5, n)).astype(np.float32)
    im = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = ref_dia.dia_quad_leapfrog(
        jnp.asarray(x), jnp.asarray(p), ref.quad_diag, ref.quad_dia_offsets,
        ref.quad_dia_w, ref.quad_h, jnp.asarray(im), 0.05, n_steps,
        pos=ref.quad_dia_pos)
    args = (torch.from_numpy(x), torch.from_numpy(p), fg.quad_diag,
            fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_h,
            torch.from_numpy(im), 0.05, n_steps)
    before = counters()["ops.k6.launches"]
    got = dia.dia_quad_leapfrog(*args, pos=fg.quad_dia_pos)
    plain = dia._plain_dia_quad_leapfrog(*args, pos=fg.quad_dia_pos)
    assert counters()["ops.k6.launches"] == before
    for a, b, c, name in zip(got, want, plain, ("x1", "p1", "lp0", "lp1")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=(name, n_steps))
        assert torch.equal(a, c), name
    if n_steps == 0:
        assert np.array_equal(got[0].numpy(), x)
        assert np.array_equal(got[1].numpy(), p)
        assert torch.equal(got[2], got[3])


def test_dia_quad_leapfrog_has_no_other_route(grid16):
    """A tensor that is on neither the CPU nor a CUDA device raises; no
    route falls back to another."""
    _, fg = grid16
    x = torch.zeros((2, fg.n_cont), device="meta")
    with pytest.raises(NotImplementedError, match="no route"):
        dia.dia_quad_leapfrog(x, x, fg.quad_diag.to("meta"),
                              fg.quad_dia_offsets, fg.quad_dia_w.to("meta"),
                              fg.quad_h.to("meta"), x[0], 0.05, 3,
                              pos=fg.quad_dia_pos.to("meta"))


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_band_detection_and_matvec(trial):
    """Random banded matrices in ELL form, with and without a random
    monotone embedding: both packages detect the same offsets and weights,
    and the port's DIA matvec equals the dense J·x (rtol/atol 1e-4, f32
    sums of up to 8 terms against float64)."""
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(8, 60))
    use_pos = trial % 2 == 1
    if use_pos:
        n_emb = n + int(rng.integers(1, n))
        pos = np.sort(rng.choice(n_emb, size=n, replace=False))
    else:
        pos = np.arange(n)
    offs = sorted({int(o) for o in rng.choice(np.arange(-7, 8), size=4,
                                              replace=False) if o != 0})
    inv = {int(e): i for i, e in enumerate(pos)}
    J = np.zeros((n, n), np.float32)
    for o in offs:
        for i in range(n):
            j = inv.get(int(pos[i]) + o)
            if j is not None and rng.uniform() < 0.8:
                J[i, j] = rng.normal()
    D = max(1, max(np.count_nonzero(J[i]) for i in range(n)))
    col = np.zeros((n, D), np.int32)
    w = np.zeros((n, D), np.float32)
    for i in range(n):
        nz = np.flatnonzero(J[i])
        col[i, : len(nz)] = nz
        w[i, : len(nz)] = J[i, nz]
    p = pos if use_pos else None
    got, want = dia.ell_to_dia(col, w, pos=p), ref_dia.ell_to_dia(col, w, pos=p)
    assert got is not None and got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    offsets, wdia, pos_out = got
    x = rng.normal(size=(3, n)).astype(np.float32)
    diag = rng.uniform(1, 2, n).astype(np.float32)
    y = dia.dia_matvec(torch.from_numpy(x), torch.from_numpy(diag), offsets,
                       torch.from_numpy(wdia),
                       None if pos_out is None else torch.from_numpy(pos_out))
    ref = x.astype(np.float64) * diag + x.astype(np.float64) @ J.T
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("n_emb", [64, 1024, 16384, 28672])
def test_dia_launch_chains_per_block(n_emb, K):
    """K2's and K6's geometry (``dia_launch``): the cluster's slices cover
    the embedded row (the last slice not empty), each slice a whole number
    of Philox lane quads; a thread holds at most 32 lane-chain momenta;
    the shared bytes are the kernel's reckoning, within 227 KB. Small rows
    take 8 chains in one block; the 128×128 grid's 16,384 lanes 8 chains
    over a cluster of 8 blocks of 512 threads; DIA_MAX_EMB's 28,672 lanes
    still run, at 4 chains (2 with 8 offsets)."""
    geo = dia.dia_launch(n_emb, K)
    assert geo.cluster in (1, 2, 4, 8) and geo.chains in (1, 2, 4, 8)
    assert geo.slice % 4 == 0
    assert geo.cluster * geo.slice >= n_emb > (geo.cluster - 1) * geo.slice
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 512
    assert -(-geo.slice // geo.threads) * geo.chains <= dia._REG_LANES
    assert geo.smem == dia._dia_smem(K, geo.chains, geo.slice, geo.threads)
    assert geo.smem <= dia.DIA_SMEM_LIMIT
    want = {64: (1, 8), 1024: (1, 8), 16384: (8, 8 if K <= 4 else 4),
            28672: (8, 4 if K <= 4 else 2)}[n_emb]
    assert (geo.cluster, geo.chains) == want


@pytest.mark.parametrize("n_emb,K", [(4001, 4), (3001, 2), (16387, 4)])
def test_dia_launch_covers_ragged_bands(n_emb, K):
    """The geometry of the card tests' bands without rows (4,001 lanes,
    offsets ±3 and ±50; a chain of 3,001) and of a lane count past a
    multiple of the grid's: the cluster's slices of whole lane quads cover
    the row, the last slice not empty; a thread holds at most 32
    lane-chain momenta, in at most 512 threads; the shared bytes, two
    [chains / 4][slice] position planes and the lane constants, are the
    kernel's reckoning within 227 KB. Three lanes past the grid's 16,384
    a block's 2,052 lanes would need 513 threads at 8 chains, so 4."""
    geo = dia.dia_launch(n_emb, K)
    assert geo.slice % 4 == 0
    assert geo.cluster * geo.slice >= n_emb > (geo.cluster - 1) * geo.slice
    assert -(-geo.slice // geo.threads) * geo.chains <= dia._REG_LANES
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 512
    assert geo.smem == dia._dia_smem(K, geo.chains, geo.slice, geo.threads)
    assert geo.smem <= dia.DIA_SMEM_LIMIT
    assert (geo.cluster, geo.chains) == {4001: (2, 8), 3001: (2, 8),
                                         16387: (8, 4)}[n_emb]


def test_dia_max_emb_is_kept():
    """DIA_MAX_EMB stays 28,672 lanes; one lane more raises."""
    assert dia.DIA_MAX_EMB == 28672
    with pytest.raises(ValueError, match="DIA_MAX_EMB"):
        dia.dia_launch(dia.DIA_MAX_EMB + 1, 4)


def test_inverse_map_on_the_device_matches_pos_to_inv(grids):
    """``_inv_of`` (K6's inverse embedding, built from ``pos`` where the
    tensors live) equals the host's ``pos_to_inv`` and the compiled
    ``quad_dia_inv``."""
    _, _, fg = grids
    n_emb = fg.quad_dia_w.shape[1]
    got = dia._inv_of(fg.quad_dia_pos, fg.n_cont, n_emb)
    want = dia.pos_to_inv(fg.quad_dia_pos.numpy(), fg.n_cont)
    assert torch.equal(got, torch.from_numpy(want.astype(np.int64)))
    assert torch.equal(got, fg.quad_dia_inv)


@pytest.mark.parametrize("refresh", [False, True])
def test_dia_proposal_embeds_current_constants(grids, refresh):
    """K2 keeps no embedded copy of diag, h or inv_mass: they are read
    through inv on every call. On CPU tensors the proposal equals
    re-embedding every input by scatter and running the plain trajectory,
    also after an in-place mass refresh and a change of the diagonal
    between two calls (bitwise: the same embedded rows, the same
    arithmetic)."""
    _, _, fg = grids
    x, p, im, _ = _embedded_inputs(fg, np.random.default_rng(4), 6)
    x, p, im = (torch.from_numpy(a) for a in (x, p, im))
    diag, h = fg.quad_diag.clone(), fg.quad_h
    offs, wdia, pos = fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_dia_pos

    def call():
        return dia.dia_hmc_proposal(None, x, diag, offs, wdia, h, im, 0.07,
                                    5, pos=pos, inv=fg.quad_dia_inv, p0=p)

    first = call()
    if refresh:
        im.mul_(1.7)
        diag.add_(0.25)
    got = call()
    emb = lambda a: dia._embed(a, pos, wdia.shape[1])  # noqa: E731
    x1, p1, lp0, lp1 = dia._torch_dia_leapfrog(
        emb(x), emb(p), emb(diag), offs, wdia, emb(h), emb(im), 0.07, 5)
    ime = emb(im)
    lacc = torch.clamp((lp1 - lp0) + (dia._kinetic(ime, emb(p))
                                      - dia._kinetic(ime, p1)), max=0.0)
    assert torch.equal(got[0], x1[..., pos])
    assert torch.equal(got[1], lacc)
    assert torch.equal(first[0], got[0]) == (not refresh)
