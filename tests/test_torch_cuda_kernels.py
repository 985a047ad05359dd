"""The port's CUDA kernels (K1–K8) against their plain versions on an
NVIDIA GPU, at shapes that reach the kernels' edge cases (ragged chain
tiles, both K1 tile configurations, zero steps, gap lanes).

Marked ``cuda``: each test skips where no CUDA device is present. This
file imports only torch and the port (no JAX), so it runs on the card's
machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lhvi_tpu_torch as lt  # noqa: E402
from lhvi_tpu_torch.models.toy import gaussian_grid  # noqa: E402
from lhvi_tpu_torch.ops import dia, leapfrog as lf  # noqa: E402
from lhvi_tpu_torch.utils.metrics import counters  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rel(a, b):
    d = (a.double() - b.double()).abs()
    return float((d / torch.clamp(b.double().abs(), min=1.0)).max())


# resident layout: NP = ceil(n/32) = 1..8 (8, 4 or 2 chains a warp, so 32,
# 16 or 8 a block), C ragged against each; cooperative layout: n past 256
# at C = 1, 3, 45 and 4,096 (128 × 128 tiles), n = 3,246 at one step
_K1_CASES = ([(n, C, s) for n, C in [(82, 100), (37, 1), (300, 45), (529, 3)]
              + [(n, C) for n in (1, 31, 33, 200, 256) for C in (1, 101)]
              + [(n, C) for n in (257, 529, 1100) for C in (1, 3, 45, 4096)
                 if (n, C) != (529, 3)]
              for s in (0, 1, 3)]
             + [(3246, C, 1) for C in (1, 3, 45, 4096)])


@pytest.mark.parametrize("n,C,n_steps", _K1_CASES)
def test_quad_leapfrog_kernel_matches_plain(dev, n, C, n_steps):
    """n ≤ 256 takes the resident layout (a warp holds 8, 4 or 2 chains for
    all their columns; J in shared memory where it fits), n > 256 the
    cooperative one (one persistent grid of 128 × 128 output tiles, a
    grid barrier a step); n and C are ragged against both tilings; at
    n = 3,246 one step. Tolerance 1e-5·max(1,|plain|): f32 dot products in
    another order."""
    g = torch.Generator(dev).manual_seed(n * 7 + C)
    A = torch.randn((n, n), generator=g, device=dev) / n**0.5
    J = (A @ A.T + torch.eye(n, device=dev)).contiguous()
    x = torch.randn((C, n), generator=g, device=dev)
    p = torch.randn((C, n), generator=g, device=dev)
    h = torch.randn((n,), generator=g, device=dev)
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    eps = torch.full((), 0.07, device=dev)
    before = counters()["ops.k1.launches"]
    got = lf.quad_leapfrog(x, p, J, h, im, eps, n_steps)
    want = lf._torch_quad_leapfrog(x, p, J, h, im, eps, n_steps)
    torch.cuda.synchronize()
    assert counters()["ops.k1.launches"] == before + 1
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


def test_quad_leapfrog_kernel_rejects_bad_input(dev):
    x = torch.zeros((4, 8), device=dev)
    J = torch.eye(8, device=dev)
    v = torch.ones(8, device=dev)
    with pytest.raises(TypeError):
        lf.quad_leapfrog(x.double(), x.double(), J, v, v, 0.1, 2)
    with pytest.raises(ValueError):
        lf.quad_leapfrog(x, x, J[:, :4], v, v, 0.1, 2)
    with pytest.raises(ValueError):
        lf.quad_leapfrog(x.t(), x.t(), torch.eye(4, device=dev), v[:4],
                         v[:4], 0.1, 2)


@pytest.fixture(scope="module")
def grid32(dev):
    g, _ = gaussian_grid(32, 32, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, dev, quad_max_n=256)
    assert fg.quad_dia_offsets == (-32, -1, 1, 32)
    return fg


def _banded(dev, n, rows=128, offs=None):
    """A banded target on n lanes with no embedding (by default the
    4-neighbour stencil of a grid ``rows`` wide, diagonally dominant):
    diag, offsets, wdia, h. Every weight whose neighbour falls off the row
    is 0, as ``ell_to_dia`` guarantees."""
    offs = (-rows, -1, 1, rows) if offs is None else offs
    i = torch.arange(n, device=dev)
    wdia = torch.stack([torch.where((i + o >= 0) & (i + o < n), -1.0, 0.0)
                        for o in offs]).float().contiguous()
    g = torch.Generator(dev).manual_seed(n)
    h = torch.randn((n,), generator=g, device=dev)
    return torch.full((n,), 0.5 + len(offs), device=dev), offs, wdia, h


# K2's and K6's bands beyond the grids: offsets with no row structure and a
# chain, each on a lane count that is no multiple of the block's lanes
_BANDS = {"norows": (4001, (-50, -3, 3, 50)), "chain": (3001, (-1, 1))}


def _dia_case(dev, grid32, dia_grids, case):
    """(diag, offsets, wdia, h, pos, inv, C) of a K2/K6 edge case: many
    chains per block (16×16 grid, 37 chains), a chain count that is not a
    multiple of the 8 chains per block (128×128 grid, 1,021 chains; 3
    chains, fewer than one group), the widest row (DIA_MAX_EMB lanes, 5
    chains against 4 per block), a band with no row structure and a
    chain (``_BANDS``, 13 and 19 chains), and a chain of 16 lanes at
    1,000,003 chains (``many``: one-block clusters of 16 lanes, each with
    more groups than the select lists in one pass)."""
    if case == "max":
        return (*_banded(dev, dia.DIA_MAX_EMB), None, None, 5)
    if case == "many":
        return (*_banded(dev, 16, offs=(-1, 1)), None, None, 1_000_003)
    if case in _BANDS:
        n, offs = _BANDS[case]
        return (*_banded(dev, n, offs=offs), None, None,
                13 if case == "norows" else 19)
    fg, C = {"grid32": (grid32, 7), "grid16": (dia_grids[16], 37),
             "grid128": (dia_grids[128], 1021),
             "grid128-3": (dia_grids[128], 3)}[case]
    return (fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_h,
            fg.quad_dia_pos, fg.quad_dia_inv, C)


@pytest.mark.parametrize("n_steps,case", [
    pytest.param(s, c, id=str(s) if c == "grid32" else f"{s}-{c}")
    for c in ("grid32", "grid16", "grid128", "grid128-3", "max", "norows",
              "chain")
    for s in (0, 1, 5)])
def test_dia_proposal_kernel_given_p0_matches_plain(dev, grid32, dia_grids,
                                                    case, n_steps):
    """Exact mode (p0 from memory) through the wrapper, against the plain
    route on the same tensors moved to the CPU, on the edge shapes of the
    cluster layout, on a band with no row structure (offsets ±3 and ±50)
    and on a chain (±1). Tolerances: x1 1e-5·max(1,|plain|); log_acc
    1e-5·(|lp0| + ke0)."""
    diag, offs, wdia, h, pos, inv, C = _dia_case(dev, grid32, dia_grids, case)
    n = diag.shape[0]
    g = torch.Generator(dev).manual_seed(n_steps)
    xc = 2.0 * torch.randn((C, n), generator=g, device=dev)
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    p0 = torch.randn((C, n), generator=g, device=dev)
    args = (diag, offs, wdia, h, im, torch.full((), 0.1, device=dev), n_steps)
    kw = dict(pos=pos, inv=inv, p0=p0)
    before = counters()["ops.k2.launches"]
    x1, lacc = dia.dia_hmc_proposal(g, xc, *args, **kw)
    torch.cuda.synchronize()
    assert counters()["ops.k2.launches"] == before + 1
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
    x1p, laccp = dia.dia_hmc_proposal(
        None, xc.cpu(), *map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
    assert _rel(x1.cpu(), x1p) < 1e-5
    lp0 = dia.dia_quad_leapfrog(
        *map(cpu, (xc, p0, diag, offs, wdia, h, im)), 0.1, 0,
        pos=cpu(pos))[2]
    scale = lp0.abs() + 0.5 * (im.cpu()[None] * p0.cpu() ** 2).sum(-1)
    assert torch.all((lacc.cpu() - laccp).abs() <= 1e-5 * scale)
    if n_steps == 0:
        assert torch.equal(lacc.cpu(), torch.zeros(C))
        assert torch.equal(x1, xc)


@pytest.mark.parametrize("uniforms", ["drawn", "accept", "reject"])
@pytest.mark.parametrize("n_steps,case", [
    pytest.param(s, c, id=f"{s}-{c}")
    for c in ("grid32", "grid16", "grid128", "grid128-3", "max", "norows",
              "chain", "many")
    for s in (0, 6)])
def test_dia_proposal_kernel_select_equals_launch_and_where(
        dev, grid32, dia_grids, case, n_steps, uniforms):
    """K2's Metropolis select (the launch given uniforms) against the
    pair it replaces, a launch without uniforms and then
    ``torch.where(log u < log_acc, x1, xc)``, bitwise in the state and in
    log_acc, with in-kernel momenta from one generator state, on every
    cluster size (1 to 8 blocks), ragged chain counts and both step
    counts; ``many`` takes the select's list in several passes a
    cluster. ``drawn``: ``select=True``, the uniforms drawn after the
    momenta, as an engine drawing them after the launch would; ``accept``
    (u = 0) and ``reject`` (u = 1) force every decision. One chain has an
    inf in its row: its log_acc is −inf and it comes back as x0."""
    diag, offs, wdia, h, pos, inv, C = _dia_case(dev, grid32, dia_grids, case)
    n = diag.shape[0]
    g = torch.Generator(dev).manual_seed(100 + n_steps)
    xc = 2.0 * torch.randn((C, n), generator=g, device=dev)
    bad = C // 2
    xc[bad, n // 3] = float("inf")
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    args = (diag, offs, wdia, h, im, torch.full((), 0.1, device=dev), n_steps)
    kw = dict(pos=pos, inv=inv)
    gen = torch.Generator(dev)
    gen.manual_seed(7)
    x1, lacc = dia.dia_hmc_proposal(gen, xc, *args, **kw)
    u = {"drawn": lambda: torch.rand((C,), generator=gen, device=dev),
         "accept": lambda: torch.zeros((C,), device=dev),
         "reject": lambda: torch.ones((C,), device=dev)}[uniforms]()
    want = torch.where((torch.log(u) < lacc)[:, None], x1, xc)
    after = gen.get_state()
    gen.manual_seed(7)
    before = counters()["ops.k2.selects"]
    if uniforms == "drawn":
        got, lacc_s = dia.dia_hmc_proposal(gen, xc, *args, select=True, **kw)
        assert torch.equal(gen.get_state(), after)
    else:
        got, lacc_s = dia.dia_hmc_proposal(gen, xc, *args, u=u, **kw)
    torch.cuda.synchronize()
    assert counters()["ops.k2.selects"] == before + 1
    assert torch.equal(lacc_s, lacc) and torch.equal(got, want)
    assert lacc[bad] == -float("inf") and torch.equal(got[bad], xc[bad])
    if uniforms == "reject":
        assert torch.equal(got, xc)
    if uniforms == "accept":
        ok = torch.arange(C, device=dev) != bad
        assert torch.equal(got[ok], x1[ok])


def test_dia_proposal_kernel_momenta(dev, grid32):
    """In-kernel momenta: deterministic per generator seed and state, fresh
    on each call (the call advances the generator), standard normal in
    distribution (one step reads them back)."""
    fg = grid32
    C = 2048
    xc = torch.zeros((C, fg.n_cont), device=dev)
    im = torch.ones(fg.n_cont, device=dev)
    eps = 0.01
    args = (fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_h, im,
            eps, 1)
    kw = dict(pos=fg.quad_dia_pos, inv=fg.quad_dia_inv)
    gen = torch.Generator(dev).manual_seed(3)
    a, _ = dia.dia_hmc_proposal(gen, xc, *args, **kw)
    c, _ = dia.dia_hmc_proposal(gen, xc, *args, **kw)
    gen.manual_seed(3)
    b, _ = dia.dia_hmc_proposal(gen, xc, *args, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # from x = 0: x1 = ε·(p0 + ½ε·h)
    z = (a.double() / eps - 0.5 * eps * fg.quad_h.double()[None]).cpu().numpy()
    N = z.size
    assert abs(z.mean()) < 5 / N**0.5
    assert abs(z.var() - 1) < 5 * (2 / N) ** 0.5
    assert np.abs(z.mean(0)).max() * C**0.5 < 5.0


@pytest.mark.parametrize("rows,quad_max_n", [(10, 4096), (24, 256)])
def test_transitions_never_sync_with_the_host(dev, rows, quad_max_n):
    """Adapting transitions on the dense (K1) and banded (K2) paths run
    with no device-to-host synchronisation: the step size stays a device
    tensor and K2's seed and offset are the generator's host state."""
    from lhvi_tpu_torch.engines import hmc

    g, _ = gaussian_grid(rows, rows, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, dev, quad_max_n=quad_max_n)
    cfg = hmc.HMCConfig(init_step_size=0.1)
    gen = torch.Generator(dev).manual_seed(0)
    state = hmc.init_hmc_state(fg, gen, cfg, 128)
    launches = counters()["ops.k1.launches"] + counters()["ops.k2.launches"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, acc = hmc.hmc_transition(fg, cfg, state, gen, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (counters()["ops.k1.launches"] + counters()["ops.k2.launches"]
            == launches + 3)
    assert torch.isfinite(state.xc).all() and torch.isfinite(state.log_eps)


def test_dia_runs_on_one_generator_draw_fresh_momenta(dev, grid32):
    """Two consecutive banded runs from one generator, started from the
    same state, move differently: K2's momentum stream follows the
    generator, not a counter that restarts with each run."""
    from lhvi_tpu_torch.engines import hmc

    fg = grid32
    cfg = hmc.HMCConfig(init_step_size=0.1)
    gen = torch.Generator(dev).manual_seed(0)
    state = hmc.init_hmc_state(fg, gen, cfg, 16)
    before = counters()["ops.k2.launches"]
    runs = [hmc.hmc_transition(fg, cfg, state, gen, False)[0].xc
            for _ in range(2)]
    assert counters()["ops.k2.launches"] == before + 2
    moved = [(r != state.xc).any(dim=1) for r in runs]
    both = moved[0] & moved[1]
    assert bool(both.any())
    assert not torch.equal(runs[0][both], runs[1][both])


def test_run_hmc_banded_select_equals_launch_and_mh_accept(dev, grid32,
                                                         monkeypatch):
    """A whole banded ``run_hmc`` query (30 transitions, mass adaptation,
    streamed diagnostics) with K2's select against the same query whose
    proposals launch K2 without uniforms and select outside the kernel
    through ``hmc._mh_accept``: the final states and every moment and
    diagnostic are bitwise equal. ``ops.k2.selects`` counts every
    transition of the fused run, none of the patched one, and none under
    SMC's banded move (which selects in ``smc._mh``)."""
    from lhvi_tpu_torch.engines import hmc, smc

    fg = grid32
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1)
    real_prop, real_trans = dia.dia_hmc_proposal, hmc.hmc_transition
    last = []

    def trans(*a, **k):
        out = real_trans(*a, **k)
        last[:] = [out[0].xc]
        return out

    def unfused(gen, xc, *a, select=False, u=None, **k):
        x1, lacc = real_prop(gen, xc, *a, **k)
        if not select:
            return x1, lacc
        u = torch.rand((xc.shape[0],), generator=gen, device=xc.device)
        return hmc._mh_accept(xc, x1, lacc, u)[0], lacc

    monkeypatch.setattr(hmc, "hmc_transition", trans)
    runs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(dia, "dia_hmc_proposal", unfused)
        before = counters()
        m, _, diag = hmc.run_hmc(fg, torch.Generator(dev).manual_seed(11),
                                 cfg, n_chains=77, n_warmup=20,
                                 n_samples=10, collect="moments",
                                 stream_diag=True)
        torch.cuda.synchronize()
        seen = counters() - before
        assert seen["hmc.transitions"] == 30
        assert seen["ops.k2.launches"] == 30
        assert seen["ops.k2.selects"] == (0 if patched else 30)
        runs.append((last[0], m, diag))
    (xa, ma, da), (xb, mb, db) = runs
    assert torch.equal(xa, xb)
    for a, b in ((ma, mb), (da, db)):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0,
                                       equal_nan=True, msg=k)
    monkeypatch.setattr(dia, "dia_hmc_proposal", real_prop)
    before = counters()
    smc.sample(fg, torch.Generator(dev).manual_seed(12),
               smc.SMCConfig(n_particles=256, n_temps=4))
    seen = counters() - before
    assert seen["ops.k2.launches"] > 0 and seen["ops.k2.selects"] == 0


# ---- K6: the banded leapfrog from given momenta ------------------------------


@pytest.fixture(scope="module")
def dia_grids(dev):
    """tests/test_dia.py's 16×16 grid and chip_smoke.py's 128×128 grid on
    the banded path."""
    out = {}
    for rows, frac, qmax in ((16, 0.15, 64), (128, 0.2, 4096)):
        g, _ = gaussian_grid(rows, rows, seed=0, evidence_frac=frac)
        fg = lt.compile_graph(g, dev, quad_max_n=qmax)
        assert fg.quad_dia_offsets == (-rows, -1, 1, rows)
        out[rows] = fg
    return out


@pytest.mark.parametrize("rows,C", [(16, 37), (128, 19), (128, 1021),
                                    ("max", 5), ("norows", 13),
                                    ("chain", 19)])
@pytest.mark.parametrize("n_steps", [0, 1, 6])
def test_dia_leapfrog_kernel_matches_plain(dev, dia_grids, rows, C, n_steps):
    """K6 through ``dia_quad_leapfrog`` on latent rows with ``pos``, one
    launch per call, against the plain version on the same tensors in f32
    and f64: on the 16×16 grid (8 chains in one block, 37 chains), the
    128×128 grid (clusters of 8 blocks; 19 and 1,021 chains, neither a
    multiple of 8), a band of DIA_MAX_EMB lanes with no embedding (4
    chains per cluster, 5 chains), a band with no row structure (offsets
    ±3 and ±50) and a chain (±1). Tolerances: x1, p1 within
    1e-4·max(1,|plain|) (f32 trajectory, FMA contraction); lp0, lp1 within
    1e-5·max(1,|plain|) of plain f32 and 2e-6 of plain f64 (the kernel
    sums in double). Zero steps return x and p bitwise and lp0 twice."""
    if rows == "max":
        diag, offs, wdia, h = _banded(dev, dia.DIA_MAX_EMB)
        pos = None
    elif rows in _BANDS:
        n, offs = _BANDS[rows]
        diag, offs, wdia, h = _banded(dev, n, offs=offs)
        pos = None
    else:
        fg = dia_grids[rows]
        diag, offs, wdia, h = (fg.quad_diag, fg.quad_dia_offsets,
                               fg.quad_dia_w, fg.quad_h)
        pos = fg.quad_dia_pos
    n = diag.shape[0]
    g = torch.Generator(dev).manual_seed(n + n_steps)
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    x = 2.0 * torch.randn((C, n), generator=g, device=dev)
    p = torch.randn((C, n), generator=g, device=dev) / torch.sqrt(im)
    consts = (diag, offs, wdia, h, im, torch.full((), 0.05, device=dev))
    before = counters()["ops.k6.launches"]
    got = dia.dia_quad_leapfrog(x, p, *consts, n_steps, pos=pos)
    torch.cuda.synchronize()
    assert counters()["ops.k6.launches"] == before + 1
    for dt, tol_l in ((torch.float32, 1e-5), (torch.float64, 2e-6)):
        cast = [a.to(dt) if isinstance(a, torch.Tensor) else a
                for a in (x, p) + consts]
        want = dia._plain_dia_quad_leapfrog(*cast, n_steps, pos=pos)
        assert _rel(got[0], want[0]) < 1e-4 and _rel(got[1], want[1]) < 1e-4
        assert _rel(got[2], want[2]) < tol_l and _rel(got[3], want[3]) < tol_l
    if n_steps == 0:
        assert torch.equal(got[0], x) and torch.equal(got[1], p)
        assert torch.equal(got[2], got[3])


def test_dia_leapfrog_kernel_rejects_bad_input(dev):
    """Past DIA_MAX_EMB lanes or 8 offsets K6 raises ValueError; f64 CUDA
    tensors raise TypeError (no route falls back to the plain version)."""
    n = dia.DIA_MAX_EMB + 1
    x = torch.zeros((2, n), device=dev)
    v = torch.ones(n, device=dev)
    before = counters()["ops.k6.launches"]
    with pytest.raises(ValueError, match="DIA_MAX_EMB"):
        dia.dia_quad_leapfrog(x, x, v, (1,), torch.zeros((1, n), device=dev),
                              v, v, 0.1, 2)
    x, v = x[:, :64].contiguous(), v[:64].contiguous()
    with pytest.raises(ValueError, match="at most 8"):
        dia.dia_quad_leapfrog(x, x, v, tuple(range(1, 10)),
                              torch.zeros((9, 64), device=dev), v, v, 0.1, 2)
    w = torch.zeros((1, 64), device=dev)
    with pytest.raises(TypeError):
        dia.dia_quad_leapfrog(x.double(), x.double(), v.double(), (1,),
                              w.double(), v.double(), v.double(), 0.1, 2)
    assert counters()["ops.k6.launches"] == before


def test_dia_kernels_alternate_geometries(dev, dia_grids):
    """K6 and K2 (exact mode) on the 128×128 grid (about 200 KB of shared
    memory a block), then the 16×16 grid (about 25 KB), then the 128×128
    grid again: every launch runs under the shared-memory limit the
    launcher has raised for that kernel, and the repeated calls give the
    first calls' results bitwise."""
    seen = {}
    for rows in (128, 16, 128):
        fg = dia_grids[rows]
        n = fg.n_cont
        g = torch.Generator(dev).manual_seed(rows)
        x = torch.randn((9, n), generator=g, device=dev)
        p = torch.randn((9, n), generator=g, device=dev)
        im = torch.ones(n, device=dev)
        consts = (fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_h,
                  im, 0.05, 3)
        out = (*dia.dia_quad_leapfrog(x, p, *consts, pos=fg.quad_dia_pos),
               *dia.dia_hmc_proposal(g, x, *consts, pos=fg.quad_dia_pos,
                                     inv=fg.quad_dia_inv, p0=p))
        torch.cuda.synchronize()
        if rows in seen:
            assert all(torch.equal(a, b) for a, b in zip(out, seen[rows]))
        seen[rows] = out


def _philox_normals(seed: int, offset: int, quads, chains):
    """The momentum stream K2 draws, on the host: Philox4x32-10 keyed by
    the 64-bit ``seed`` with counter (lane quad, chain, ``offset``), four
    words to two Box-Muller pairs from uniforms in (0, 1], in float64.
    Returns z [len(chains), 4 * len(quads)] for lanes 4q .. 4q + 3."""
    M0, M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    W0, W1 = np.uint32(0x9E3779B9), np.uint32(0xBB67AE85)
    q, c = np.meshgrid(np.asarray(quads, np.uint32),
                       np.asarray(chains, np.uint32))
    x0, x1 = q.astype(np.uint32), c.astype(np.uint32)
    x2 = np.full_like(x0, offset & 0xFFFFFFFF)
    x3 = np.full_like(x0, (offset >> 32) & 0xFFFFFFFF)
    k0, k1 = np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32)
    with np.errstate(over="ignore"):
        for _ in range(10):
            p0 = M0 * x0.astype(np.uint64)
            p1 = M1 * x2.astype(np.uint64)
            hi0, lo0 = (p0 >> 32).astype(np.uint32), p0.astype(np.uint32)
            hi1, lo1 = (p1 >> 32).astype(np.uint32), p1.astype(np.uint32)
            x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
            k0, k1 = k0 + W0, k1 + W1

    def uni(b):
        return ((b >> 8).astype(np.float64) + 1.0) / 16777216.0

    def bm(a, b):
        r = np.sqrt(-2.0 * np.log(uni(a)))
        return r * np.cos(2 * np.pi * uni(b)), r * np.sin(2 * np.pi * uni(b))

    z = np.stack([*bm(x0, x1), *bm(x2, x3)], axis=-1)  # [chains, quads, 4]
    return z.reshape(z.shape[0], -1)


@pytest.mark.parametrize("rows", [128, 32])
def test_dia_proposal_momentum_stream_is_pinned(dev, dia_grids, grid32, rows):
    """K2's in-kernel momenta are the Philox stream keyed by the
    generator's seed (``_KEY_TAG`` folded in) with counter (lane quad,
    chain, offset): one step from x = 0 gives x1 = ε·im·(p0 + ½ε·h) with
    p0 = z / √im, z from a numpy twin of Philox4x32-10 and Box–Muller, to
    float rounding (1e-5 of ε·im·(|p0| + 1 / √im)), on the 128×128 grid
    (clusters of 8) and the 32×32 grid (one block); 77 chains, so the last
    group is ragged."""
    fg = dia_grids[128] if rows == 128 else grid32
    assert dia.dia_launch(fg.quad_dia_w.shape[1],
                          len(fg.quad_dia_offsets)).cluster == (
                              8 if rows == 128 else 1)
    n, C, eps = fg.n_cont, 77, 0.01
    g = torch.Generator(dev).manual_seed(rows)
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    gen = torch.Generator(dev).manual_seed(20260 + rows)
    seed = gen.initial_seed() ^ dia._KEY_TAG
    offset = gen.get_offset()
    x1, _ = dia.dia_hmc_proposal(
        gen, torch.zeros((C, n), device=dev), fg.quad_diag,
        fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_h, im, eps, 1,
        pos=fg.quad_dia_pos, inv=fg.quad_dia_inv)
    pos = fg.quad_dia_pos.cpu().numpy()
    z = _philox_normals(seed, offset, np.arange(fg.quad_dia_w.shape[1] // 4),
                        np.arange(C))[:, pos]
    imd = im.double().cpu().numpy()
    sd = 1.0 / np.sqrt(imd)
    want = eps * imd * (sd * z + 0.5 * eps * fg.quad_h.double().cpu().numpy())
    got = x1.double().cpu().numpy()
    assert np.all(np.abs(got - want)
                  <= 1e-5 * eps * imd * (np.abs(sd * z) + sd))


# ---- K3: the NUTS trajectory ----------------------------------------------


def _nuts_case(dev, n, C, D, seed):
    """A random SPD target, states near its mode, momenta and a uniforms
    table, all on the card."""
    g = torch.Generator(dev).manual_seed(seed)
    A = torch.randn((n, n), generator=g, device=dev) / n**0.5
    J = (A @ A.T + torch.eye(n, device=dev)).contiguous()
    h = torch.randn((n,), generator=g, device=dev)
    mode = torch.linalg.solve(J.double(), h.double()).float()
    q0 = mode[None] + 0.5 * torch.randn((C, n), generator=g, device=dev)
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    p0 = torch.randn((C, n), generator=g, device=dev) / torch.sqrt(im)
    U = torch.rand((3, 1 << D, C), generator=g, device=dev)
    return J, h, q0, p0, im, U


# the warp layout's edges (n = 1, 32, 33, 96, 256; chain counts that are
# no multiple of the slots or of a warp's range), max_depth 0, 1 and 20
# (the warp layout takes every depth up to K3's 20 at n <= 256), the block
# layout (n = 257, 300, 1,100), and chains that stop at very different
# depths (every 7th starts far out and diverges at once)
_K3_CASES = [(5, 70, 6), (82, 300, 4), (82, 64, 9), (300, 33, 4), (1100, 9, 3),
             (1, 37, 4), (32, 301, 5), (33, 99, 4), (96, 130, 4),
             (256, 45, 4), (257, 19, 4), (82, 77, 0), (82, 301, 1),
             (33, 21, 20), (256, 13, 20), (257, 11, 6)]


@pytest.mark.parametrize("n,C,D", _K3_CASES + [(82, 301, "spread")])
def test_nuts_traj_kernel_matches_plain(dev, n, C, D):
    """Both layouts (a warp holding 4 or 2 chains up to n = 256, a block
    holding 8 past it) against the lockstep loop in f64 on the same p0 and
    uniforms table: on ≥ 97% of chains depth, leaf count and divergence
    are equal and q_prop is within 1e-4·max(1,|plain|) (each decision, the
    multinomial choices included, is a threshold test on sums taken in
    another order); on those chains the summed accept statistic is within
    1e-4 per leaf."""
    import dataclasses

    from lhvi_tpu_torch.engines import nuts
    from lhvi_tpu_torch.ops import nuts_traj as nt

    spread = D == "spread"
    if spread:
        D = 8
    J, h, q0, p0, im, U = _nuts_case(dev, n, C, D, n + C)
    if spread:  # every 7th chain 1,000 times the momentum: its energy
        p0[::7] *= 1e3  # error passes 1,000 at the first leaf, a divergence
    eps = torch.full((), 0.9 / n**0.25, device=dev)
    before = counters()["ops.k3.launches"]
    got = nt._cuda_nuts_traj(q0, p0, J, h, im, eps, D, uniforms=U)
    torch.cuda.synchronize()
    assert counters()["ops.k3.launches"] == before + 1
    fg = dataclasses.replace(
        lt.compile_graph(gaussian_grid(2, 2, seed=0, evidence_frac=0.0)[0],
                         dev),
        n_cont=n, quad_J=J.double(), quad_h=h.double(),
        quad_c=torch.zeros((), dtype=torch.float64, device=dev))
    want = nuts._nuts_lockstep(fg, None, q0.double(), None, eps.double(),
                               im.double(), D, uniforms=U, p0=p0.double())
    close = ((got[0].double() - want[0]).abs()
             <= 1e-4 * torch.clamp(want[0].abs(), min=1.0)).all(dim=1)
    agree = (close & (got[2] == want[2]) & (got[3] == want[3])
             & (got[4] == want[4]))
    assert float(agree.float().mean()) >= 0.97
    tol = 1e-4 * got[2][agree].double()
    assert torch.all((got[1][agree].double() - want[1][agree]).abs() <= tol)
    assert int(got[3].min()) >= min(D, 1) and int(got[3].max()) <= D
    if D == 0:
        assert torch.equal(got[0], q0) and int(got[2].abs().sum()) == 0
    if spread:  # the case is what it claims: divergent and deep chains
        assert bool(want[4][::7].all()) and int(want[3][::7].max()) == 1
        assert int(want[3].max()) >= 3, want[3]


@pytest.mark.parametrize("n,D", [(82, 4), (33, 9), (300, 4)])
def test_nuts_traj_kernel_is_bitwise_reproducible(dev, n, D):
    """Two launches on the same inputs give the same bits, on both uniform
    routes and both layouts: each warp (block) refills its slots from a
    fixed range of chains in order, so which slot, and so which order of
    sums, a chain gets depends only on the chains' own data."""
    from lhvi_tpu_torch.ops import nuts_traj as nt

    C = 1000
    J, h, q0, p0, im, U = _nuts_case(dev, n, C, D, 7 * n + D)
    eps = torch.full((), 0.9 / n**0.25, device=dev)
    for uni, seed in ((U, 0), (None, 12345)):
        a = nt._cuda_nuts_traj(q0, p0, J, h, im, eps, D, seed, 8, uni)
        b = nt._cuda_nuts_traj(q0, p0, J, h, im, eps, D, seed, 8, uni)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert int(a[3].max()) >= 2  # the chains' trees differ in depth
        assert int(a[3].min()) < int(a[3].max())


def test_nuts_leaves_k3_equal_the_lockstep_count(dev):
    """The leaves K3 reports a chain integrated are the lockstep loop's for
    the same tree (same generator seed, so the same p0, and the same
    uniforms table): equal on every chain whose tree agrees, so
    ``nuts.leaves`` reads the same on either route; and ``run_nuts`` adds
    the per-chain leaves of every transition to the counter once."""
    from lhvi_tpu_torch.engines import nuts
    from lhvi_tpu_torch.ops import nuts_traj as nt

    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, dev)
    C, n, D = 4096, fg.n_cont, 4
    gen = torch.Generator(dev).manual_seed(5)
    mode = torch.linalg.solve(fg.quad_J.double(), fg.quad_h.double()).float()
    xc = mode[None] + 0.5 * torch.randn((C, n), generator=gen, device=dev)
    im = torch.ones(n, device=dev)
    U = torch.rand((3, 1 << D, C), generator=gen, device=dev)
    eps = torch.tensor(0.12, device=dev)
    k3 = nt.nuts_trajectory(fg, torch.Generator(dev).manual_seed(9), xc,
                            eps, im, D, uniforms=U)
    q, _, n_leaf, depth, _ = nuts._nuts_lockstep(
        fg, torch.Generator(dev).manual_seed(9), xc, None, eps, im, D,
        uniforms=U)
    torch.cuda.synchronize()
    plain = (q, None, depth, None, n_leaf)
    same_tree = ((k3[0] - plain[0]).abs() <= 1e-4 * torch.clamp(
        plain[0].abs(), min=1.0)).all(dim=1) & (k3[2] == plain[2])
    assert float(same_tree.float().mean()) >= 0.97
    assert torch.equal(k3[4][same_tree], plain[4][same_tree])
    assert int(k3[4].max()) <= (1 << D) - 1 and int(k3[4].min()) >= 1

    seen = []
    real = nuts._nuts_sweep_batched

    def spy(*a, **k):
        r = real(*a, **k)
        seen.append(int(r[4].sum()))
        return r

    nuts._nuts_sweep_batched = spy
    try:
        before = counters()
        nuts.run_nuts(fg, torch.Generator(dev).manual_seed(1),
                      nuts.NUTSConfig(max_depth=D, init_step_size=0.12),
                      n_chains=512, n_warmup=5, n_samples=6,
                      collect="moments")
        after = counters()
    finally:
        nuts._nuts_sweep_batched = real
    assert after["nuts.transitions"] - before["nuts.transitions"] == 11
    assert after["ops.k3.launches"] - before["ops.k3.launches"] == 11
    assert after["nuts.leaves"] - before["nuts.leaves"] == sum(seen) > 0


def test_nuts_traj_kernel_in_kernel_uniforms(dev):
    """Philox uniforms through the wrapper: the same generator state gives
    the same bits, the next call on the generator differs; the accept
    statistic is a probability and depths lie in 1..max_depth."""
    from lhvi_tpu_torch.ops import nuts_traj as nt

    g, _ = gaussian_grid(6, 6, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, dev)
    C, n, D = 512, fg.n_cont, 6
    xc = torch.zeros((C, n), device=dev)
    im = torch.ones(n, device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    a = nt.nuts_trajectory(fg, gen, xc, 0.2, im, D)
    b = nt.nuts_trajectory(fg, gen, xc, 0.2, im, D)
    gen.manual_seed(3)
    c = nt.nuts_trajectory(fg, gen, xc, 0.2, im, D)
    torch.cuda.synchronize()
    for x, y in zip(a, c):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], b[0])
    assert bool(((a[1] >= 0) & (a[1] <= 1)).all())
    assert int(a[2].min()) >= 1 and int(a[2].max()) <= D


# ---- K4: the SMC weight pipeline --------------------------------------------


def _check_weights(got, lw):
    """tests/test_resample_kernel.py:26-32 tolerances against the plain
    version in f64, relative where f32 cannot hold them absolutely: lwn and
    step_z within 1e-5·max(1,|value|) (at scale 30 |lwn| reaches ~260,
    where one f32 ulp is 3e-5). lwn must be -inf exactly where lw is."""
    from lhvi_tpu_torch.ops import resample as rs

    lwn, cum, z, ess = got
    lwn_p, cum_p, z_p, ess_p = rs._torch_weight_pipeline(lw.double())
    fin = torch.isfinite(lw)
    assert torch.equal(torch.isfinite(lwn), fin)
    assert bool((lwn[~fin] == -float("inf")).all())
    assert _rel(lwn[fin], lwn_p[fin]) < 1e-5
    assert float((cum - cum_p).abs().max()) < 1e-4
    assert abs(float(z) - float(z_p)) < 1e-5 * max(1.0, abs(float(z_p)))
    assert abs(float(ess) / float(ess_p) - 1) < 1e-5
    assert abs(float(cum[-1]) - 1) < 1e-4
    assert z.shape == () and z.device == lw.device


# K4's layout boundaries (ops/resample.py::k4_launch): one block up to
# 1,024; a cluster of 256-, 512- and 1,024-thread blocks up to 16,384,
# 32,768 and 65,536, then 8 and 16 weights a thread up to 131,072 and
# 262,144; the cooperative grid past it
_K4_BOUNDS = [b + d for b in (1024, 16384, 32768, 65536, 131072, 262144)
              for d in (-1, 1)]


@pytest.mark.parametrize("N", [1, 7, 1000, 65536, 100003, 4096, 16384]
                         + _K4_BOUNDS + [4194307])
@pytest.mark.parametrize("scale", [3.0, 30.0])
def test_weight_pipeline_kernel_matches_plain(dev, N, scale):
    """Both layouts, each boundary ± 1, against the plain version in f64
    (``_check_weights``)."""
    from lhvi_tpu_torch.ops import resample as rs

    g = torch.Generator(dev).manual_seed(N)
    lw = scale * torch.randn((N,), generator=g, device=dev)
    before = counters()["ops.k4.launches"]
    got = rs.weight_pipeline(lw)
    torch.cuda.synchronize()
    assert counters()["ops.k4.launches"] == before + 1
    _check_weights(got, lw)


@pytest.mark.parametrize("N,layout", [(1000, "cluster"), (65536, "cluster"),
                                      (100003, "cluster"), (5000, "grid"),
                                      (4194307, "grid")])
def test_weight_pipeline_kernel_is_bitwise_reproducible(dev, N, layout):
    """Two launches on the same input give the same bits in each layout
    (every sum's order depends only on N and the geometry); the grid
    layout at a small N, forced, also holds to the plain version."""
    from lhvi_tpu_torch.ops import resample as rs

    g = torch.Generator(dev).manual_seed(N + 1)
    lw = 5.0 * torch.randn((N,), generator=g, device=dev)
    geo = rs.k4_launch(N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    if geo.layout != layout:
        G = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
        geo = rs.K4Launch("grid", 1, rs.K4_GRID_THREADS,
                          rs.K4_GRID_PER_THREAD, G, 6 * G + 2)

    def launch():
        lwn, cum = torch.empty_like(lw), torch.empty_like(lw)
        stats = torch.empty((2,), device=dev)
        scratch = (torch.zeros((geo.scratch,), device=dev) if geo.scratch
                   else None)
        rs._k4(lw, lwn, cum, stats, geo, scratch)
        return lwn, cum, stats[0], stats[1]

    a, b = launch(), launch()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _check_weights(a, lw)


@pytest.mark.parametrize("N", [1000, 65536, 262145])
def test_weight_pipeline_kernel_zero_weights(dev, N):
    """Log-weights at -inf (particles with zero weight), scattered and in
    a run longer than a block: lwn is -inf there, cum is flat across them
    (to one f32 ulp at 1: a thread's or block's offset comes from a scan
    tree, not from its neighbour's last sum), and the rest matches the
    plain version."""
    from lhvi_tpu_torch.ops import resample as rs

    g = torch.Generator(dev).manual_seed(N + 2)
    lw = 3.0 * torch.randn((N,), generator=g, device=dev)
    lw[::7] = -float("inf")
    lw[N // 4: N // 4 + 5000] = -float("inf")
    got = rs.weight_pipeline(lw)
    torch.cuda.synchronize()
    _check_weights(got, lw)
    cum = got[1]
    dead = torch.nonzero(~torch.isfinite(lw[1:])).flatten() + 1
    assert float((cum[dead] - cum[dead - 1]).abs().max()) <= 2.0**-24


def test_weight_pipeline_kernel_rejects_bad_geometry(dev):
    """The launcher refuses a geometry that does not cover N or that the
    card cannot place, and the refusal raises through ``_build.check``."""
    from lhvi_tpu_torch.ops import resample as rs

    N = 10000
    lw = torch.randn((N,), device=dev)
    out = [torch.empty_like(lw), torch.empty_like(lw),
           torch.empty((2,), device=dev)]
    for geo in (rs.K4Launch("cluster", 2, 1024, 4, 2, 0),     # 8,192 < N
                rs.K4Launch("cluster", 17, 1024, 4, 17, 0),   # > 16 blocks
                rs.K4Launch("cluster", 3, 1024, 4, 1, 0),     # grid != cluster
                rs.K4Launch("cluster", 3, 1024, 5, 3, 0),     # per_thread
                rs.K4Launch("cluster", 3, 2048, 4, 3, 0),     # threads
                rs.K4Launch("grid", 1, 512, 4, 100000, 1)):   # not resident
        scratch = torch.zeros((max(geo.scratch, 1),), device=dev)
        with pytest.raises(RuntimeError, match="weight_pipeline"):
            rs._k4(lw, *out, geo, scratch)
    with pytest.raises(RuntimeError, match="weight_pipeline"):
        rs._k4(lw, *out, rs.K4Launch("grid", 1, 512, 4, 8, 50), None)


def test_smc_memory_does_not_grow_with_temperatures(dev):
    """``run_smc`` keeps every temperature's ess until the end. K4's step_z
    and ess must not keep that temperature's [N] outputs alive, so the peak
    of device memory is the same at 10 and at 60 temperatures (were they
    views of the lwn/cum buffer, it would grow by 8·N bytes a temperature:
    25 MB here)."""
    from lhvi_tpu_torch.engines import smc
    from lhvi_tpu_torch.models.lds import kalman_lds

    g, _, _ = kalman_lds(T=5, seed=0)
    fg = lt.compile_graph(g, dev)
    peaks = []
    for T in (10, 10, 60):  # the first run warms every cache
        cfg = smc.SMCConfig(n_particles=65536, n_temps=T, n_moves=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        smc.run_smc(fg, torch.Generator(dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev) - base)
    assert peaks[2] - peaks[1] < 2**20, peaks


def test_nuts_and_smc_steps_never_sync_with_the_host(dev):
    """A NUTS transition on the K3 path and a fixed-schedule SMC
    temperature (reweight, K4, resample, two moves) read nothing back."""
    from lhvi_tpu_torch.engines import hmc, nuts, smc
    from lhvi_tpu_torch.models.lds import kalman_lds

    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, dev)
    cfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.12)
    gen = torch.Generator(dev).manual_seed(0)
    state = hmc.init_hmc_state(fg, gen, cfg.to_hmc(), 256)
    g2, _, _ = kalman_lds(T=20, seed=0)
    fg2 = lt.compile_graph(g2, dev)
    scfg = smc.SMCConfig(n_particles=4096, n_temps=50)
    N = scfg.n_particles
    mid = 0.5 * (fg2.cont_lo + fg2.cont_hi)
    st = smc.SMCState(mid + 2.0 * torch.randn((N, fg2.n_cont), generator=gen,
                                              device=dev),
                      torch.zeros((N, 0), dtype=torch.int64, device=dev),
                      torch.full((N,), -float(np.log(N)), device=dev),
                      torch.zeros((), device=dev))
    betas = torch.linspace(0.0, 1.0, 51, device=dev)
    launches = counters()["ops.k3.launches"] + counters()["ops.k4.launches"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, _ = nuts.nuts_transition(fg, cfg, state, gen, True)
        for t in range(2):
            u0 = torch.rand((), generator=gen, device=dev)
            st, ess = smc._reweight_resample(fg2, scfg, st, betas[t],
                                             betas[t + 1], u0)
            xc, xd, acc = smc._rejuvenate(fg2, scfg, gen, st.xc, st.xd,
                                          betas[t + 1], scfg.step_size)
            st = st._replace(xc=xc, xd=xd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (counters()["ops.k3.launches"] + counters()["ops.k4.launches"]
            == launches + 4)
    assert torch.isfinite(state.xc).all() and torch.isfinite(st.xc).all()


def _logpot_model(name):
    """Small non-quadratic models that reach K5's branches: discrete slots
    (robot), no quadratic form (denoise; 16x16 is past the reference's
    TPU gate), robot with 150 latent depths, exp and division (friends),
    tied and observed slots with non-index values, a tape of 127 nodes
    (long: few warps a block)."""
    from lhvi_tpu_torch.models.image import denoise_grid
    from lhvi_tpu_torch.models.relational import (
        friends_smokers,
        robot_map,
        robot_scan_evidence,
    )
    from lhvi_tpu_torch.models.toy import hybrid_chain
    from lhvi_tpu_torch.potentials import MLNPotential
    from lhvi_tpu_torch.relational.data import load_evidence

    if name.startswith("robot"):
        n, miss = (10, 7) if name == "robot10" else (150, 1)
        text, _ = robot_scan_evidence(n, seed=0, depth_miss_every=miss)
        return robot_map(n, evidence=load_evidence(text)).ground()[0]
    if name.startswith("denoise"):
        rows = int(name[len("denoise"):])
        return denoise_grid(rows, rows, seed=0)[0]
    if name == "hybrid_chain":
        return hybrid_chain()[0]
    if name == "long":  # a 127-node tape on a 4-cycle (two colours)
        dom = lt.Domain([-2.0, 2.0], continuous=True)
        xs = [lt.RV(dom, name=f"x{i}") for i in range(4)]
        return lt.Graph(xs, [lt.F(MLNPotential(
            lambda a: -sum(((a[0] - 0.1 * k) * (a[1] + 0.05 * k)) ** 2
                           for k in range(18)) / 50.0 - 0.01 * a[0],
            w=0.7, formula_name="long"), [xs[i], xs[(i + 1) % 4]])
            for i in range(4)])
    if name == "friends4":  # exp and division in its formula
        rg = friends_smokers(n_people=4, hybrid=True)
        rg.observe("smokes", ("p0",), 1)
        return rg.ground()[0]
    s = lt.RV(lt.Domain([-1.0, 1.0]), name="s")
    x = lt.RV(lt.Domain([-4.0, 4.0], continuous=True), name="x")
    e = lt.RV(lt.Domain([-4.0, 4.0], continuous=True), name="e")
    e.value = 0.7
    return lt.Graph([s, x, e], [
        lt.F(MLNPotential(lambda a: -(a[0] * a[1]) / 4.0 - a[0] ** 2 / 8.0,
                          w=0.9, formula_name="tied"), [x, x]),
        lt.F(MLNPotential(lambda a: -((a[1] - a[0]) ** 2) / 2.0
                          - torch.abs(a[1] - a[2]) / 2.0, w=1.1,
                          formula_name="pull"), [s, x, e]),
    ])


_K5_MODELS = ["robot10", "robot150", "denoise6", "denoise16", "hybrid_chain",
              "friends4", "tied", "long"]


def _k5_steps_at_4099(model):
    """Steps the 4,099-chain case takes: zero on the denoising grids, whose
    edge term has a kink (see below), two on every other model."""
    return 0 if model.startswith("denoise") else 2


@pytest.mark.parametrize("model,C,n_steps", [
    (m, C, s) for m in _K5_MODELS
    for C, s in ((1, 0), (13, 1), (300, 5), (4099, _k5_steps_at_4099(m)))])
@pytest.mark.parametrize("tempered", [False, True])
def test_logpot_leapfrog_kernel_matches_tape(dev, model, C, n_steps,
                                             tempered):
    """K5 through ``plan="auto"`` against its plain twin (the tape
    evaluator over ``tape_energy_grad``) on the same momenta, at chain
    counts below, at and past a 32-chain tile (4,099 leaves 3 chains in
    the last block) and on a 127-node tape. At 4,099 chains the kernel
    takes two steps on every model without a kink, so a multi-step
    trajectory on a ragged last tile is held everywhere, and zero steps on
    the denoising grids (the gradient's half-kick and the energy at the
    given positions): over 4,099 × 480 edges of the 16×16 grid, an f32
    rounding difference between the two routes' positions after a step
    puts a pair on the other side of the edge term's cap (|Δx| = 0.4,
    gradient 20 on one side, 0 on the other) often enough to move one
    momentum by 0.4; the same inputs never do. Tolerances:
    x1, p1 within 1e-4·max(1,|plain|), E0, E1 within 2e-4·max(1,|plain|)
    (tests/test_logpot_kernel.py's bound; f32 sums in another order)."""
    from lhvi_tpu_torch.ops import logpot

    fg = lt.compile_graph(_logpot_model(model), dev)
    plan = logpot.kernel_plan(fg)
    assert plan is not None
    n = fg.n_cont
    g = torch.Generator(dev).manual_seed(C + n_steps)
    lo, hi = fg.cont_lo, fg.cont_hi
    x = lo + (hi - lo) * torch.rand((C, n), generator=g, device=dev)
    p = torch.randn((C, n), generator=g, device=dev)
    sizes = torch.as_tensor(fg.meta.np_global["disc_sizes"], device=dev)
    xd = (torch.rand((C, fg.n_disc), generator=g, device=dev)
          * sizes[None]).long()
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    kw = {}
    if tempered:
        kw = dict(beta=torch.full((), 0.3, device=dev),
                  base_mid=0.5 * (lo + hi),
                  base_inv_s2=torch.full((n,), 0.25, device=dev))
    args = (fg, x, p, xd, im, torch.full((), 0.04, device=dev), n_steps)
    before = counters()["ops.k5.launches"]
    got = logpot.logpot_leapfrog(*args, plan="auto", **kw)
    want = logpot.tape_logpot_leapfrog(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    assert counters()["ops.k5.launches"] == before + 1
    assert _rel(got[0], want[0]) < 1e-4 and _rel(got[1], want[1]) < 1e-4
    assert _rel(got[2], want[2]) < 2e-4 and _rel(got[3], want[3]) < 2e-4
    if n_steps == 0:
        assert torch.equal(got[0], x) and torch.equal(got[2], got[3])


@pytest.mark.parametrize("tempered", [False, True])
def test_logpot_leapfrog_kernel_at_the_robot_cells_shape(dev, tempered):
    """K5 through ``plan="auto"`` against its plain twin on
    ``robot_map(100)`` (bench.py's scan, seed 0) at the benchmark cell
    ``robot100_hmc``'s 65,536 chains: 8 steps of 0.05, as the smoke
    run's 16,384-chain robot case, untempered and at β = 0.3 with its
    base measure, and with its tolerances: x1, p1 within
    1e-4·max(1,|plain|), E0, E1 within 2e-4·max(1,|plain|)."""
    from lhvi_tpu_torch.models.relational import (robot_map,
                                                  robot_scan_evidence)
    from lhvi_tpu_torch.ops import logpot
    from lhvi_tpu_torch.relational.data import load_evidence

    text, _ = robot_scan_evidence(100, seed=0)
    fg = lt.compile_graph(robot_map(100, evidence=load_evidence(text))
                          .ground()[0], dev)
    plan = logpot.kernel_plan(fg)
    C, n = 65536, fg.n_cont
    g = torch.Generator(dev).manual_seed(C + 8)
    lo, hi = fg.cont_lo, fg.cont_hi
    x = lo + (hi - lo) * torch.rand((C, n), generator=g, device=dev)
    p = torch.randn((C, n), generator=g, device=dev)
    sizes = torch.as_tensor(fg.meta.np_global["disc_sizes"], device=dev)
    xd = (torch.rand((C, fg.n_disc), generator=g, device=dev)
          * sizes[None]).long()
    im = 0.5 + torch.rand((n,), generator=g, device=dev)
    kw = {}
    if tempered:
        kw = dict(beta=torch.full((), 0.3, device=dev),
                  base_mid=0.5 * (lo + hi),
                  base_inv_s2=torch.full((n,), 0.25, device=dev))
    args = (fg, x, p, xd, im, torch.full((), 0.05, device=dev), 8)
    before = counters()["ops.k5.launches"]
    got = logpot.logpot_leapfrog(*args, plan="auto", **kw)
    want = logpot.tape_logpot_leapfrog(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    assert counters()["ops.k5.launches"] == before + 1
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert _rel(got[0], want[0]) < 1e-4 and _rel(got[1], want[1]) < 1e-4
    assert _rel(got[2], want[2]) < 2e-4 and _rel(got[3], want[3]) < 2e-4


def test_logpot_leapfrog_kernel_rejects_bad_input(dev):
    from lhvi_tpu_torch.ops import logpot

    fg = lt.compile_graph(_logpot_model("robot10"), dev)
    plan = logpot.logpot_plan(fg)
    x = torch.zeros((4, fg.n_cont), device=dev)
    xd = torch.zeros((4, fg.n_disc), dtype=torch.int64, device=dev)
    im = torch.ones(fg.n_cont, device=dev)
    with pytest.raises(TypeError):
        logpot.logpot_leapfrog(fg, x.double(), x.double(), xd, im, 0.1, 2,
                               plan=plan)
    with pytest.raises(ValueError):
        logpot.logpot_leapfrog(fg, x, x[:2], xd, im, 0.1, 2, plan=plan)
    with pytest.raises(ValueError):  # the plan's tables live on the CPU
        logpot.logpot_leapfrog(fg, x, x, xd, im, 0.1, 2,
                               plan=logpot.logpot_plan(lt.compile_graph(
                                   _logpot_model("robot10"), "cpu")))


def test_hybrid_transitions_never_sync_with_the_host(dev):
    """HMC-within-Gibbs on the robot map with ``fused_logpot=True``: the
    planned Gibbs sweep and the K5 proposal read nothing back (after a
    first transition that builds and uploads the plan)."""
    from lhvi_tpu_torch.engines import hmc

    fg = lt.compile_graph(_logpot_model("robot10"), dev)
    cfg = hmc.HMCConfig(n_leapfrog=4, init_step_size=0.05, fused_logpot=True)
    gen = torch.Generator(dev).manual_seed(0)
    state = hmc.init_hmc_state(fg, gen, cfg, 256)
    state, _ = hmc.hmc_transition(fg, cfg, state, gen, True)
    before = counters()["ops.k5.launches"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, _ = hmc.hmc_transition(fg, cfg, state, gen, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counters()["ops.k5.launches"] == before + 2
    assert torch.isfinite(state.xc).all()


def test_nuts_within_gibbs_and_tempered_smc_run_on_the_card(dev):
    """NUTS-within-Gibbs (the lockstep loop on the autograd gradient after
    the planned sweep) and SMC with the tempered Gibbs sweep on a hybrid
    model with CUDA tensors: the states stay on the card, finite and in
    their domains."""
    from lhvi_tpu_torch.engines import hmc, nuts, smc

    fg = lt.compile_graph(_logpot_model("robot10"), dev)
    sizes = torch.as_tensor(fg.meta.np_global["disc_sizes"], device=dev)
    cfg = nuts.NUTSConfig(max_depth=3, init_step_size=0.05)
    gen = torch.Generator(dev).manual_seed(0)
    state = hmc.init_hmc_state(fg, gen, cfg.to_hmc(), 64)
    for _ in range(2):
        state, (acc, depth, div, _) = nuts.nuts_transition(fg, cfg, state,
                                                           gen, True)
    xc, xd, _, log_z, _ = smc.run_smc(
        fg, gen, smc.SMCConfig(n_particles=256, n_temps=3, n_moves=1))
    for a, b in ((state.xc, state.xd), (xc, xd)):
        assert a.is_cuda and b.is_cuda and bool(torch.isfinite(a).all())
        assert bool(((b >= 0) & (b < sizes[None])).all())
    assert bool(((acc >= 0) & (acc <= 1)).all()) and int(depth.max()) <= 3
    assert bool(torch.isfinite(log_z))


def _vi_models(name, device):
    """The lifted flagship (``friends_smokers(16)``, smokes(p0) = 1, K = 4,
    n_quad = 7) or the 10×10 grid (K = 8, n_quad = 9) on ``device``."""
    if name == "grid10":
        g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
        return lt.compile_graph(g, device), 8, 9
    from lhvi_tpu_torch.lift import compile_lifted
    from lhvi_tpu_torch.models.relational import friends_smokers

    rg = friends_smokers(n_people=16, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    return compile_lifted(rg.ground()[0], device), 4, 7


@pytest.mark.parametrize("name", ["flagship16", "grid10"])
def test_vi_elbo_on_the_card_equals_cpu(dev, name):
    """The ELBO and its gradient from the same parameters on the card and
    on the CPU, in f32: the value within rtol 1e-5, each gradient leaf
    within 1e-5·(1 + max |CPU leaf|)."""
    from lhvi_tpu_torch.engines import vi

    out = []
    for device in (dev, torch.device("cpu")):
        fg, K, n_quad = _vi_models(name, device)
        rng = np.random.default_rng(3)
        leaves = [torch.tensor(a, dtype=torch.float32, device=device,
                               requires_grad=True) for a in (
            rng.normal(0.0, 0.5, K), rng.normal(0.0, 1.0, (K, fg.n_cont)),
            rng.normal(-0.3, 0.3, (K, fg.n_cont)),
            rng.normal(0.0, 1.0, (K, fg.n_disc, fg.max_v)))]
        e = vi.elbo(fg, vi.VIParams(*leaves), n_quad)
        e.backward()
        out.append((float(e), [None if t.grad is None else t.grad.cpu()
                               for t in leaves]))
    (e_gpu, g_gpu), (e_cpu, g_cpu) = out
    np.testing.assert_allclose(e_gpu, e_cpu, rtol=1e-5)
    for a, b in zip(g_gpu, g_cpu):
        assert (a is None) == (b is None)
        if b is not None and b.numel():
            tol = 1e-5 * (1.0 + float(b.abs().max()))
            assert float((a - b).abs().max()) <= tol


def test_vi_fit_memory_does_not_grow_with_steps(dev):
    """``fit`` keeps its ELBO trace in one device tensor and reads nothing
    back, so its peak device memory is the same at 100 and at 1,000
    steps (4 bytes a step of trace aside)."""
    from lhvi_tpu_torch.engines import vi

    fg, K, n_quad = _vi_models("flagship16", dev)
    peaks = []
    for n_iters in (100, 100, 1000):  # the first run builds the plans
        cfg = vi.VIConfig(K=K, n_quad=n_quad, n_iters=n_iters)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        vi.fit(fg, torch.Generator(dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev) - base)
    assert peaks[2] - peaks[1] < 2**16, peaks


def _pod16(device):
    from lhvi_tpu_torch.models.relational import friends_smokers
    from lhvi_tpu_torch.relational.fast import fast_compile

    rg = friends_smokers(n_people=16, hybrid=True)
    for i in range(4):
        rg.observe("smokes", (f"p{i}",), i % 2)
    return fast_compile(rg, device)


def test_mode_swap_plan_on_the_card_equals_cpu(dev):
    """The plan built on the card equals the CPU's table for table, and
    the collapsed delta of one flip agrees within 1e-5 of the size of the
    sums it is the difference of (f32 sums in another order)."""
    from lhvi_tpu_torch.engines import modeswap

    fgs = [_pod16(dev), _pod16("cpu")]
    plans = [modeswap.build_mode_swap_plan(fg) for fg in fgs]
    a, b = plans
    assert (a.n_groups, a.vmax, a.has_f, a.direct_buckets, a.f_cells) == (
        b.n_groups, b.vmax, b.has_f, b.direct_buckets, b.f_cells)
    for x, y in [(a.vars_, b.vars_), (a.member, b.member),
                 (a.f_mask, b.f_mask), *zip(a.w_direct, b.w_direct)]:
        assert torch.equal(x.cpu(), y)
    rng = np.random.default_rng(0)
    xc = rng.normal(size=(64, fgs[1].n_cont)).astype(np.float32)
    xd = rng.integers(0, 2, size=(64, fgs[1].n_disc))
    xd_p = np.where(b.member[0].numpy()[None], 1 - xd, xd)
    out = []
    for fg, plan in zip(fgs, plans):
        d = fg.device
        out.append(modeswap.collapsed_delta(
            fg, torch.tensor(xc, device=d), torch.tensor(xd, device=d),
            torch.tensor(xd_p, device=d), plan, 0, 1.0)[0].cpu())
    L = modeswap._tempered_logits(fgs[1], b, 0, torch.tensor(xc),
                                  torch.tensor(xd), 1.0)
    scale = float(torch.logsumexp(L, -1)[:, b.f_mask[0]].abs().sum(-1).max())
    assert float((out[0] - out[1]).abs().max()) <= 1e-5 * (1.0 + scale)


def test_gabp_and_lbp_on_the_card_equal_cpu(dev):
    """GaBP on the 8×8 grid (the card's ``index_add_`` sums in another
    order: means and variances within rtol 1e-5) and LBP on the hybrid
    chain and the lifted 16-person flagship (beliefs within 1e-5 of the
    largest magnitude)."""
    from lhvi_tpu_torch.engines import gabp
    from lhvi_tpu_torch.engines.lbp import HybridLBP
    from lhvi_tpu_torch.lift import compile_lifted
    from lhvi_tpu_torch.models.toy import hybrid_chain

    g, _ = gaussian_grid(8, 8, seed=1, evidence_frac=0.1)
    e_gpu, e_cpu = (gabp.GaBP(g, d).run(iters=80) for d in (dev, "cpu"))
    np.testing.assert_allclose(e_gpu.mean_, e_cpu.mean_, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e_gpu.var_, e_cpu.var_, rtol=1e-5, atol=1e-6)
    from lhvi_tpu_torch.models.relational import friends_smokers

    g, _ = hybrid_chain()
    rg = friends_smokers(n_people=16, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    g16 = rg.ground()[0]
    for build in (lambda d: lt.compile_graph(g, d),
                  lambda d: compile_lifted(g16, d)):
        b_gpu, b_cpu = (HybridLBP(build(d)).run(n_iters=30).beliefs_
                        for d in (dev, "cpu"))
        tol = 1e-5 * (1.0 + np.abs(b_cpu).max())
        assert np.abs(b_gpu - b_cpu).max() <= tol


def test_run_hmc_mode_swap_memory_does_not_grow(dev):
    """``run_hmc`` with the move on keeps its accumulators in 0-d device
    tensors and reads nothing back in a transition: its peak device
    memory is the same at 10 and at 60 transitions."""
    from lhvi_tpu_torch.engines import hmc

    fg = _pod16(dev)
    cfg = hmc.HMCConfig(n_leapfrog=4, mode_swap=True)
    peaks = []
    for n in (10, 10, 60):  # the first run builds the plan
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        m, _, diag = hmc.run_hmc(fg, torch.Generator(dev).manual_seed(0), cfg,
                                 n_chains=64, n_warmup=0, n_samples=n,
                                 collect="moments", stream_diag=False)
        float(diag["mode_swap_accept"])
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev) - base)
    assert peaks[2] - peaks[1] < 2**16, peaks


# ---- K7 and K8: the sampler's moment and streamed-diagnostics update ----


def _ar1_stream(dev, C, n, S, seed):
    """S draws of C chains × n latents: an AR(1) process around 2 (so the
    accumulators carry sums far from 0, as the sampler's do)."""
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((C, n), generator=g, device=dev)
    for _ in range(S):
        x = 0.8 * x + 0.6 * torch.randn((C, n), generator=g, device=dev)
        yield (x + 2.0).contiguous()


@pytest.mark.parametrize("C,n", [(1024, 15600), (3, 17), (1, 1), (257, 1001)])
@pytest.mark.parametrize("S", [200, 201, 3, 1])
def test_stream_diag_kernel_matches_plain(dev, C, n, S):
    """K7 (``hmc._stream_diag_update`` on the card) against its plain twin
    over whole streams: the first draw (no lag-1 product), both halves,
    the odd tail draw (201), every batch boundary (⌊√S⌋ = 14 at 200) and
    no batches at all (3, 1); rows that are not a multiple of 4 (17, 1,
    1,001) and the bench's [1,024, 15,600]. The nine accumulators are
    equal bit for bit (each element is the twin's sequence of f32 ops,
    one rounding each, ATen's reciprocal for a division by a number), the
    same ones are passed through at every draw, and the streamed R̂ and
    ESS of both are equal."""
    from lhvi_tpu_torch.engines import hmc

    _k7_stream_matches_plain(hmc._stream_diag_init(C, n, dev),
                             _ar1_stream(dev, C, n, S, C * 7 + n + S), S)


def _k7_stream_matches_plain(sd, stream, S):
    """Run K7 and its plain twin over a whole stream from ``sd``; the nine
    accumulators and the streamed R̂ and ESS must agree bit for bit, the
    same arrays pass through at every draw, and K7 launches at every draw
    that changes more than ``prev``."""
    from lhvi_tpu_torch.engines import hmc

    half = S // 2
    bm_len, n_batches = hmc._bm_schedule(S)
    a = b = sd
    before = counters()["ops.k7.launches"]
    work = 0
    for t, xc in enumerate(stream):
        na = hmc._stream_diag_update(a, t, xc, half, bm_len, n_batches)
        nb = hmc._plain_stream_diag_update(b, t, xc, half, bm_len, n_batches)
        kept = [p is q for p, q in zip(nb, b)]
        assert [p is q for p, q in zip(na, a)] == kept, t
        assert na.prev is xc
        work += not all(kept[:5] + kept[6:])
        a, b = na, nb
    torch.cuda.synchronize()
    assert counters()["ops.k7.launches"] - before == work
    for name, p, q in zip(hmc._StreamDiag._fields, a, b):
        assert torch.equal(p, q), (name, float((p - q).abs().max()))
    fa = hmc._stream_diag_finalize(a, S, bm_len)
    fb = hmc._stream_diag_finalize(b, S, bm_len)
    for k in fa:
        torch.testing.assert_close(fa[k], fb[k], rtol=0, atol=0,
                                   equal_nan=True)


def test_stream_diag_kernel_unaligned_matches_plain(dev):
    """K7 on arrays that start 4 bytes past a 16-byte boundary (views at
    storage offset 1) takes its one-element path and still equals its
    twin bit for bit over a stream with both halves, the tail draw and
    batch boundaries."""
    from lhvi_tpu_torch.engines import hmc

    C, n, S = 64, 999, 29

    def offset(t):
        buf = torch.empty(C * n + 1, device=dev)
        v = buf[1:].view(C, n)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        return v

    g = torch.Generator(dev).manual_seed(5)
    sd = hmc._StreamDiag(*(offset(torch.randn((C, n), generator=g,
                                              device=dev))
                           for _ in range(9)))
    stream = (offset(x) for x in _ar1_stream(dev, C, n, S, 6))
    _k7_stream_matches_plain(sd, stream, S)


@pytest.mark.parametrize("C,n", [(1024, 15600), (16384, 15600), (3, 17),
                                 (1, 1), (257, 1001), (4097, 64)])
def test_moment_sums_kernel_within_f32_summation_error(dev, C, n):
    """K8 (``hmc._moment_sums`` on the card) against float64 sums: each
    column is summed over the chains in double, rounded to f32 and added
    to the running sum, two f32 roundings of numbers no larger than
    |s| + Σ_c |x|, so |got − exact| ≤ 4·2⁻²⁴·(|s| + Σ_c |x|) (x² for the
    second sum); a second call gives the same bits (no atomics)."""
    from lhvi_tpu_torch.engines import hmc

    g = torch.Generator(dev).manual_seed(C + n)
    xc = 3.0 * torch.randn((C, n), generator=g, device=dev) + 1.0
    s1 = C * torch.randn((n,), generator=g, device=dev)
    s2 = C * torch.rand((n,), generator=g, device=dev)
    before = counters()["ops.k8.launches"]
    got = hmc._moment_sums(s1, s2, xc)
    again = hmc._moment_sums(s1, s2, xc)
    torch.cuda.synchronize()
    assert counters()["ops.k8.launches"] == before + 2
    x = xc.double()
    for s, terms, out, rep in ((s1, x, got[0], again[0]),
                               (s2, x * x, got[1], again[1])):
        exact = s.double() + terms.sum(0)
        tol = 4 * 2.0**-24 * (s.double().abs() + terms.abs().sum(0))
        assert bool(((out.double() - exact).abs() <= tol).all())
        assert torch.equal(out, rep)


def test_moment_kernels_reject_bad_input(dev):
    """K7 and K8 take f32 contiguous tensors of matching shapes on the
    card and raise on anything else, launching nothing."""
    from lhvi_tpu_torch.engines import hmc

    sd = hmc._stream_diag_init(4, 8, dev)
    x = torch.zeros((4, 8), device=dev)
    s = torch.zeros((8,), device=dev)
    before = counters()
    with pytest.raises(TypeError):
        hmc._stream_diag_update(sd, 1, x.double(), 2)
    with pytest.raises(ValueError):
        hmc._stream_diag_update(sd, 1, torch.zeros((8, 4), device=dev).t(), 2)
    with pytest.raises(ValueError):
        hmc._stream_diag_update(sd, 1, torch.zeros((4, 9), device=dev), 2)
    with pytest.raises(TypeError):
        hmc._moment_sums(s.double(), s, x)
    with pytest.raises(ValueError):
        hmc._moment_sums(s, s, torch.zeros((8, 4), device=dev).t())
    with pytest.raises(ValueError):
        hmc._moment_sums(s[:4], s, x)
    for k in ("ops.k7.launches", "ops.k8.launches"):
        assert counters()[k] == before[k]


def test_moment_kernels_run_every_draw_and_diag_frozen_holds(dev,
                                                             monkeypatch):
    """A banded ``run_hmc`` moments query launches K7 and K8 once a draw
    (``ops.k7.launches`` = ``ops.k8.launches`` = ``hmc.draws``) and the
    update reads nothing back. With ``hmc._stream_diag_update`` replaced
    by ``lambda sd, *a, **kw: sd``, as the benchmark's fault
    ``diag_frozen`` does, K7 never runs, the nine accumulators stay 0
    (R̂ reads 0, both ESS S × C) and the means and variances are the
    unpatched query's, bit for bit."""
    from lhvi_tpu_torch.engines import hmc

    g, _ = gaussian_grid(24, 24, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, dev, quad_max_n=256)
    assert fg.quad_dia_offsets is not None
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.05)
    C, S = 256, 30

    def query():
        before = counters()
        out = hmc.run_hmc(fg, torch.Generator(dev).manual_seed(3), cfg,
                          n_chains=C, n_warmup=20, n_samples=S,
                          collect="moments", stream_diag=True)
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in counters().items()}

    (m, _, d), seen = query()
    assert seen["hmc.draws"] == S and seen["ops.k2.launches"] == 20 + S
    assert seen["ops.k7.launches"] == seen["ops.k8.launches"] == S
    assert float((d["rhat"] - 1).abs().max()) < 0.5
    ms = hmc._MomentStream(fg, C, 10, True, 0)
    xs = list(_ar1_stream(dev, C, fg.n_cont, 10, 1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t, xc in enumerate(xs):
            ms.update(t, xc, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    monkeypatch.setattr(hmc, "_stream_diag_update", lambda sd, *a, **kw: sd)
    (mf, _, df), seen = query()
    assert seen["ops.k7.launches"] == 0 and seen["ops.k8.launches"] == S
    assert torch.equal(mf["mean"], m["mean"])
    assert torch.equal(mf["var"], m["var"])
    assert bool((df["rhat"] == 0).all())
    for k in ("ess_bm", "ess_proxy"):
        assert bool((df[k] == S * C).all()), k
