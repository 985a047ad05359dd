"""K1's plain version and the ELL leapfrog held to the JAX reference.

Identical (x, p, ε, inv_mass), made with numpy, go through the reference
(the Pallas K1 in interpret mode, and its jnp fallback) and the port. The
tolerance is |Δ| ≤ 1e-5·max(1, |ref|): the same f32 arithmetic with the
[C,n]×[n,n] dot products summed in another order. The CUDA kernel itself
runs only on the card (chip_smoke.py, tests/test_torch_cuda_kernels.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.ops import leapfrog as ref_lf  # noqa: E402

from lhvi_tpu_torch.ops import leapfrog as lf  # noqa: E402
from lhvi_tpu_torch.utils.metrics import counters  # noqa: E402


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bound = 1e-5 * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= bound), (
        what, float(np.max(np.abs(got - want) / bound)))


@pytest.fixture(scope="module")
def dense_inputs():
    g, _ = ref_toy.gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = ref_compile(g)
    n = fg.n_cont
    rng = np.random.default_rng(0)
    return dict(
        x=rng.normal(0.0, 2.0, (16, n)).astype(np.float32),
        p=rng.normal(size=(16, n)).astype(np.float32),
        J=np.array(fg.quad_J), h=np.array(fg.quad_h),
        im=rng.uniform(0.5, 1.5, n).astype(np.float32), eps=0.07,
    )


@pytest.mark.parametrize("n_steps", [1, 8])
def test_plain_quad_leapfrog_matches_reference(dense_inputs, n_steps):
    d = dense_inputs
    tx, tp = torch.from_numpy(d["x"]), torch.from_numpy(d["p"])
    got = lf._torch_quad_leapfrog(
        tx, tp, torch.from_numpy(d["J"]), torch.from_numpy(d["h"]),
        torch.from_numpy(d["im"]), d["eps"], n_steps)
    j = {k: jnp.asarray(d[k]) for k in ("x", "p", "J", "h", "im")}
    ref_jnp = ref_lf._jnp_quad_leapfrog(j["x"], j["p"], j["J"], j["h"],
                                        j["im"], d["eps"], n_steps)
    with pltpu.force_tpu_interpret_mode():
        ref_k1 = ref_lf._pallas_quad_leapfrog(
            j["x"], j["p"], j["J"], j["h"], j["im"], jnp.asarray(d["eps"]),
            n_steps)
    for a, b, r, name in zip(got, ref_jnp, ref_k1, ("x1", "p1")):
        _close(a.numpy(), b, (name, "jnp", n_steps))
        _close(a.numpy(), r, (name, "pallas-interpret", n_steps))


def test_quad_leapfrog_cpu_takes_plain_path(dense_inputs):
    """CPU tensors run the plain version and never touch the kernel or its
    launch counter; a device without a route raises."""
    d = dense_inputs
    args = [torch.from_numpy(d[k]) for k in ("x", "p", "J", "h", "im")]
    before = counters()["ops.k1.launches"]
    got = lf.quad_leapfrog(*args, torch.tensor(d["eps"]), 3)
    want = lf._torch_quad_leapfrog(*args, torch.tensor(d["eps"]), 3)
    assert counters()["ops.k1.launches"] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [a.to("meta") for a in args]
    with pytest.raises(NotImplementedError):
        lf.quad_leapfrog(*meta, 0.1, 3)


@pytest.fixture(scope="module")
def sparse_fg():
    g, _ = ref_toy.gaussian_grid(16, 16, seed=0, evidence_frac=0.15)
    fg = ref_compile(g, quad_max_n=64)
    assert fg.quad_sparse
    return fg


@pytest.mark.parametrize("n_steps", [0, 1, 8])
def test_ell_quad_leapfrog_matches_reference(sparse_fg, n_steps):
    fg = sparse_fg
    n = fg.n_cont
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 2.0, (5, n)).astype(np.float32)
    p = rng.normal(size=(5, n)).astype(np.float32)
    im = rng.uniform(0.5, 2.0, n).astype(np.float32)
    tabs = [np.array(a) for a in (fg.quad_diag, fg.quad_ell_col,
                                    fg.quad_ell_w, fg.quad_h)]
    ref = ref_lf.ell_quad_leapfrog(jnp.asarray(x), jnp.asarray(p),
                                   *map(jnp.asarray, tabs), jnp.asarray(im),
                                   0.05, n_steps)
    diag, col, w, h = (torch.from_numpy(a) for a in tabs)
    got = lf.ell_quad_leapfrog(torch.from_numpy(x), torch.from_numpy(p), diag,
                               col.long(), w, h, torch.from_numpy(im), 0.05,
                               n_steps)
    for a, b, name in zip(got, ref, ("x1", "p1", "g0", "g1")):
        _close(a.numpy(), b, (name, n_steps))
    np.testing.assert_array_equal(
        lf.ell_matvec(torch.from_numpy(x), diag, col.long(), w).numpy(),
        np.asarray(ref_lf.ell_matvec(jnp.asarray(x), *map(jnp.asarray,
                                                          tabs[:3]))))


# ---- K1's launch geometry (csrc/quad_leapfrog.cu checks what it is given) --

_CSRC = Path(lf.__file__).parent / "csrc" / "quad_leapfrog.cu"


def _cu_const(name):
    """An integer ``constexpr`` of the kernel source, as the kernel sees it."""
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);",
                  _CSRC.read_text())
    assert m, name
    return int(eval(m.group(1), {"sizeof": lambda _: 4, "float": None}))


def test_k1_launch_mirrors_the_kernel_constants():
    """The Python geometry and the launcher's checks agree on the layout
    edge (n = 256), the block shapes and the shared-memory limit."""
    src = _CSRC.read_text()
    assert "n > 256 || chains != m" in src
    assert lf.K1_RESIDENT_MAX_N == 256
    assert _cu_const("kRWarps") == lf.K1_RESIDENT_WARPS
    assert _cu_const("kBM") == _cu_const("kBN") == lf.K1_TILE
    assert _cu_const("kBK") == lf.K1_BK
    assert _cu_const("kCThreads") == 32 * lf.K1_COOP_WARPS
    assert _cu_const("kSmemLimit") == lf.K1_SMEM_LIMIT == 232448
    assert "__launch_bounds__(kCThreads, 2)" in src
    assert lf.K1_COOP_BLOCKS_PER_SM == 2


@pytest.mark.parametrize("C", [1, 3, 45, 101, 4096, 65536])
def test_k1_launch_fits_and_switches_layout_at_256(C):
    """For every n in 1..4,096 (a stride past 300): the geometry fits
    232,448 bytes; n ≤ 256 is resident with 8, 4 or 2 chains a warp by
    NP = ceil(n/32), a grid covering C exactly once, the tile's pad
    stride and J in shared memory only while 113 KB still holds it; past
    256 the cooperative layout, at most 264 blocks and never more than
    the output tiles, with the padded scratch the kernel lays out."""
    for n in list(range(1, 301)) + list(range(301, 4097, 37)) + [4096]:
        geo = lf.k1_launch(n, C)
        assert geo.smem <= 232448
        if n <= 256:
            np_ = -(-n // 32)
            M = 8 if np_ <= 3 else (4 if np_ <= 6 else 2)
            stride = 4 * M + (4 if M >= 4 else 2)
            tile = -(-4 * n * stride // 16) * 16
            assert geo.layout == "resident" and geo.chains == M
            assert geo.warps == 4 and stride == lf.k1_tile_stride(M)
            assert (geo.grid - 1) * 4 * M < C <= geo.grid * 4 * M
            assert geo.smem == tile + (4 * n * n if geo.j_smem else 0)
            assert geo.j_smem == (tile + 4 * n * n <= 113 * 1024)
            assert geo.scratch == 0
        else:
            Cp, kp, npd = (-(-C // 128) * 128, -(-n // 16) * 16,
                           -(-n // 128) * 128)
            tiles = (Cp // 128) * (npd // 128)
            assert geo.layout == "coop" and geo.chains == 128
            assert geo.warps == 8 and geo.smem == 2 * 16 * 256 * 4
            assert geo.grid == min(tiles, 264) and not geo.j_smem
            assert geo.scratch == kp * npd + 2 * kp * Cp + npd * Cp


def test_k1_launch_at_the_bench_shapes():
    """The 10×10 grid (n = 82) at 65,536 chains: 8 chains a warp, 32 a
    block, J beside the tile; the 64×64 grid (n = 3,246) at 4,096 chains:
    832 output tiles over 264 resident blocks."""
    assert lf.k1_launch(82, 65536) == lf.K1Launch(
        "resident", 8, 4, 11808 + 26896, 2048, True, 0)
    geo = lf.k1_launch(3246, 4096)
    assert geo.layout == "coop" and geo.grid == 264
    assert lf.k1_launch(3246, 4096, sms=100).grid == 200
    for bad in ((0, 5), (4097, 5), (82, 0)):
        with pytest.raises(ValueError):
            lf.k1_launch(*bad)
