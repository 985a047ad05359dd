#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``lhvi_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the port's CUDA kernels from ``lhvi_tpu_torch/ops/csrc``;
3. K1 (dense leapfrog) against its plain PyTorch version on the card, at
   the bench shape (10×10 grid, 65,536 chains) and at n = 3,246 (64×64);
4. K2 (banded HMC proposal) against its plain version on the 128×128
   bench grid at 1,024 chains, through the wrapper the main path calls:
   one trajectory with given momenta, then the in-kernel Philox momenta's
   statistics; the inertness of gap lanes on embedded rows;
5. the slice end to end — ``compile_graph`` → ``hmc.run_hmc(collect=
   "moments")`` — on the 10×10 grid (65,536 chains) and the 128×128 grid
   (1,024 chains), held to exact numpy/scipy oracles built from the port's
   own information form, with the kernels' launch counters reset just
   before and read just after.

The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, after a warm
    call, each bracketed by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(got, want) -> float:
    """max |got − want| / max(1, |want|)."""
    import torch

    d = (got.double() - want.double()).abs()
    return float((d / torch.clamp(want.double().abs(), min=1.0)).max())


def phase_k1(dev, cases=((10, 65536), (64, 4096))):
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.ops import leapfrog as lf

    tol = 1e-4
    log(f"[K1] tolerance |dx|,|dp| <= {tol}*max(1,|plain|): both f32; the "
        "kernel sums x.J in k order with FMAs, cuBLAS in its own blocked "
        "order, over 9 gradient evaluations")
    record = None
    for rows, C in cases:
        g, _ = gaussian_grid(rows, rows, seed=0, evidence_frac=0.2)
        fg = compile_graph(g, dev)
        n = fg.n_cont
        gen = torch.Generator(dev).manual_seed(rows)
        x = 2.0 * torch.randn((C, n), generator=gen, device=dev)
        im = 0.5 + torch.rand((n,), generator=gen, device=dev)
        p = torch.randn((C, n), generator=gen, device=dev) / torch.sqrt(im)
        eps = torch.full((), 0.12, device=dev)
        args = (x, p, fg.quad_J, fg.quad_h, im, eps, 8)
        got = lf.quad_leapfrog(*args)
        want = lf._torch_quad_leapfrog(*args)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ok = all(torch.isfinite(a).all() for a in got)
        ms = time_ms(lambda: lf.quad_leapfrog(*args))
        plain_ms = time_ms(lambda: lf._torch_quad_leapfrog(*args))
        log(f"[K1] {rows}x{rows} grid n={n} C={C} 8 steps: max abs err "
            f"{abs_err:.3e}, max rel err x1 {errs[0]:.3e} p1 {errs[1]:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not ok or max(errs) > tol:
            raise AssertionError(f"K1 disagrees with its plain version at n={n}")
        if rows == 10:  # the main path's shape
            record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
    return record


def phase_k2(dev, rows=128, C=1024):
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.ops import dia

    g, _ = gaussian_grid(rows, rows, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev, quad_max_n=min(4096, rows * rows // 4))
    assert fg.quad_dia_offsets == (-rows, -1, 1, rows), fg.quad_dia_offsets
    n, steps = fg.n_cont, 8
    offs, wdia, pos = fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_dia_pos
    n_emb = wdia.shape[1]
    gen = torch.Generator(dev).manual_seed(7)
    im = 0.5 + torch.rand((n,), generator=gen, device=dev)
    x = 2.0 * torch.randn((C, n), generator=gen, device=dev)
    p0 = torch.randn((C, n), generator=gen, device=dev) / torch.sqrt(im)
    eps = torch.full((), 0.05, device=dev)
    log(f"[K2] {rows}x{rows} grid: {n} latents, n_emb {n_emb}, offsets {offs}, "
        f"C={C}, {steps} steps")

    def proposal(xx, n_steps=steps, p=None):
        """The main path's call: latent rows in and out of the wrapper."""
        return dia.dia_hmc_proposal(
            gen, xx, fg.quad_diag, offs, wdia, fg.quad_h, im, eps, n_steps,
            pos=pos, inv=fg.quad_dia_inv, p0=p)

    def plain(xx, pp, dtype):
        """The plain version in latent coordinates: dia_quad_leapfrog
        (embedding by scatter through ``pos``) plus the energies."""
        cast = lambda t: t.to(dtype)  # noqa: E731
        x1, p1, lp0, lp1 = dia.dia_quad_leapfrog(
            cast(xx), cast(pp), cast(fg.quad_diag), offs, cast(wdia),
            cast(fg.quad_h), cast(im), cast(eps), steps, pos=pos)
        ke = lambda q: 0.5 * torch.sum(cast(im)[None] * q * q, -1)  # noqa: E731
        lacc = torch.clamp((lp1 - lp0) + (ke(cast(pp)) - ke(p1)), max=0.0)
        return x1, p1, lacc, lp0.abs() + ke(cast(pp))

    # exact mode: the same momenta through the wrapper and the plain
    # version, forward from a dispersed state (downhill: log_acc clips to
    # 0) and back from the endpoint with reversed momenta (uphill)
    tol_x, tol_l32, tol_l64 = 1e-4, 1e-5, 1e-7
    ex = abs_x = el32 = el64 = 0.0
    n_neg = 0
    xs, ps = x, p0
    for leg in ("forward", "reversed"):
        x1k, lk = proposal(xs, p=ps)
        x1p, p1p, lp32, scale = plain(xs, ps, torch.float32)
        lp64 = plain(xs, ps, torch.float64)[2]
        torch.cuda.synchronize()
        ex = max(ex, rel_err(x1k, x1p))
        abs_x = max(abs_x, float((x1k - x1p).abs().max()))
        el32 = max(el32, float(((lk.double() - lp32.double()).abs()
                                / scale.double()).max()))
        el64 = max(el64, float(((lk.double() - lp64).abs()
                                / scale.double()).max()))
        n_neg += int((lp64 < 0).sum())
        if not torch.isfinite(lk).all():
            raise AssertionError(f"K2 log_acc not finite ({leg})")
        log(f"[K2] exact mode, {leg}: mean accept prob "
            f"{float(torch.exp(lk).mean()):.4f}")
        xs, ps = x1p.contiguous(), (-p1p).contiguous()
    log(f"[K2] exact mode through dia_hmc_proposal: x1 max abs err "
        f"{abs_x:.3e}, max rel err {ex:.3e} (tol {tol_x}*max(1,|plain|): f32 "
        f"trajectory, FMA contraction); log_acc err / (|lp0|+ke0): "
        f"{el32:.3e} vs plain f32 (tol {tol_l32}: the plain version's own "
        f"f32 sums of that size round at ~1e-7 each, over 16k lanes), "
        f"{el64:.3e} vs plain f64 (tol {tol_l64}: the kernel sums energies "
        f"in double, so only its f32 trajectory differs); {n_neg} of {2 * C} "
        f"log_acc values below 0")
    if (ex > tol_x or el32 > tol_l32 or el64 > tol_l64 or n_neg < C // 2):
        raise AssertionError("K2 disagrees with its plain version")

    # in-kernel Philox momenta through the wrapper, read back from a
    # one-step trajectory: p0 = (x1 − x0)/(ε·im) − ½ε·g0, z = p0·√im
    gen.manual_seed(12345)
    x1a, _ = proposal(x, 1)
    x1c, _ = proposal(x, 1)  # the next proposal on the same generator
    gen.manual_seed(12345)
    x1b, _ = proposal(x, 1)
    g0 = fg.quad_h.double()[None] - dia.dia_matvec(
        x.double(), fg.quad_diag.double(), offs, wdia.double(), pos=pos)

    def z_of(x1):
        pr = (x1.double() - x.double()) / (eps.double() * im.double()[None])
        return (pr - 0.5 * eps.double() * g0) * torch.sqrt(im.double())[None]

    za, zc = z_of(x1a), z_of(x1c)
    m = za.mean(0)
    v = za.var(0)
    N = za.numel()
    zm = float(za.mean())
    zv = float(za.var())
    kurt = float(((za - zm) ** 4).mean() / zv**2)
    rho_adj = float((za[:, :-1] * za[:, 1:]).mean())
    rho_step = float((za * zc).mean())
    stats = dict(
        lane_mean_z_max=float((m.abs() * C**0.5).max()),
        lane_var_dev_max=float((v - 1).abs().max()),
        pooled_mean=zm, pooled_var=zv, kurtosis=kurt,
        adjacent_corr=rho_adj, step_corr=rho_step)
    log(f"[K2] in-kernel momenta over {C} chains x {n} lanes: "
        + ", ".join(f"{k} {v_:.4g}" for k, v_ in stats.items()))

    # gap lanes, seen only in embedded coordinates: the launcher on rows
    # whose gap lanes hold random non-zero positions, which must not move
    inv = fg.quad_dia_inv
    gap = torch.ones(n_emb, dtype=torch.bool, device=dev)
    gap[pos] = False
    emb = lambda a: dia._embed_gather(a, inv).contiguous()  # noqa: E731
    xg = emb(x)
    xg[:, gap] = torch.randn((C, int(gap.sum())), generator=gen, device=dev)
    im_e = emb(im)
    kargs = (emb(fg.quad_diag), offs, wdia, emb(fg.quad_h), im_e,
             dia._momentum_std(im_e), eps, steps, 99, 0)
    x1g, lg = dia._cuda_dia_proposal(xg, *kargs)
    torch.cuda.synchronize()
    gap_moved = int((x1g[:, gap] != xg[:, gap]).sum())
    log(f"[K2] gap lanes moved: {gap_moved} (of {C * int(gap.sum())}); same "
        f"generator state bitwise equal: {bool(torch.equal(x1a, x1b))}; next "
        f"proposal differs: {not torch.equal(x1a, x1c)}")
    se = 1.0 / N**0.5
    checks = (
        stats["lane_mean_z_max"] < 5.5,          # |z| of 13k lane means
        stats["lane_var_dev_max"] < 6 * (2.0 / C) ** 0.5,
        abs(zm) < 5 * se,
        abs(zv - 1) < 5 * (2.0 / N) ** 0.5,
        abs(kurt - 3) < 5 * (24.0 / N) ** 0.5,
        abs(rho_adj) < 5 * se, abs(rho_step) < 5 * se,
        gap_moved == 0, bool(torch.isfinite(lg).all()),
        torch.equal(x1a, x1b), not torch.equal(x1a, x1c),
    )
    if not all(checks):
        raise AssertionError(f"K2 momentum statistics off: {checks}")

    def plain_proposal():
        pp = torch.randn((C, n), generator=gen, device=dev) / torch.sqrt(im)
        return plain(x, pp, torch.float32)[2]

    ms = time_ms(lambda: proposal(x))
    kernel_ms = time_ms(lambda: dia._cuda_dia_proposal(xg, *kargs))
    plain_ms = time_ms(plain_proposal)
    log(f"[K2] proposal (momenta + {steps}-step trajectory + energies), latent "
        f"rows in and out: dia_hmc_proposal {ms:.4f} ms (kernel alone on "
        f"embedded rows {kernel_ms:.4f} ms), plain {plain_ms:.4f} ms")
    return dict(max_abs_err=abs_x, ms=ms, plain_ms=plain_ms)


def run_and_time(hmc, fg, cfg, dev, n_chains, n_samples):
    """Bench-style throughput: a sampling-only moments run (no warmup, no
    streamed diagnostics), median of 3 after a warm run, host clock around
    work ending in a synchronize."""
    import torch

    def run(seed):
        gen = torch.Generator(dev).manual_seed(seed)
        moments, _, _ = hmc.run_hmc(fg, gen, cfg, n_chains=n_chains,
                                    n_warmup=0, n_samples=n_samples,
                                    collect="moments", stream_diag=False)
        float(moments["mean"][0])

    run(100)
    times = []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(101 + rep)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return n_chains * n_samples / dt, (max(times) - min(times)) / dt


def phase_slice(dev, smi, rows=128, chains=(65536, 1024)):
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.models.toy import gaussian_grid

    rates = {}
    # headline: bench.py's model and settings
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    cfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.12)
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    mean_x, var_x = np.linalg.solve(J, h), np.diag(np.linalg.inv(J))
    moments, _, diag = hmc.run_hmc(
        fg, torch.Generator(dev).manual_seed(0), cfg, n_chains=chains[0],
        n_warmup=200, n_samples=200, collect="moments")
    check_moments("10x10", moments, diag, mean_x, np.arange(fg.n_cont), var_x)
    rates["grid10x10"] = run_and_time(hmc, fg, cfg, dev, chains[0], 100)

    # past the dense cap: 128×128 evidence grid on the banded path
    g, _ = gaussian_grid(rows, rows, seed=1, evidence_frac=0.05)
    fg = compile_graph(g, dev, quad_max_n=min(4096, rows * rows // 4))
    assert fg.quad_sparse and hmc._use_dia(fg, hmc.HMCConfig())
    n = fg.n_cont
    diag_np = fg.quad_diag.cpu().numpy().astype(np.float64)
    col = fg.quad_ell_col.cpu().numpy()
    w = fg.quad_ell_w.cpu().numpy().astype(np.float64)
    Jsp = sp.csc_matrix((np.concatenate([diag_np, w.ravel()]),
                         (np.concatenate([np.arange(n), np.repeat(np.arange(n),
                                                                  col.shape[1])]),
                          np.concatenate([np.arange(n), col.ravel()]))),
                        shape=(n, n))
    lu = spla.splu(Jsp)
    mean_x = lu.solve(fg.quad_h.cpu().numpy().astype(np.float64))
    spot = np.random.default_rng(0).choice(n, 64, replace=False)
    var_x = np.array([lu.solve(np.eye(n, 1, -int(i)).ravel())[i] for i in spot])
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.05)
    moments, _, diag = hmc.run_hmc(
        fg, torch.Generator(dev).manual_seed(0), cfg, n_chains=chains[1],
        n_warmup=200, n_samples=400, collect="moments")
    check_moments(f"{rows}x{rows}", moments, diag, mean_x, spot, var_x)
    rates[f"grid{rows}x{rows}"] = run_and_time(hmc, fg, cfg, dev, chains[1],
                                               20)
    for k, (rate, spread) in rates.items():
        log(f"[slice] {k}: {rate:.6g} samples/s (rep spread {spread:.3f}) "
            f"on {smi}")
    return rates


def check_moments(name, moments, diag, mean_x, spot, var_x):
    """tests/test_ell_oracle.py:76-94 thresholds."""
    import numpy as np

    m = moments["mean"].cpu().numpy().astype(np.float64)
    v = moments["var"].cpu().numpy().astype(np.float64)
    acc = float(diag["accept_rate"])
    err = np.abs(m - mean_x)
    rel = np.abs(v[spot] / var_x - 1.0)
    ess = diag["ess_bm"].cpu().numpy()
    log(f"[slice] {name}: accept {acc:.4f}, step {float(diag['step_size']):.4g}, "
        f"mean err mean {err.mean():.4f} max {err.max():.4f}, var rel err "
        f"mean {rel.mean():.4f} max {rel.max():.4f} ({len(spot)} dims), "
        f"ess_bm min {ess.min():.1f}, rhat max {float(diag['rhat'].max()):.4f}")
    ok = (0.6 < acc <= 1.0 and err.mean() < 0.05 and err.max() < 0.25
          and rel.mean() < 0.10 and rel.max() < 0.35
          and np.isfinite(ess).all() and ess.min() > 100)
    if not ok:
        raise AssertionError(f"{name}: moments off the exact oracle")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # the port is imported before anything is printed: outside a checkout
    # the script fails here, with no output on stdout
    import lhvi_tpu_torch  # noqa: F401  (turns TF32 off)
    from lhvi_tpu_torch.ops import _build
    from lhvi_tpu_torch.ops.dia import dia_hmc_proposal
    from lhvi_tpu_torch.ops.leapfrog import quad_leapfrog

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.lib()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[build] " + line.strip())

    k1 = phase_k1(dev)
    k2 = phase_k2(dev)

    quad_leapfrog.launches = 0
    dia_hmc_proposal.launches = 0
    phase_slice(dev, smi)
    launches = {"quad_leapfrog": quad_leapfrog.launches,
                "dia_proposal": dia_hmc_proposal.launches}
    log(f"[slice] kernel launches on the main path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    kernels = [
        {"name": "quad_leapfrog", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/quad_leapfrog.cu",
         "replaces": "lhvi_tpu/ops/leapfrog.py:53",
         "launches": launches["quad_leapfrog"], **k1},
        {"name": "dia_proposal", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/dia_proposal.cu",
         "replaces": "lhvi_tpu/ops/dia.py:354",
         "launches": launches["dia_proposal"], **k2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
