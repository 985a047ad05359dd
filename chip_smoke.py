#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``lhvi_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --phase runtime`` builds the kernels and runs only
the named paths of phase 6, comma-separated (``hybrid`` needs ``robot``
before it), and prints no result lines.
``python3 chip_smoke.py --profile`` instead builds the kernels and
profiles the ``grid10x10`` HMC, ``nuts10x10``, ``grid128x128`` HMC,
``smc_denoise11`` fused, ``vi10x10``, ``vi_lifted320`` and the pod cells
(``--profile pod``: those alone) with
``torch.profiler``: device idle share,
kernels per unit, the largest kernels' shares; then K1, K2, K3 and K5
alone at zero and at the main path's steps, and K4 at N = 1, 4,096,
16,384 and 65,536 (wrapper, launcher, the kernel's device time). PERF.md
§5 and §6 read it.)

Phases (any failure raises and the script exits non-zero):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the port's CUDA kernels from ``lhvi_tpu_torch/ops/csrc``;
3. K1 (dense leapfrog) against its plain PyTorch version on the card, at
   the bench shape (10×10 grid, 65,536 chains) and at n = 3,246 (64×64);
4. K2 (banded HMC proposal) against its plain version on the 128×128
   bench grid at 1,024 chains, through the wrapper the main path calls:
   one trajectory with given momenta, then the in-kernel Philox momenta's
   statistics; the folded embedding (pre-embedded rows with random gap
   lanes give the latent-row call bitwise and move no gap lane); the
   cluster layout's edge shapes (a 16×16 grid at 37 chains, 1,021 chains,
   DIA_MAX_EMB lanes);
5. K3 (NUTS trajectory) against its plain version (the lockstep loop) on
   the same momenta and uniforms table, at the bench shape (n = 82,
   65,536 chains, max_depth 4), at max_depth 8 and at n = 3,246 (each
   also timed on the main path's route, in-kernel Philox), then its
   in-kernel uniforms; K4 (SMC weight pipeline) against its plain version
   in f64 at N ∈ {7, 1,000, 4,096, 16,384, 65,536, 262,145, 4,194,307}
   (both layouts; two launches bitwise equal), timed at N ∈ {1, 4,096,
   16,384, 65,536} through the wrapper and the launcher alone; K5 (fused
   non-quadratic leapfrog) against both plain versions (autograd, and the
   tape twin) on ``robot_map(100)`` (16,384 chains, 8 steps, untempered
   and at β = 0.3 against the SMC base), the 11×11 and 16×16 denoising
   grids (4,096 chains, 5 steps), ``robot_map(100)`` at 4,099 chains and
   a 127-node tape, and on the pod graph's continuous part
   (``fast_compile`` of friends_smokers(320): 320 stress latents, 128
   chains, 8 steps);
   K6 (banded leapfrog from given momenta) through ``dia_quad_leapfrog``
   on the 128×128 grid's latent rows (1,024 chains, 1 and 8 steps) and on
   K2's edge shapes against its plain version in f32 and f64;
6. the paths end to end, each with every kernel's launch counter reset
   just before it and read just after: ``hmc.run_hmc`` on the 10×10 grid
   (65,536 chains) and the 128×128 grid (1,024 chains); ``nuts.run_nuts``
   on the 10×10 grid (65,536 chains); ``smc.sample`` on
   ``kalman_lds(T=20)`` (65,536 particles, fixed and adaptive schedules)
   and the 10×10 grid; the robot path: HMC-within-Gibbs on
   ``robot_map(100)`` (16,384 chains × 50 samples) with
   ``fused_logpot=True`` (K5 on every proposal) and False, the two runs'
   agreement, the small robot instance against exact enumeration
   (65,536 chains), ``hybrid_chain``'s closed forms and SMC on the
   denoising grid through K5; ``dia_quad_leapfrog`` (K6) driven forward
   and back on the 128×128 grid; and the hybrid path: NUTS-within-Gibbs
   on ``hybrid_chain`` and the small robot instance against exact
   enumeration, on ``robot_map(100)`` at bench.py's NUTS settings (16,384
   chains × 20 samples, timed) and against the fused HMC run, then SMC
   with tempered Gibbs on ``hybrid_chain``; the VI path: ``vi10x10``
   (``fit`` on the 10×10 grid, K=8, 1,000 steps, the mixture means
   against the dense solve), ``vi_lifted320`` (friends_smokers(320) with
   32 observed smokes, native colour refinement, ``compile_lifted``, K=4,
   1,500 steps, the observed people's cancer marginals against σ(1.2)
   and 1/2), ``lift_invariant320`` (the fitted lifted parameters carried
   to the grounded graph: the same ELBO) and ``vi_c2f_fast1000``
   (``infer_c2f_fast`` on ``fast_compile`` of friends_smokers(1,000),
   ~1M latents, the same closed forms); the pod path: ``pod320``
   (``run_hmc`` on ``fast_compile`` of the 320-person model, 128 chains
   × 16 samples, the pooled cancer marginals within 5 standard errors of
   the closed forms) and ``fast_compile`` against ``compile_graph`` on
   that model; the mode-swap path (``phase_modeswap``: HMC, NUTS and SMC
   with the move on the locked spin clique at 4,096 chains against exact
   enumeration, ``modeswap40``'s unlock, ``pod320_modeswap`` with the
   move every transition and every 4th); the pod scale path
   (``phase_pod_scale``: ``pod600`` and ``pod1000``, bench.py:449-452 at
   full size); the BP path (``phase_bp``: GaBP on the 10×10 and 128×128
   grids against the dense solve and a sparse LU, LBP and EPBP on
   ``hybrid_chain`` with ``belief(x)``, EPBP on the 10×10 grid, lifted
   LBP on the 320-person flagship, MaxWalkSAT against exact modes); the
   runtime path (``phase_runtime``): ``sample_checkpointed`` through K1
   (10×10 grid, 65,536 chains), K2 (128×128 grid, 1,024 chains), K3 (NUTS,
   10×10, 65,536 chains) and K5 (``hybrid_chain`` fused, 16,384 chains),
   each uninterrupted and interrupted at the warmup's phase boundary and
   after a sample chunk, then resumed: bitwise equal, and held to the
   oracles; two ranks on the one card (``--rank-worker``: two processes
   of this script joined over gloo on localhost, each on ``cuda:0``):
   sharded ``run_hmc`` with adaptation off against the pooled unsharded
   runs of each rank's stream, sharded ``run_hmc`` and ``run_nuts`` with
   adaptation (step size and mass identical on both ranks), sharded
   ``run_smc`` on ``kalman_lds(T=20)`` at 65,536 particles (both
   schedules, K4 on each rank), the multi-rank dry run
   (``dryrun_steps``: the VI Adam step on the factor rows sharded over
   the ranks against the unsharded step, one dp-sharded step of SMC,
   NUTS and HMC, the pod path with the mode-swap move, the banded route
   with ``dia_kernel`` on and off; then the tp-sharded and unsharded VI
   step rates), and the sharded runs through K2 and K5 (``owed_checks``:
   the 128×128 grid at 2 × 512 chains and ``robot_map(100)`` at 2 ×
   8,192 equal to the pooled rank runs, the ranks' first banded
   proposals from one start differing in every row, ``hybrid_chain``
   fused against its closed forms); the engine comparison
   (``examples/torch_run_engine_comparison.py --model chain --quick``,
   then the ladders, each engine held to the bound of the reference's
   own test on ``hybrid_chain`` at the largest budget it ran); the SMC
   path's banded anchor (``smc_banded_anchor``: the weak 64×64 grid,
   1,024 particles, adaptive, K2 in every move, against a sparse LU);
   the pod-scale example (``--phase pod_scale_example``:
   ``examples/torch_run_pod_scale.py --fast`` at 320 people as two ranks
   under ``torch.distributed.run``, alone on the card, its JSONL checked)
   and the example scripts at their defaults (``--phase examples``, all at
   once, the pod-scale one as one process among them, each against its
   engine's bound; the scripts' launches happen in their own processes
   and are not counted here); and the moments path (``--phase moments``:
   K7 and K8 at the grid cells' shapes, 15,600 latents at 1,024 and
   16,384 chains, against their plain versions and timed); and K2's
   Metropolis select (``--phase k2_select``: at the grid cells' shapes,
   6 steps, 1,024 and 16,384 chains, bitwise against a launch without
   uniforms followed by ``hmc._mh_accept``, and both timed). Each
   is held to exact answers (numpy/scipy oracles, closed forms) or to its
   plain route, and the bench's throughputs are printed (the VI, pod,
   mode-swap, BP, sharded and example rates again on ``[rates]`` lines;
   one phase alone: ``python3 chip_smoke.py --phase NAME``).

The last three lines are the kernels' JSON record (each kernel's error,
times, launches on its path and its bound on this card from this run's
shapes; every kernel also its launch geometry; K1 and K3 their
times at n = 3,246, K3 its Philox route's, K4 its wrapper's times at
the SMC sizes), the card's name and
power limit, and ``{"ok": true, "device":
{...}}``. The script imports nothing of JAX.
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


# H100 SXM datasheet peaks at 700 W (NVIDIA data sheet, SXM part): HBM rate
# and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def kernel_launches(kernel: str) -> int:
    """Launches of kernel ``kernel`` ("k1" … "k8") the port has counted
    since its counters were last reset."""
    from lhvi_tpu_torch.utils.metrics import counters

    return counters()[f"ops.{kernel}.launches"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take for a call: the larger of its
    compulsory bytes (each input read once, each output written once)
    over the HBM rate and its f32 operations over the peak f32 rate.
    No single PyTorch call computes any of K1–K6, so ``library_ms`` is
    null."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


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
        geo = lf.k1_launch(n, C, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        log(f"[K1] {rows}x{rows} grid n={n} C={C} 8 steps: max abs err "
            f"{abs_err:.3e}, max rel err x1 {errs[0]:.3e} p1 {errs[1]:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; geometry {geo}")
        if not ok or max(errs) > tol:
            raise AssertionError(f"K1 disagrees with its plain version at n={n}")
        if rows == 10:  # the main path's shape: 9 products x·J per chain
            record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                          **bound(nbytes(x, p, fg.quad_J, fg.quad_h, im, eps,
                                         *got), 2 * C * n * n * 9),
                          geometry=dict(layout=geo.layout,
                                        chains_per_warp=geo.chains,
                                        threads=32 * geo.warps,
                                        smem_bytes=geo.smem, grid=geo.grid,
                                        j_in_smem=geo.j_smem))
        else:
            record["ms_n3246"], record["plain_ms_n3246"] = ms, plain_ms
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
        """The plain version in latent coordinates: the plain
        dia_quad_leapfrog (embedding by scatter through ``pos``) plus the
        energies."""
        cast = lambda t: t.to(dtype)  # noqa: E731
        x1, p1, lp0, lp1 = dia._plain_dia_quad_leapfrog(
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

    # the folded embedding: the launcher on pre-embedded rows with the
    # identity map, random non-zero positions at the gap lanes, must move
    # no gap lane and give the latent-row call's lanes and log_acc bitwise
    inv = fg.quad_dia_inv
    gap = torch.ones(n_emb, dtype=torch.bool, device=dev)
    gap[pos] = False
    emb = lambda a: dia._embed_gather(a, inv).contiguous()  # noqa: E731
    xg = emb(x)
    xg[:, gap] = torch.randn((C, int(gap.sum())), generator=gen, device=dev)
    kargs = (offs, wdia)
    x1l, ll = dia._cuda_dia_proposal(x, fg.quad_diag, *kargs, fg.quad_h, im,
                                     eps, steps, 99, 0, inv=inv)
    x1g, lg = dia._cuda_dia_proposal(xg, emb(fg.quad_diag), *kargs,
                                     emb(fg.quad_h), emb(im), eps, steps, 99,
                                     0)
    torch.cuda.synchronize()
    gap_moved = int((x1g[:, gap] != xg[:, gap]).sum())
    same_emb = (torch.equal(x1g[:, pos], x1l) and torch.equal(lg, ll))
    log(f"[K2] gap lanes moved: {gap_moved} (of {C * int(gap.sum())}); "
        f"pre-embedded rows equal the latent-row call bitwise: {same_emb}; "
        f"same generator state bitwise equal: {bool(torch.equal(x1a, x1b))}; "
        f"next proposal differs: {not torch.equal(x1a, x1c)}")
    se = 1.0 / N**0.5
    checks = (
        stats["lane_mean_z_max"] < 5.5,          # |z| of 13k lane means
        stats["lane_var_dev_max"] < 6 * (2.0 / C) ** 0.5,
        abs(zm) < 5 * se,
        abs(zv - 1) < 5 * (2.0 / N) ** 0.5,
        abs(kurt - 3) < 5 * (24.0 / N) ** 0.5,
        abs(rho_adj) < 5 * se, abs(rho_step) < 5 * se,
        gap_moved == 0, same_emb, bool(torch.isfinite(lg).all()),
        torch.equal(x1a, x1b), not torch.equal(x1a, x1c),
    )
    if not all(checks):
        raise AssertionError(f"K2 momentum statistics off: {checks}")

    def plain_proposal():
        pp = torch.randn((C, n), generator=gen, device=dev) / torch.sqrt(im)
        return plain(x, pp, torch.float32)[2]

    ms = time_ms(lambda: proposal(x))
    kernel_ms = time_ms(lambda: dia._cuda_dia_proposal(
        x, fg.quad_diag, *kargs, fg.quad_h, im, eps, steps, 99, 0, inv=inv))
    plain_ms = time_ms(plain_proposal)
    K = len(offs)
    geo = dia.dia_launch(n_emb, K)
    log(f"[K2] proposal (momenta + {steps}-step trajectory + energies), latent "
        f"rows in and out: dia_hmc_proposal {ms:.4f} ms (kernel alone "
        f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms; geometry {geo}")
    dia_edge_cases(dev, "K2")
    # the latent rows x in and x1 out, the lane rows (wdia, inv) and the
    # latent diag, h and inv_mass, log_acc; (K + 1) multiply-adds per lane
    # per matvec, steps + 1 matvecs
    return dict(max_abs_err=abs_x, ms=ms, plain_ms=plain_ms,
                **bound(nbytes(x, x1l, wdia, inv, fg.quad_diag, fg.quad_h,
                               im, ll, eps),
                        2 * (K + 1) * C * n_emb * (steps + 1)),
                geometry=geometry(geo))


def geometry(geo) -> dict:
    """A kernel's launch geometry for the kernels line."""
    out = dict(threads=geo.threads, chains_per_block=geo.chains,
               smem_bytes=geo.smem)
    if hasattr(geo, "cluster"):
        out.update(cluster_blocks=geo.cluster, lanes_per_block=geo.slice)
    return out


def banded(dev, n, rows=128):
    """A banded target on n lanes with no embedding (a grid's 4-neighbour
    stencil ``rows`` wide, diagonally dominant, weights off the row 0):
    diag, offsets, wdia, h."""
    import torch

    offs = (-rows, -1, 1, rows)
    i = torch.arange(n, device=dev)
    wdia = torch.stack([((i + o >= 0) & (i + o < n)).float() * -1.0
                        for o in offs]).contiguous()
    g = torch.Generator(dev).manual_seed(n)
    return (torch.full((n,), 4.5, device=dev), offs, wdia,
            torch.randn((n,), generator=g, device=dev))


def dia_edge_cases(dev, which):
    """K2 (exact mode, through ``dia_hmc_proposal``) or K6 (through
    ``dia_quad_leapfrog``) against the plain version in f32 and f64 on
    the cluster layout's edge shapes: a small grid (8 chains in one
    block), a chain count that is not a multiple of the chains per block,
    and DIA_MAX_EMB lanes (clusters of 8 blocks, 4 chains)."""
    import torch

    from lhvi_tpu_torch.ops import dia

    small = k6_grid(dev, 16)
    big = k6_grid(dev)
    cases = (
        ("16x16 grid, 37 chains", (small.quad_diag, small.quad_dia_offsets,
                                   small.quad_dia_w, small.quad_h),
         small.quad_dia_pos, 37),
        ("128x128 grid, 1,021 chains", (big.quad_diag, big.quad_dia_offsets,
                                        big.quad_dia_w, big.quad_h),
         big.quad_dia_pos, 1021),
        (f"{dia.DIA_MAX_EMB} lanes, 5 chains",
         banded(dev, dia.DIA_MAX_EMB), None, 5))
    # phase_k2's and phase_k6's tolerances (energies: K2's log_acc against
    # |lp0| + ke0, K6's lp against max(1, |plain|))
    tol_x, tol_l32, tol_l64 = (1e-4, 1e-5, 1e-7 if which == "K2" else 2e-6)
    for name, (diag, offs, wdia, h), pos, C in cases:
        n = diag.shape[0]
        gen = torch.Generator(dev).manual_seed(C)
        im = 0.5 + torch.rand((n,), generator=gen, device=dev)
        x = 2.0 * torch.randn((C, n), generator=gen, device=dev)
        p = torch.randn((C, n), generator=gen, device=dev) / torch.sqrt(im)
        eps = torch.full((), 0.05, device=dev)
        consts = (diag, offs, wdia, h, im, eps)
        inv = None if pos is None else dia._inv_of(pos, n, wdia.shape[1])
        geo = dia.dia_launch(wdia.shape[1], len(offs))
        errs = []
        for dt in (torch.float32, torch.float64):
            cast = [a.to(dt) if isinstance(a, torch.Tensor) else a
                    for a in (x, p) + consts]
            x1p, p1p, lp0, lp1 = dia._plain_dia_quad_leapfrog(*cast, 6,
                                                             pos=pos)
            if which == "K6":
                got = dia.dia_quad_leapfrog(x, p, *consts, 6, pos=pos)
                errs.append((max(rel_err(got[0], x1p), rel_err(got[1], p1p)),
                             max(rel_err(got[2], lp0), rel_err(got[3], lp1))))
            else:
                im_d = cast[6]
                ke = lambda q: 0.5 * torch.sum(im_d[None] * q * q, -1)  # noqa: E731
                lacc = torch.clamp((lp1 - lp0) + (ke(cast[1]) - ke(p1p)),
                                   max=0.0)
                x1, la = dia.dia_hmc_proposal(None, x, diag, offs, wdia, h, im,
                                              eps, 6, pos=pos, inv=inv, p0=p)
                scale = lp0.abs() + ke(cast[1])
                errs.append((rel_err(x1, x1p), float(
                    ((la.double() - lacc.double()).abs() / scale.double())
                    .max())))
        torch.cuda.synchronize()
        log(f"[{which}] edge case {name}, 6 steps, geometry {tuple(geo)}: x "
            f"max rel err {errs[0][0]:.3e} vs f32, {errs[1][0]:.3e} vs f64; "
            f"energies {errs[0][1]:.3e} vs f32, {errs[1][1]:.3e} vs f64")
        if not (max(errs[0][0], errs[1][0]) <= tol_x
                and errs[0][1] <= tol_l32 and errs[1][1] <= tol_l64):
            raise AssertionError(f"{which} disagrees with its plain version "
                                 f"on {name}")


def k6_grid(dev, rows=128):
    """The 128×128 evidence grid of phase_k2 (or another width) on the
    banded path."""
    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.toy import gaussian_grid

    g, _ = gaussian_grid(rows, rows, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev, quad_max_n=min(4096, rows * rows // 4))
    assert fg.quad_dia_offsets == (-rows, -1, 1, rows), fg.quad_dia_offsets
    return fg


def phase_k6(dev, C=1024):
    """K6 through ``dia_quad_leapfrog`` on latent rows with ``pos``, as a
    caller calls it, against the plain version in f32 and f64."""
    import torch

    from lhvi_tpu_torch.ops import dia

    fg = k6_grid(dev)
    offs, wdia, pos = fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_dia_pos
    n, n_emb, K = fg.n_cont, wdia.shape[1], len(offs)
    gen = torch.Generator(dev).manual_seed(11)
    im = 0.5 + torch.rand((n,), generator=gen, device=dev)
    x = 2.0 * torch.randn((C, n), generator=gen, device=dev)
    p = torch.randn((C, n), generator=gen, device=dev) / torch.sqrt(im)
    eps = torch.full((), 0.05, device=dev)
    consts = (fg.quad_diag, offs, wdia, fg.quad_h, im, eps)
    tol_x, tol_l32, tol_l64 = 1e-4, 1e-5, 2e-6
    log(f"[K6] 128x128 grid: {n} latents, n_emb {n_emb}, offsets {offs}, "
        f"C={C}; tolerances: x1, p1 within {tol_x}*max(1,|plain|) of the "
        f"plain version in f32 and f64 (f32 trajectory, FMA contraction); "
        f"lp0, lp1 within {tol_l32}*max(1,|plain|) of plain f32 (its f32 "
        f"sums over 16k lanes) and {tol_l64}*max(1,|plain|) of plain f64 (the "
        f"kernel sums in double; only its f32 trajectory differs)")

    def cast(a, dt):
        return a.to(dt) if isinstance(a, torch.Tensor) else a

    record = None
    for steps in (1, 8):
        before = kernel_launches("k6")
        got = dia.dia_quad_leapfrog(x, p, *consts, steps, pos=pos)
        if kernel_launches("k6") != before + 1:
            raise AssertionError("dia_quad_leapfrog did not launch K6 once")
        errs = {}
        for dt in (torch.float32, torch.float64):
            want = dia._plain_dia_quad_leapfrog(
                *(cast(a, dt) for a in (x, p) + consts), steps, pos=pos)
            errs[dt] = (max(rel_err(got[0], want[0]), rel_err(got[1], want[1])),
                        max(rel_err(got[2], want[2]), rel_err(got[3], want[3])),
                        max(float((a.double() - b.double()).abs().max())
                            for a, b in zip(got, want)))
        torch.cuda.synchronize()
        ok = all(bool(torch.isfinite(a).all()) for a in got)
        (x32, l32, abs32), (x64, l64, _) = (errs[torch.float32],
                                            errs[torch.float64])
        log(f"[K6] {steps} steps: x1/p1 max rel err {x32:.3e} vs f32, "
            f"{x64:.3e} vs f64; lp0/lp1 max rel err {l32:.3e} vs f32, "
            f"{l64:.3e} vs f64; max abs err vs f32 {abs32:.3e}; mean lp0 "
            f"{float(got[2].mean()):.6g}")
        if not (ok and max(x32, x64) <= tol_x and l32 <= tol_l32
                and l64 <= tol_l64):
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{steps} steps")
        if steps == 8:
            ms = time_ms(lambda: dia.dia_quad_leapfrog(x, p, *consts, 8,
                                                       pos=pos))
            inv = fg.quad_dia_inv
            kernel_ms = time_ms(lambda: dia._cuda_dia_leapfrog(
                x, p, *consts, 8, inv=inv))
            plain_ms = time_ms(lambda: dia._plain_dia_quad_leapfrog(
                x, p, *consts, 8, pos=pos))
            geo = dia.dia_launch(n_emb, K)
            log(f"[K6] 8-step trajectory, latent rows in and out: "
                f"dia_quad_leapfrog {ms:.4f} ms (kernel alone "
                f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms; geometry "
                f"{geo}")
            # the latent rows x, p in and x1, p1 out, the lane rows (wdia,
            # inv) and the latent diag, h and inv_mass, lp0 and lp1;
            # (K + 1) multiply-adds per lane per matvec, 9 matvecs
            record = dict(max_abs_err=abs32, ms=ms, plain_ms=plain_ms,
                          **bound(nbytes(x, p, *got, wdia, inv, fg.quad_diag,
                                         fg.quad_h, im, eps),
                                  2 * (K + 1) * C * n_emb * 9),
                          geometry=geometry(geo))
    dia_edge_cases(dev, "K6")
    return record


def path_dia_leapfrog(dev, C=1024):
    """The K6 path: ``dia_quad_leapfrog`` as a caller drives it, on the
    128×128 grid's latent rows. A forward trajectory and its reversal
    return to the start; the second leg starts where the first ended
    (its lp0 is the first's lp1); zero steps return the inputs."""
    import torch

    from lhvi_tpu_torch.ops import dia

    fg = k6_grid(dev)
    n = fg.n_cont
    gen = torch.Generator(dev).manual_seed(12)
    im = 0.5 + torch.rand((n,), generator=gen, device=dev)
    x = 2.0 * torch.randn((C, n), generator=gen, device=dev)
    p = torch.randn((C, n), generator=gen, device=dev) / torch.sqrt(im)

    def op(xx, pp, steps):
        return dia.dia_quad_leapfrog(
            xx, pp, fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w,
            fg.quad_h, im, 0.05, steps, pos=fg.quad_dia_pos)

    x1, p1, lp0, lp1 = op(x, p, 8)
    x2, p2, lq0, lq1 = op(x1, -p1, 8)
    x0, p0, la, lb = op(x, p, 0)
    torch.cuda.synchronize()
    ke = lambda q: 0.5 * (im[None] * q.double() ** 2).sum(-1)  # noqa: E731
    dh = ((-lp1.double() + ke(p1)) - (-lp0.double() + ke(p))).abs()
    rev = max(rel_err(x2, x), rel_err(-p2, p))
    seam = max(rel_err(lq0, lp1), rel_err(lq1, lp0))
    same = torch.equal(x0, x) and torch.equal(p0, p) and torch.equal(la, lb)
    log(f"[dia_leapfrog] forward and back, 8 steps each, {C} chains: "
        f"max rel err to the start {rev:.3e} (tol 1e-4), lp seam {seam:.3e} "
        f"(tol 1e-5); energy error |dH| mean {float(dh.mean()):.4g}, max "
        f"{float(dh.max()):.4g}; zero steps return the inputs: {same}")
    if not (rev <= 1e-4 and seam <= 1e-5 and same
            and bool(torch.isfinite(dh).all())):
        raise AssertionError("dia_quad_leapfrog path off")


def posterior_draws(J, h, C, gen):
    """C exact draws of N(J⁻¹h, J⁻¹) on the card (f64 Cholesky)."""
    import torch

    Jd = J.double()
    mode = torch.linalg.solve(Jd, h.double())
    L = torch.linalg.cholesky(torch.linalg.inv(Jd))
    z = torch.randn((C, J.shape[0]), generator=gen, device=J.device,
                    dtype=torch.float64)
    return (mode[None] + z @ L.T).float().contiguous()


def phase_k3(dev, cases=((10, 65536, 4), (10, 8192, 8), (64, 1024, 4))):
    """K3 against the lockstep loop on the same momenta and uniforms
    table, at the shapes the main path gives it."""
    import dataclasses

    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import nuts
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.ops import nuts_traj as nt

    tol_q, tol_acc82, min_agree = 1e-4, 2e-5, 0.999
    log(f"[K3] a chain agrees with the plain version when depth, n_leaf and "
        f"divergence are equal and q_prop is within {tol_q}*max(1,|plain|) "
        f"(a flipped multinomial choice moves q_prop by O(1)); >= "
        f"{min_agree:.1%} of chains must agree with the plain version in f32 "
        f"and in f64 (each decision is a threshold test on sums the versions "
        f"take in other orders); on chains agreeing with the f64 run, the "
        f"accept statistic within {tol_acc82}*sqrt(n/82): the kernel forms "
        f"and sums its energies in double, so what remains is its f32 "
        f"trajectory's rounding, a sum over n coordinates")
    record = None
    for rows, C, D in cases:
        g, _ = gaussian_grid(rows, rows, seed=0, evidence_frac=0.2)
        fg = compile_graph(g, dev)
        n = fg.n_cont
        tol_acc = tol_acc82 * max(1.0, (n / 82) ** 0.5)
        gen = torch.Generator(dev).manual_seed(rows + D)
        xc = posterior_draws(fg.quad_J, fg.quad_h, C, gen)
        im = torch.ones(n, device=dev)  # the bench's adapt_mass=False
        eps = torch.full((), 0.12, device=dev)
        U = torch.rand((3, 1 << D, C), generator=gen, device=dev)
        gen.manual_seed(1234)
        p0 = torch.randn((C, n), generator=gen, device=dev)
        kern = nt._cuda_nuts_traj(xc, p0, fg.quad_J, fg.quad_h, im, eps, D,
                                  uniforms=U)
        plain = nuts._nuts_lockstep(fg, None, xc, None, eps, im, D,
                                    uniforms=U, p0=p0)
        fg64 = dataclasses.replace(fg, quad_J=fg.quad_J.double(),
                                   quad_h=fg.quad_h.double(),
                                   quad_c=fg.quad_c.double())
        plain64 = nuts._nuts_lockstep(fg64, None, xc.double(), None,
                                      eps.double(), im.double(), D,
                                      uniforms=U, p0=p0.double())
        # the main path's call: p0 is the generator's first draw
        gen.manual_seed(1234)
        wrap = nt.nuts_trajectory(fg, gen, xc, eps, im, D, uniforms=U)
        torch.cuda.synchronize()

        def acc_of(r):
            return r[1].double() / torch.clamp(r[2], min=1).double()

        def agrees(ref):
            d = (kern[0].double() - ref[0].double()).abs()
            close = (d <= tol_q * torch.clamp(ref[0].double().abs(), min=1.0)
                     ).all(dim=1)
            return (close & (kern[2] == ref[2]) & (kern[3] == ref[3])
                    & (kern[4] == ref[4]))

        agree, agree64 = agrees(plain), agrees(plain64)
        q_abs = float((kern[0] - plain[0]).abs()[agree].max())
        q_rel = rel_err(kern[0][agree], plain[0][agree])
        acc32 = float((acc_of(kern) - acc_of(plain)).abs()[agree].max())
        acc64 = float((acc_of(kern) - acc_of(plain64)).abs()[agree64].max())
        wrap_ok = (torch.equal(wrap[0], kern[0])
                   and torch.equal(wrap[2], kern[3])
                   and torch.equal(wrap[3], kern[4]))
        ms = time_ms(lambda: nt._cuda_nuts_traj(
            xc, p0, fg.quad_J, fg.quad_h, im, eps, D, uniforms=U))
        # the main path's route: in-kernel Philox uniforms, no table
        philox_ms = time_ms(lambda: nt._cuda_nuts_traj(
            xc, p0, fg.quad_J, fg.quad_h, im, eps, D, 12345, 0))
        plain_ms = time_ms(lambda: nuts._nuts_lockstep(
            fg, None, xc, None, eps, im, D, uniforms=U, p0=p0))
        geo = nt.k3_launch(n, D, C, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        log(f"[K3] {rows}x{rows} grid n={n} C={C} max_depth={D}: "
            f"{int((~agree).sum())} chains disagree with plain f32, "
            f"{int((~agree64).sum())} with plain f64; q_prop max abs err "
            f"{q_abs:.3e}, max rel err {q_rel:.3e}; accept stat max err "
            f"{acc32:.3e} vs f32, {acc64:.3e} vs f64; mean depth "
            f"{float(kern[3].float().mean()):.4f} (plain "
            f"{float(plain[3].float().mean()):.4f}), mean leaves "
            f"{float(kern[2].float().mean()):.4f}, divergent "
            f"{int(kern[4].sum())}; wrapper equals launcher: {wrap_ok}; "
            f"kernel {ms:.4f} ms (uniforms table; in-kernel Philox "
            f"{philox_ms:.4f} ms), plain {plain_ms:.4f} ms; geometry {geo}")
        frac = float(agree.float().mean())
        if (frac < min_agree or float(agree64.float().mean()) < min_agree
                or q_rel > tol_q or acc64 > tol_acc or not wrap_ok
                or not torch.isfinite(kern[0]).all()):
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"n={n}, C={C}, max_depth={D}")
        if record is None:  # the first case is the bench's shape
            # this run's work: one product q·J per chain at the start and
            # one per leaf the trees took
            record = dict(max_abs_err=q_abs, ms=ms, plain_ms=plain_ms,
                          ms_philox=philox_ms,
                          **bound(nbytes(xc, p0, fg.quad_J, fg.quad_h, im,
                                         eps, U, *kern),
                                  2 * n * n * (C + int(kern[2].sum()))),
                          geometry=dict(layout=geo.layout,
                                        slots=geo.slots,
                                        threads=32 * geo.warps,
                                        smem_bytes=geo.smem, grid=geo.grid))
        elif n > 256:
            record["ms_n3246"], record["plain_ms_n3246"] = ms, plain_ms

    # in-kernel Philox uniforms through the wrapper
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    xc = posterior_draws(fg.quad_J, fg.quad_h, 8192, gen)
    im = torch.ones(fg.n_cont, device=dev)
    gen.manual_seed(77)
    a = nt.nuts_trajectory(fg, gen, xc, 0.12, im, 4)
    b = nt.nuts_trajectory(fg, gen, xc, 0.12, im, 4)
    gen.manual_seed(77)
    c = nt.nuts_trajectory(fg, gen, xc, 0.12, im, 4)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, c))
    fresh = not torch.equal(a[0], b[0])
    log(f"[K3] in-kernel uniforms: same generator state bitwise equal: "
        f"{same}; next call differs: {fresh}; mean accept stat "
        f"{float(a[1].mean()):.4f}, mean depth {float(a[2].float().mean()):.4f}")
    if not (same and fresh):
        raise AssertionError("K3's in-kernel uniforms do not follow the generator")
    return record


def k4_lw(dev, N, scale=3.0):
    import torch

    gen = torch.Generator(dev).manual_seed(N)
    return scale * torch.randn((N,), generator=gen, device=dev)


def k4_device_ms(lw, out, geo, reps=20):
    """K4's own device time at ``geo`` on given outputs: the median of
    ``reps`` launches under ``torch.profiler``, which leaves out the host's
    share of a call. Raises where the profiler records no launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lhvi_tpu_torch.ops import resample as rs

    rs._k4(lw, *out, geo)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            rs._k4(lw, *out, geo)
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "_kernel" in e.name]
    if not us:
        raise AssertionError(f"the profiler recorded no K4 launch at {geo}")
    return statistics.median(us) / 1e3


def k4_times(dev, N, device=False):
    """K4 at N weights: (the wrapper and the launcher alone on
    preallocated outputs, each a CUDA-event median of single calls as every
    kernel's ``ms``; with ``device``, the kernel's device time,
    ``k4_device_ms``, else None; the geometry). The main run keeps the
    profiler out, so that no path timed after it shares a process with a
    profiler session."""
    import torch

    from lhvi_tpu_torch.ops import resample as rs

    lw = k4_lw(dev, N)
    geo = rs.k4_launch(N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = (torch.empty_like(lw), torch.empty_like(lw),
           torch.empty((2,), device=dev))
    return (time_ms(lambda: rs.weight_pipeline(lw)),
            time_ms(lambda: rs._k4(lw, *out, geo)),
            k4_device_ms(lw, out, geo) if device else None, geo)


def phase_k4(dev, sizes=(7, 1000, 4096, 16384, 65536, 262145, 4194307),
             timed=(1, 4096, 16384, 65536), scales=(3.0, 30.0)):
    import torch

    from lhvi_tpu_torch.ops import resample as rs

    log("[K4] tolerances (tests/test_resample_kernel.py:26-32) against the "
        "plain version in f64: cum 1e-4 absolute; lwn and step_z "
        "1e-5*max(1,|plain|) (at scale 30 |lwn| reaches ~250, where one f32 "
        "ulp is 1.5e-5, so 1e-5 can hold only relatively); ess 1e-5 "
        "relative; |cum[-1] - 1| < 1e-4; two launches bitwise equal")
    record = None
    for N in sizes:
        for scale in scales:
            lw = k4_lw(dev, N, scale)
            lwn, cum, z, ess = rs.weight_pipeline(lw)
            again = rs.weight_pipeline(lw)
            lwn_p, cum_p, z_p, ess_p = rs._torch_weight_pipeline(lw.double())
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       zip((lwn, cum, z, ess), again))
            errs = (rel_err(lwn, lwn_p),
                    float((cum - cum_p).abs().max()),
                    abs(float(z - z_p)) / max(1.0, abs(float(z_p))),
                    abs(float(ess / ess_p) - 1.0), abs(float(cum[-1]) - 1.0))
            abs_err = max(float((lwn - lwn_p).abs().max()), errs[1],
                          abs(float(z - z_p)))
            geo = rs.k4_launch(N, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            log(f"[K4] N={N} scale {scale} ({geo.layout}: cluster "
                f"{geo.cluster}, threads {geo.threads}, per_thread "
                f"{geo.per_thread}, grid {geo.grid}): lwn rel err "
                f"{errs[0]:.3e} (abs {float((lwn - lwn_p).abs().max()):.3e}), "
                f"cum err {errs[1]:.3e}, step_z rel err {errs[2]:.3e}, ess "
                f"rel err {errs[3]:.3e}, |cum[-1]-1| {errs[4]:.3e}, ess "
                f"{float(ess):.6g}; bitwise equal twice: {same}")
            if (errs[0] > 1e-5 or errs[1] > 1e-4 or errs[2] > 1e-5
                    or errs[3] > 1e-5 or errs[4] > 1e-4 or not same):
                raise AssertionError(f"K4 disagrees with its plain version "
                                     f"at N={N}")
            if N == 65536 and scale == scales[0]:
                # the parent-comparable line: the wrapper, single calls
                ms = time_ms(lambda: rs.weight_pipeline(lw))
                plain_ms = time_ms(lambda: rs._torch_weight_pipeline(lw))
                log(f"[K4] N={N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                # about 8 operations per weight: max, exp, sums, scan
                record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                              **bound(nbytes(lw, lwn, cum, z, ess), 8 * N),
                              geometry=dict(layout=geo.layout,
                                            cluster=geo.cluster,
                                            threads=geo.threads,
                                            per_thread=geo.per_thread,
                                            grid=geo.grid))
    for N in timed:
        k4_timed_line(dev, N, record)
    return record


def k4_timed_line(dev, N, record=None, device=False):
    """Log K4's times at N beside its bound (bytes as ``nbytes(lw, lwn,
    cum, z, ess)``); keep them in ``record``."""
    wrapper, alone, device, geo = k4_times(dev, N, device)
    b = bound(12 * N + 8, 8 * N)["bound_ms"]
    log(f"[K4] N={N} ({geo.layout}, cluster {geo.cluster}, threads "
        f"{geo.threads}, per_thread {geo.per_thread}): wrapper {wrapper:.4f} "
        f"ms, launcher alone {alone:.4f} ms, "
        + (f"kernel device time {device:.4f} ms, " if device is not None
           else "") + f"bound {b:.6f} ms")
    if record is not None:
        record[f"ms_n{N}"] = wrapper
    return geo


def queued_ms(fn, reps: int = 20) -> tuple:
    """(device ms, host ms) a call of ``fn()``, ``reps`` calls queued back
    to back behind a sleeping kernel, so the device runs them without a
    gap whatever the host's time a call; the host's is the time it took
    to queue them. Medians of three, after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms: longer than the queuing
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms.append(1e3 * (time.perf_counter() - t0) / reps)
        b.record()
        torch.cuda.synchronize()
        dev_ms.append(a.elapsed_time(b) / reps)
    return statistics.median(dev_ms), statistics.median(host_ms)


def phase_k2_select(dev, smi, chains=(1024, 16384), steps=6, reps=20):
    """K2's Metropolis select at the grid cells' shapes (a 128×128 grid
    with 783 nodes observed, 15,601 latents, as the cells' 15,600; 6
    steps, 1,024 and 16,384 chains) against the
    pair it replaces, a launch without uniforms and then
    ``hmc._mh_accept`` (log, compare, the [C, n] ``torch.where``, exp).
    Checked bitwise, states and log_acc, with the uniforms drawn after
    the momenta as the engine draws them, and with a fifth of the chains
    forced to reject (u = 1; the others u = 0), the cells' accept rate.
    Timed on the latter: each kernel alone (``time_ms``, single calls, as
    PERF.md's K2 times are) and, with calls queued back to back
    (``queued_ms``), the kernel alone, the fused select with the engine's
    ``exp`` and the pair. Returns the times and the bytes the select
    moves: the pair's pass (x1 and xc read, the state written) against
    the fused write-back's re-read of the rejected rows."""
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.ops import dia

    g, _ = gaussian_grid(128, 128, seed=0, evidence_frac=784 / 16384)
    fg = compile_graph(g, dev, quad_max_n=4096)
    n = fg.n_cont
    consts = (fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_h)
    kw = dict(pos=fg.quad_dia_pos, inv=fg.quad_dia_inv)
    rows = []
    for C in chains:
        gen = torch.Generator(dev).manual_seed(C)
        im = 0.5 + torch.rand((n,), generator=gen, device=dev)
        eps = torch.full((), 0.05, device=dev)
        x = 2.0 * torch.randn((C, n), generator=gen, device=dev)
        u = (torch.rand((C,), generator=gen, device=dev) < 0.2).float()
        args = (*consts, im, eps, steps)
        same = []
        for drawn in (True, False):
            gen.manual_seed(3)
            x1, la = dia.dia_hmc_proposal(gen, x, *args, **kw)
            uu = (torch.rand((C,), generator=gen, device=dev) if drawn
                  else u)
            want = hmc._mh_accept(x, x1, la, uu)[0]
            gen.manual_seed(3)
            got, la_s = (dia.dia_hmc_proposal(gen, x, *args, select=True,
                                              **kw) if drawn else
                         dia.dia_hmc_proposal(gen, x, *args, u=u, **kw))
            torch.cuda.synchronize()
            same.append(torch.equal(got, want) and torch.equal(la_s, la))
        if not all(same):
            raise AssertionError(f"K2's select differs from the launch and "
                                 f"_mh_accept at C={C}: {same}")

        def launch(uu=None):
            return dia._cuda_dia_proposal(x, *args, 99, 0,
                                          inv=fg.quad_dia_inv, u=uu)

        def pair():
            x1, la = launch()
            return hmc._mh_accept(x, x1, la, u)

        def fused():
            xs, la = launch(u)
            return xs, torch.exp(la)

        rejected = int((u > 0).sum())
        row = dict(
            C=C, steps=steps, rejected=rejected,
            alone_ms=time_ms(lambda: launch(u), reps),
            alone_unfused_ms=time_ms(launch, reps),
            queued_alone_ms=queued_ms(lambda: launch(u), reps)[0],
            queued_alone_unfused_ms=queued_ms(launch, reps)[0],
            queued_fused_ms=queued_ms(fused, reps)[0],
            queued_pair_ms=queued_ms(pair, reps)[0],
            pass_bytes=3 * 4 * C * n, reread_bytes=4 * rejected * n)
        rows.append(row)
        log(f"[K2 select] 128x128 grid, {n} latents, C={C}, {steps} steps, "
            f"{rejected} "
            f"rejected: K2 alone with the select {row['alone_ms']:.4f} ms, "
            f"without {row['alone_unfused_ms']:.4f} ms (single calls); "
            f"queued: alone {row['queued_alone_ms']:.4f} / "
            f"{row['queued_alone_unfused_ms']:.4f} ms, fused + exp "
            f"{row['queued_fused_ms']:.4f} ms, launch + _mh_accept "
            f"{row['queued_pair_ms']:.4f} ms; bitwise equal (drawn, forced) "
            f"{same}; the pair's pass {row['pass_bytes']} B against "
            f"{row['reread_bytes']} B of rejected rows re-read; on {smi}")
    return rows


def phase_moments(dev, n=15600, chains=(1024, 16384), S=200, reps=20):
    """K7 and K8 at the grid cells' shapes (15,600 latents, 1,024 and
    16,384 chains, 200 draws): each kernel's device ms a call through its
    engine function (``queued_ms``: CUDA events over ``reps`` calls queued
    back to back), the host's ms to queue a call, its bound and its plain
    twin's device ms. K7 at an ordinary draw (t = 50: the
    first pair, the lag-1 product and the batch sum, 10 array passes) and
    at a batch boundary (t = 55: 14 passes), both checked bitwise against
    the twin; K8 (one read of xc) against float64 sums, within two f32
    roundings of |s| + Σ|x| a column, and against its twin, within f32
    summation error. Returns the kernels' records."""
    import torch

    from lhvi_tpu_torch.engines import hmc

    half = S // 2
    bm_len, n_batches = hmc._bm_schedule(S)
    rows = {"stream_diag": [], "moment_sums": []}
    for C in chains:
        g = torch.Generator(dev).manual_seed(C)
        xc = torch.randn((C, n), generator=g, device=dev) + 2.0
        sd = hmc._StreamDiag(*(torch.randn((C, n), generator=g, device=dev)
                               for _ in range(9)))
        elem = C * n * 4
        for t, passes in ((50, 10), (55, 14)):
            args = (sd, t, xc, half, bm_len, n_batches)
            got = hmc._stream_diag_update(*args)
            want = hmc._plain_stream_diag_update(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K7 differs from its twin at C={C}, "
                                     f"t={t}")
            del got, want

            ms, host = queued_ms(lambda: hmc._stream_diag_update(*args),
                                 reps)
            plain_ms, _ = queued_ms(
                lambda: hmc._plain_stream_diag_update(*args), reps)
            rec = dict(C=C, n=n, t=t, ms=ms, host_ms=host, plain_ms=plain_ms,
                       **bound(passes * elem, 8 * C * n))
            log(f"[K7] C={C} n={n} t={t} ({passes} passes, bitwise equal to "
                f"the twin): kernel {ms:.4f} ms, bound {rec['bound_ms']:.4f} "
                f"ms ({ms / rec['bound_ms']:.2f}x), host {host:.4f} ms a "
                f"call, plain {plain_ms:.4f} ms")
            rows["stream_diag"].append(rec)
        s1 = torch.randn((n,), generator=g, device=dev)
        s2 = torch.rand((n,), generator=g, device=dev)
        got = hmc._moment_sums(s1, s2, xc)
        plain = hmc._plain_moment_sums(s1, s2, xc)
        x = xc.double()
        err = 0.0
        for name, s, terms, out, ref in (("s1", s1, x, got[0], plain[0]),
                                         ("s2", s2, x * x, got[1], plain[1])):
            exact = s.double() + terms.sum(0)
            scale = s.double().abs() + terms.abs().sum(0)
            e = (out.double() - exact).abs()
            err = max(err, float(e.max()))
            # two f32 roundings of numbers no larger than scale
            if not bool((e <= 4 * 2.0**-24 * scale).all()):
                raise AssertionError(
                    f"K8 {name} at C={C}: |err| up to "
                    f"{float((e / scale).max()):.3e} of |s| + sum |x|, "
                    f"bound 4 * 2^-24")
            # the twin sums in f32 in ATen's order: no order errs by more
            # than (C - 1) * 2^-24 of the scale, plus the products and the
            # add, so the two lie within 2C * 2^-24 of it of each other
            gap = (out.double() - ref.double()).abs()
            if not bool((gap <= 2 * C * 2.0**-24 * scale).all()):
                raise AssertionError(f"K8 {name} at C={C} differs from its "
                                     f"plain twin beyond f32 summation")
        del x, plain

        ms, host = queued_ms(lambda: hmc._moment_sums(s1, s2, xc), reps)
        plain_ms, _ = queued_ms(lambda: hmc._plain_moment_sums(s1, s2, xc),
                                reps)
        rec = dict(C=C, n=n, ms=ms, host_ms=host, plain_ms=plain_ms,
                   max_abs_err=err, **bound(elem + 16 * n, 3 * C * n))
        log(f"[K8] C={C} n={n}: kernel {ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({ms / rec['bound_ms']:.2f}x), host "
            f"{host:.4f} ms a call, plain {plain_ms:.4f} ms; max |err| "
            f"against float64 {err:.3e} (within 4 * 2^-24 of |s| + sum |x| "
            f"in every column, and within f32 summation of the twin)")
        rows["moment_sums"].append(rec)
        del xc, sd
        torch.cuda.empty_cache()
    return rows


def robot_fg(dev, n_segments=100):
    """bench.py's non-quadratic model: the robot-map HMLN on its
    synthetic scan (``robot_scan_evidence(n, seed=0)``)."""
    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.relational import robot_map, robot_scan_evidence
    from lhvi_tpu_torch.relational.data import load_evidence

    text, _ = robot_scan_evidence(n_segments, seed=0)
    g, index = robot_map(n_segments, evidence=load_evidence(text)).ground()
    return compile_graph(g, dev), index


def denoise_fg(dev, rows=11):
    """A square denoising grid; 11×11 is the largest the reference's 8 MB
    TPU footprint gate admits (K5's own plan takes larger ones)."""
    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.image import denoise_grid

    return compile_graph(denoise_grid(rows, rows, seed=0)[0], dev)


def long_tape_fg(dev):
    """A 127-node tape (the tracer holds at most 128): an MLN formula of
    18 squared products on the four edges of a 4-cycle, two colours."""
    import lhvi_tpu_torch as lt
    from lhvi_tpu_torch.potentials import MLNPotential

    dom = lt.Domain([-2.0, 2.0], continuous=True)
    xs = [lt.RV(dom, name=f"x{i}") for i in range(4)]
    return lt.compile_graph(lt.Graph(xs, [lt.F(MLNPotential(
        lambda a: -sum(((a[0] - 0.1 * k) * (a[1] + 0.05 * k)) ** 2
                       for k in range(18)) / 50.0 - 0.01 * a[0],
        w=0.7, formula_name="long"), [xs[i], xs[(i + 1) % 4]])
        for i in range(4)]), dev)


def phase_k5(dev, C_robot=16384, C_denoise=4096):
    """K5 against both plain versions (autograd over
    ``log_prob_cont_batched``, and the tape twin ``tape_energy_grad``) on
    the same inputs and momenta, at the shapes the main path gives it,
    on a grid past the reference's gate and on the pod graph's continuous
    part (``fast_compile`` of friends_smokers(320): 320 stress latents,
    128 chains, 8 steps; ``pod320`` itself runs unfused, as bench.py
    does), all through ``plan="auto"``."""
    import torch

    from lhvi_tpu_torch.ops import logpot
    from lhvi_tpu_torch.relational.fast import fast_compile

    tol_x, tol_e = 1e-4, 2e-4
    log(f"[K5] tolerances (tests/test_logpot_kernel.py:71-78's bound): x1, p1 "
        f"within {tol_x}*max(1,|plain|); E0, E1 within {tol_e}*max(1,|plain|) "
        f"(f32 trajectories; the kernel sums energies in double, the plain "
        f"versions in f32 (autograd) and double (tape))")
    fg_r, _ = robot_fg(dev)
    fg_d = denoise_fg(dev)
    fg_d16 = denoise_fg(dev, 16)
    if logpot.logpot_plan(fg_d16) is not None:
        raise AssertionError("denoise16x16 is expected past the reference's "
                             "gate")
    cases = (("robot100", fg_r, C_robot, 8, 0.05, None),
             ("robot100 tempered", fg_r, C_robot, 8, 0.05, 0.3),
             ("denoise11x11", fg_d, C_denoise, 5, 0.03, None),
             ("denoise16x16 (past the reference's gate)", fg_d16, C_denoise,
              5, 0.03, None),
             ("robot100 at 4,099 chains (3 in the last block)", fg_r, 4099,
              8, 0.05, None),
             ("127-node tape", long_tape_fg(dev), 4099, 5, 0.04, None),
             ("pod320's continuous part (320 stress latents)",
              fast_compile(friends_model(320, 32), dev), 128, 8, 0.1, None))
    record = None
    for name, fg, C, steps, eps, beta in cases:
        plan = logpot.logpot_plan_cached(fg)  # what plan="auto" runs
        if plan is None:
            raise AssertionError(f"{name}: no fused-kernel plan")
        n = fg.n_cont
        gen = torch.Generator(dev).manual_seed(C + steps)
        lo, hi = fg.cont_lo, fg.cont_hi
        x = lo + (hi - lo) * torch.rand((C, n), generator=gen, device=dev)
        p = torch.randn((C, n), generator=gen, device=dev)
        sizes = torch.as_tensor(fg.meta.np_global["disc_sizes"], device=dev)
        xd = (torch.rand((C, fg.n_disc), generator=gen, device=dev)
              * sizes[None]).long()
        im = 0.5 + torch.rand((n,), generator=gen, device=dev)
        kw = {}
        if beta is not None:  # the SMC move's base measure
            kw = dict(beta=torch.full((), beta, device=dev),
                      base_mid=0.5 * (lo + hi),
                      base_inv_s2=torch.full((n,), 1.0 / 2.0**2, device=dev))
        args = (fg, x, p, xd, im, torch.full((), eps, device=dev), steps)
        before = kernel_launches("k5")
        got = logpot.logpot_leapfrog(*args, plan="auto", **kw)
        if kernel_launches("k5") != before + 1:
            raise AssertionError(f"{name}: plan='auto' did not launch K5")
        plains = {"autograd": logpot.logpot_leapfrog(*args, plan=None, **kw),
                  "tape": logpot.tape_logpot_leapfrog(*args, plan=plan, **kw)}
        torch.cuda.synchronize()
        ok = all(bool(torch.isfinite(a).all()) for a in got)
        msg, abs_err = [], 0.0
        for pname, want in plains.items():
            ex = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
            ee = max(rel_err(got[2], want[2]), rel_err(got[3], want[3]))
            abs_err = max([abs_err] + [float((a - b).abs().max())
                                       for a, b in zip(got, want)])
            msg.append(f"vs {pname}: x1/p1 rel err {ex:.3e}, E0/E1 rel err "
                       f"{ee:.3e}")
            ok = ok and ex <= tol_x and ee <= tol_e
        ms = time_ms(lambda: logpot.logpot_leapfrog(*args, plan=plan, **kw))
        dv = plan.disc_values(xd)
        use_base, b_, mid, is2 = logpot._tempering(
            fg, dev, kw.get("beta"), kw.get("base_mid"), kw.get("base_inv_s2"))
        kern_ms = time_ms(lambda: logpot._cuda_logpot_leapfrog(
            plan, x, p, dv, im, args[5], b_, mid, is2, steps, use_base))
        auto_ms = time_ms(lambda: logpot.logpot_leapfrog(*args, plan=None,
                                                         **kw))
        tape_ms = time_ms(lambda: logpot.tape_logpot_leapfrog(*args, plan=plan,
                                                              **kw))
        geo = logpot.k5_launch(plan, C)
        log(f"[K5] {name}: n={n} C={C} {steps} steps, {plan.n_rows} factor "
            f"rows ({plan.n_active} with a latent slot, {plan.n_colors} "
            f"colours), tapes {[len(b.tape) for b in plan.buckets]} nodes, "
            f"geometry {geo}; " + "; ".join(msg)
            + f"; max abs err {abs_err:.3e}; logpot_leapfrog {ms:.4f} ms "
            f"(kernel alone {kern_ms:.4f} ms), plain autograd {auto_ms:.4f} "
            f"ms, plain tape {tape_ms:.4f} ms")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain versions on "
                                 f"{name}")
        if record is None:  # the robot path's shape
            record = dict(max_abs_err=abs_err, ms=ms, plain_ms=auto_ms,
                          **bound(nbytes(x, p, dv, im, args[5], *got),
                                  k5_flops(plan, C, steps)),
                          geometry=geometry(geo))
    return record


def k5_flops(plan, C, steps):
    """K5's operations for one call: per gradient evaluation (steps + 1 of
    them) each active row's tape forward (one operation a node) and in
    reverse (two), plus 2n² for the quadratic form; evidence-only rows'
    tapes forward once."""
    per_eval = once = 0
    for bp in plan.buckets:
        active = int((bp.rows < plan.n_active).sum())
        per_eval += 3 * len(bp.tape) * active
        once += len(bp.tape) * (bp.rows.numel() - active)
    quad = 2 * plan.n_cont ** 2 if plan.has_quad else 0
    return C * ((steps + 1) * (per_eval + quad) + once)


def chain_spread(s_xc, s_xd, n_vals):
    """Per-chain means of a samples-mode run → (mean, standard error) of
    the continuous means [n_cont] and of the discrete marginals [n_disc,
    n_vals], treating the chains as independent replicas."""
    import torch

    per = [s_xc.double().mean(0)]  # [C, n_cont]
    per.append(torch.stack([(s_xd == v).double().mean(0)
                            for v in range(n_vals)], -1))  # [C, n_disc, V]
    C = s_xc.shape[1]
    return [(a.mean(0), a.std(0) / C**0.5) for a in per]


def phase_robot(dev, smi, keep, C=16384, S=50, C_exact=65536, N_smc=16384):
    """The non-quadratic HMC-within-Gibbs path: bench.py's robot-map run
    fused (K5 on every proposal) and unfused, their agreement, the small
    instance against exact enumeration, hybrid_chain's closed forms and
    an SMC run through K5. ``keep["robot_hmc"]`` receives the fused run's
    per-chain spread, which the NUTS-within-Gibbs path is held to."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, smc
    from lhvi_tpu_torch.models.relational import robot_map, robot_scan_evidence
    from lhvi_tpu_torch.models.toy import hybrid_chain
    from lhvi_tpu_torch.relational.data import load_evidence
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    fg, _ = robot_fg(dev)
    log(f"[robot] robot_map(100): {fg.n_cont} continuous, {fg.n_disc} "
        f"discrete latents, {fg.n_colors} Gibbs colors")
    rates = {}
    for fused in (True, False):
        cfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.05,
                            fused_logpot=fused)
        before = kernel_launches("k5")
        rate, spread = run_and_time(hmc, fg, cfg, dev, C, S)
        k5 = kernel_launches("k5") - before
        name = "fused" if fused else "unfused"
        log(f"[robot] {name} (fused_logpot={fused}): {rate:.6g} "
            f"chain-samples/s (rep spread {spread:.3f}), {C} chains x {S} "
            f"samples, K5 launches {k5}, on {smi}")
        # a warm run and three timed ones, one K5 launch per proposal
        if k5 != (4 * S if fused else 0):
            raise AssertionError(f"robot {name}: {k5} K5 launches")
        rates[name] = rate

    # fused against unfused: independent chains, the spread across them
    W, SS = 200, 100
    stats = {}
    for fused in (True, False):
        cfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.05,
                            fused_logpot=fused)
        s_xc, s_xd, diag = hmc.run_hmc(
            fg, torch.Generator(dev).manual_seed(5 + fused), cfg, n_chains=C,
            n_warmup=W, n_samples=SS)
        stats[fused] = chain_spread(s_xc, s_xd, fg.max_v)
        log(f"[robot] fused_logpot={fused}: accept "
            f"{float(diag['accept_rate']):.4f}, step "
            f"{float(diag['step_size']):.4g}")
        del s_xc, s_xd
    worst = largest_z(stats[True], stats[False], C * SS)
    log(f"[robot] fused vs unfused ({C} chains, {W} warmup + {SS} samples): "
        f"largest difference {worst:.3f} standard errors over the "
        f"{fg.n_cont} depth means and {fg.n_disc}x{fg.max_v} type marginals")
    if worst > 5.0:
        raise AssertionError("robot: fused and unfused runs disagree")
    keep["robot_hmc"] = (stats[True], C * SS)

    # the small instance against exact enumeration (tests/test_robot_map.py)
    text, _ = robot_scan_evidence(5, seed=2, depth_miss_every=2,
                                  n_type_labels=1)
    g, index = robot_map(5, evidence=load_evidence(text)).ground()
    exact = ExactPosterior(g, cont_grid=81)
    fgs = compile_graph(g, dev)
    before = kernel_launches("k5")
    res = hmc.sample(fgs, torch.Generator(dev).manual_seed(0),
                     cfg=hmc.HMCConfig(n_leapfrog=8, init_step_size=0.2,
                                       gibbs_sweeps=2, fused_logpot=True),
                     n_chains=C_exact, n_warmup=300, n_samples=600,
                     collect="moments")
    k5 = kernel_launches("k5") - before
    errs = [0.0, 0.0, 0.0]
    for i in range(5):
        rv_t = index[("type", (f"s{i}",))]
        if not rv_t.observed:
            errs[0] = max(errs[0], float(np.abs(
                res.disc_marginal(rv_t) - exact.disc_marginal(rv_t)).max()))
        rv_d = index[("depth", (f"s{i}",))]
        if not rv_d.observed:
            errs[1] = max(errs[1], abs(res.mean(rv_d) - exact.mean(rv_d)))
            errs[2] = max(errs[2], abs(res.var(rv_d) - exact.var(rv_d)))
    log(f"[robot] small instance, {C_exact} chains, fused_logpot=True (K5 "
        f"launches {k5}): type marginal err {errs[0]:.4f} (< 0.06), depth "
        f"mean err {errs[1]:.4f} (< 0.08), var err {errs[2]:.4f} (< 0.1); "
        f"rhat_disc max {float(np.max(res.diag['rhat_disc'])):.4f}")
    if not (k5 > 0 and errs[0] < 0.06 and errs[1] < 0.08 and errs[2] < 0.1):
        raise AssertionError("robot small instance off the exact posterior")

    # hybrid_chain's closed forms: P(d) = (0.3, 0.7), E[x1] = 1/3,
    # E[x2] = 4/15 (the switch's normalization is d-independent)
    g, (d, x1, x2) = hybrid_chain()
    fgh = compile_graph(g, dev)
    before = kernel_launches("k5")
    res = hmc.sample(fgh, torch.Generator(dev).manual_seed(1),
                     cfg=hmc.HMCConfig(init_step_size=0.2, fused_logpot=True),
                     n_chains=C, n_warmup=300, n_samples=400,
                     collect="moments")
    k5 = kernel_launches("k5") - before
    pd = res.disc_marginal(d)
    got = (float(pd[1]), res.mean(x1), res.mean(x2))
    log(f"[robot] hybrid_chain, {C} chains, fused_logpot=True (K5 launches "
        f"{k5}): P(d=1) {got[0]:.4f} (0.7), E[x1] {got[1]:.4f} (0.3333), "
        f"E[x2] {got[2]:.4f} (0.2667)")
    if not (k5 > 0 and abs(got[0] - 0.7) < 0.01 and abs(got[1] - 1 / 3) < 0.02
            and abs(got[2] - 4 / 15) < 0.02):
        raise AssertionError("hybrid_chain off its closed forms")

    # SMC on the denoising grid through K5 against the autograd move (the
    # adaptive schedule: a fixed one of 50 temperatures leaves log Z off by
    # hundreds on this sharp posterior)
    fgd = denoise_fg(dev)
    lz = {}
    for fused in (True, False):
        before = kernel_launches("k5")
        before_k4 = kernel_launches("k4")
        cfg = smc.SMCConfig(n_particles=N_smc, n_temps=400, adaptive=True,
                            fused_logpot=fused)
        t0 = time.perf_counter()
        runs = [smc.sample(fgd, torch.Generator(dev).manual_seed(s), cfg)
                for s in range(4)]
        dt = time.perf_counter() - t0
        lz[fused] = [r.log_z for r in runs]
        temps = [int(r.diag["n_temps_used"]) for r in runs]
        k5 = kernel_launches("k5") - before
        k4 = kernel_launches("k4") - before_k4
        log(f"[robot] smc denoise 11x11 (adaptive), {N_smc} particles, "
            f"fused_logpot={fused}: log Z {[round(v, 4) for v in lz[fused]]}, "
            f"temperatures {temps}, {N_smc * sum(temps) / dt:.6g} particle-"
            f"temperature-steps/s, K5 launches {k5}, K4 launches {k4}")
        if (k5 > 0) != fused:
            raise AssertionError(f"smc fused_logpot={fused}: {k5} K5 launches")
    mf, mu = np.mean(lz[True]), np.mean(lz[False])
    se = np.sqrt((np.var(lz[True], ddof=1) + np.var(lz[False], ddof=1)) / 4)
    paired = max(abs(a - b) for a, b in zip(lz[True], lz[False]))
    log(f"[robot] smc log Z fused {mf:.4f} vs unfused {mu:.4f}: difference "
        f"{abs(mf - mu):.4f}, 5 standard errors {5 * se:.4f}; largest "
        f"difference on one seed {paired:.4f}")
    if not abs(mf - mu) <= 5 * se + 1e-3:
        raise AssertionError("smc: fused and unfused log Z disagree")
    return rates


def largest_z(a, b, n_draws):
    """The largest |difference| in standard errors between two runs'
    ``chain_spread`` summaries (floored at one draw's weight, so that a
    value both runs never visit compares as equal)."""
    import torch

    worst = 0.0
    for (ma, sa), (mb, sb) in zip(a, b):
        z = (ma - mb).abs() / torch.clamp((sa**2 + sb**2).sqrt(),
                                          min=1.0 / n_draws)
        worst = max(worst, float(z.max()))
    return worst


def phase_hybrid(dev, smi, robot_hmc, C=16384, S=20, C_small=4096,
                 N_smc=4096):
    """NUTS-within-Gibbs (the lockstep loop on the autograd gradient, the
    planned Gibbs sweep before each transition) against exact answers and
    the fused HMC robot run, bench.py's NUTS robot rate, and SMC with
    tempered Gibbs on hybrid_chain."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import nuts, smc
    from lhvi_tpu_torch.models.relational import robot_map, robot_scan_evidence
    from lhvi_tpu_torch.models.toy import hybrid_chain
    from lhvi_tpu_torch.relational.data import load_evidence
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    # hybrid_chain against exact enumeration (tests/test_nuts_map.py:32-41)
    g, (d, x1, x2) = hybrid_chain()
    exact_h = exact = ExactPosterior(g, cont_grid=161)
    fgh = compile_graph(g, dev)
    t0 = time.perf_counter()
    res = nuts.sample(fgh, torch.Generator(dev).manual_seed(3),
                      n_chains=C_small, n_warmup=300, n_samples=400,
                      collect="moments")
    errs = (abs(res.mean(x1) - exact.mean(x1)), abs(res.mean(x2)
                                                    - exact.mean(x2)),
            float(np.abs(res.disc_marginal(d) - exact.disc_marginal(d)).max()))
    log(f"[hybrid] nuts hybrid_chain, {C_small} chains, 300 + 400: E[x1] err "
        f"{errs[0]:.4f}, E[x2] err {errs[1]:.4f} (< 0.1), P(d) err "
        f"{errs[2]:.4f} (< 0.06); mean depth "
        f"{float(res.diag['mean_depth']):.4f}, divergence rate "
        f"{float(res.diag['divergence_rate']):.3e}, rhat_disc "
        f"{float(res.diag['rhat_disc'].max()):.4f}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (errs[0] < 0.1 and errs[1] < 0.1 and errs[2] < 0.06):
        raise AssertionError("NUTS on hybrid_chain off the exact posterior")

    # the small robot instance (tests/test_robot_map.py:46-55's thresholds)
    text, _ = robot_scan_evidence(5, seed=2, depth_miss_every=2,
                                  n_type_labels=1)
    g, index = robot_map(5, evidence=load_evidence(text)).ground()
    exact = ExactPosterior(g, cont_grid=81)
    t0 = time.perf_counter()
    res = nuts.sample(compile_graph(g, dev), torch.Generator(dev).manual_seed(4),
                      cfg=nuts.NUTSConfig(max_depth=5, init_step_size=0.2,
                                          gibbs_sweeps=2),
                      n_chains=C_small, n_warmup=200, n_samples=300,
                      collect="moments")
    errs = [0.0, 0.0, 0.0]
    for i in range(5):
        rv_t = index[("type", (f"s{i}",))]
        if not rv_t.observed:
            errs[0] = max(errs[0], float(np.abs(
                res.disc_marginal(rv_t) - exact.disc_marginal(rv_t)).max()))
        rv_d = index[("depth", (f"s{i}",))]
        if not rv_d.observed:
            errs[1] = max(errs[1], abs(res.mean(rv_d) - exact.mean(rv_d)))
            errs[2] = max(errs[2], abs(res.var(rv_d) - exact.var(rv_d)))
    log(f"[hybrid] nuts small robot instance, {C_small} chains, max_depth 5, "
        f"200 + 300: type marginal "
        f"err {errs[0]:.4f} (< 0.06), depth mean err {errs[1]:.4f} (< 0.08), "
        f"var err {errs[2]:.4f} (< 0.1); rhat_disc max "
        f"{float(np.max(res.diag['rhat_disc'])):.4f}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (errs[0] < 0.06 and errs[1] < 0.08 and errs[2] < 0.1):
        raise AssertionError("NUTS on the small robot instance off the exact "
                             "posterior")

    # robot_map(100) at bench.py's settings (bench.py:286-313)
    fg, _ = robot_fg(dev)
    bcfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.05, adapt_mass=False)

    def run(seed):
        m, _, _ = nuts.run_nuts(fg, torch.Generator(dev).manual_seed(seed),
                                bcfg, n_chains=C, n_warmup=0, n_samples=S,
                                collect="moments", stream_diag=False)
        float(m["mean"][0])

    dt, spread = timed_runs(run)
    log(f"[hybrid] nuts robot100: {C * S / dt:.6g} chain-samples/s (rep "
        f"spread {spread:.3f}), {C} chains x {S} samples, on {smi}")
    # against the fused HMC run of the robot path: independent chains
    stats_hmc, n_hmc = robot_hmc
    W, SS = 200, 100
    s_xc, s_xd, diag = nuts.run_nuts(fg, torch.Generator(dev).manual_seed(6),
                                     bcfg, n_chains=C, n_warmup=W,
                                     n_samples=SS)
    worst = largest_z(chain_spread(s_xc, s_xd, fg.max_v), stats_hmc,
                      min(C * SS, n_hmc))
    log(f"[hybrid] nuts robot100 ({W} warmup + {SS} samples) vs fused HMC: "
        f"largest difference {worst:.3f} standard errors over the "
        f"{fg.n_cont} depth means and {fg.n_disc}x{fg.max_v} type marginals; "
        f"accept {float(diag['accept_rate']):.4f}, mean depth "
        f"{float(diag['mean_depth']):.4f}, step "
        f"{float(diag['step_size']):.4g}")
    if worst > 5.0:
        raise AssertionError("NUTS and HMC disagree on robot_map(100)")
    del s_xc, s_xd

    # SMC with tempered Gibbs on hybrid_chain (tests/test_smc.py:68-77)
    exact = exact_h
    assert fgh.color_plan is not None  # the planned tempered sweep
    t0 = time.perf_counter()
    before = kernel_launches("k4")
    res = smc.sample(fgh, torch.Generator(dev).manual_seed(5),
                     smc.SMCConfig(n_particles=N_smc, n_temps=40, n_moves=2))
    k4 = kernel_launches("k4") - before
    errs = (abs(res.mean(x1) - exact.mean(x1)),
            float(np.abs(res.disc_marginal(d) - exact.disc_marginal(d)).max()),
            abs(res.log_z - exact.log_z))
    log(f"[hybrid] smc hybrid_chain, {N_smc} particles, 40 temperatures: "
        f"E[x1] err {errs[0]:.4f} (< 0.1), P(d) err {errs[1]:.4f} (< 0.06), "
        f"log Z {res.log_z:.4f} (exact {exact.log_z:.4f}, err "
        f"{errs[2]:.4f}); K4 launches {k4}; {time.perf_counter() - t0:.1f} s")
    if not (errs[0] < 0.1 and errs[1] < 0.06):
        raise AssertionError("SMC on hybrid_chain off the exact posterior")


def timed_runs(run, reps=3):
    """Median host-clock seconds of ``run(seed)`` over ``reps`` runs after a
    warm run, each ending in a device read (bench.py's method)."""
    import torch

    run(100)
    times = []
    for rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(101 + rep)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return dt, (max(times) - min(times)) / dt


def phase_nuts(dev, smi, C=65536):
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import nuts
    from lhvi_tpu_torch.models.toy import gaussian_grid

    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    mean_x, var_x = np.linalg.solve(J, h), np.diag(np.linalg.inv(J))
    cfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.12)
    moments, _, diag = nuts.run_nuts(
        fg, torch.Generator(dev).manual_seed(0), cfg, n_chains=C,
        n_warmup=200, n_samples=200, collect="moments")
    div = float(diag["divergence_rate"])
    log(f"[nuts] 10x10 grid, {C} chains: mean depth "
        f"{float(diag['mean_depth']):.4f}, divergence rate {div:.3e}")
    check_moments("nuts 10x10", moments, diag, mean_x, np.arange(fg.n_cont),
                  var_x)
    if not div < 0.01:
        raise AssertionError(f"NUTS divergence rate {div}")
    # bench.py:173-191
    bcfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.12, adapt_mass=False)
    S = 50

    def run(seed):
        m, _, _ = nuts.run_nuts(fg, torch.Generator(dev).manual_seed(seed),
                                bcfg, n_chains=C, n_warmup=0, n_samples=S,
                                collect="moments", stream_diag=False)
        float(m["mean"][0])

    dt, spread = timed_runs(run)
    rate = C * S / dt
    log(f"[nuts] throughput: {rate:.6g} chain-samples/s (rep spread "
        f"{spread:.3f}) on {smi}")
    return rate


def exact_gaussian(fg):
    """(log Z, mean, var) of a pure-Gaussian compiled graph from the port's
    own information form: ½hᵀJ⁻¹h + ½(n log 2π − log|J|) + c."""
    import math

    import numpy as np

    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    sign, logdet = np.linalg.slogdet(J)
    assert sign > 0
    mean = np.linalg.solve(J, h)
    log_z = (0.5 * h @ mean + 0.5 * (J.shape[0] * math.log(2 * math.pi)
                                     - logdet) + float(fg.quad_c))
    return log_z, mean, np.diag(np.linalg.inv(J))


def weak_grid(rows, cols, seed=0, csig=16.0, evidence_frac=0.1):
    """``tests/test_ell_oracle.py:97-119``'s weakly coupled evidence grid,
    the reference's SMC-at-scale target, built with the port's DSL from
    the same numpy stream (so one seed gives one graph in both)."""
    import numpy as np

    from lhvi_tpu_torch import Domain, F, Graph, RV
    from lhvi_tpu_torch.potentials import (GaussianPotential,
                                           LinearGaussianPotential)

    rng = np.random.default_rng(seed)
    dom = Domain([-30, 30], continuous=True)
    rvs = [[RV(dom, name=f"x{r}_{c}") for c in range(cols)]
           for r in range(rows)]
    fs = []
    for r in range(rows):
        for c in range(cols):
            mu = float(rng.normal(0.0, 1.0))
            fs.append(F(GaussianPotential([mu], [[1.0]]), [rvs[r][c]]))
            if rng.uniform() < evidence_frac:
                rvs[r][c].value = float(rng.normal(mu, 1.0))
            if c + 1 < cols:
                fs.append(F(LinearGaussianPotential(coeff=1.0, sig=csig),
                            [rvs[r][c], rvs[r][c + 1]]))
            if r + 1 < rows:
                fs.append(F(LinearGaussianPotential(coeff=1.0, sig=csig),
                            [rvs[r][c], rvs[r + 1][c]]))
    return Graph([rv for row in rvs for rv in row], fs)


def sparse_lu_means(g, fg):
    """Exact posterior means of ``g``'s latents, in ``fg``'s latent order,
    from a sparse LU of the O(E) information form
    (``engines/gabp.py::sparse_information_form``, scipy):
    ``tests/test_ell_oracle.py:28-41``'s oracle."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from lhvi_tpu_torch.engines.gabp import sparse_information_form

    Jd, h, off, latents = sparse_information_form(g)
    n = len(latents)
    items = list(off.items())
    rows = np.array([k[0] for k, _ in items] + list(range(n)))
    cols = np.array([k[1] for k, _ in items] + list(range(n)))
    vals = np.array([v for _, v in items] + list(Jd))
    mean = spla.splu(sp.csc_matrix((vals, (rows, cols)), shape=(n, n))).solve(
        np.asarray(h, np.float64))
    out = np.empty(n)
    out[[fg.meta.loc(rv)[1] for rv in latents]] = mean
    return out


def smc_banded_anchor(dev, smi, rows=64, N=1024, quad_max_n=1024):
    """``tests/test_ell_oracle.py:122-150`` on the card: adaptive SMC on the
    weak ``rows``×``rows`` grid (3,645 latents at 64), ``quad_max_n=1024``
    so the banded move (K2 inside ``smc.move_quad_sparse``, K4 each
    temperature) carries it, against the sparse LU: weighted means within
    0.08 on average and 0.30 at worst, log Z finite."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import smc

    g = weak_grid(rows, rows)
    fg = compile_graph(g, dev, quad_max_n=quad_max_n)
    assert fg.quad_sparse and fg.quad_dia_offsets is not None
    mean_exact = sparse_lu_means(g, fg)
    cfg = smc.SMCConfig(n_particles=N, n_temps=20, n_moves=2, n_leapfrog=10,
                        step_size=0.12, base_scale=1.5, adaptive=True)
    k2, k4 = kernel_launches("k2"), kernel_launches("k4")
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    xc, _, log_w, log_z, diag = smc.run_smc(
        fg, torch.Generator(dev).manual_seed(4), cfg)
    w = torch.softmax(log_w.double(), 0)
    mean = (w[:, None] * xc.double()).sum(0).cpu().numpy()
    dt = time.perf_counter() - t0
    k2 = kernel_launches("k2") - k2
    k4 = kernel_launches("k4") - k4
    used = int(diag["n_temps_used"])
    err = np.abs(mean - mean_exact)
    rate = N * used / dt
    log(f"[smc] banded anchor: weak {rows}x{rows} grid ({fg.n_cont} latents), "
        f"{N} particles, adaptive, {used} temperatures (K2 launches {k2}, K4 "
        f"launches {k4}): mean err mean {err.mean():.4f} (< 0.08) max "
        f"{err.max():.4f} (< 0.30) against the sparse LU, log Z "
        f"{float(log_z):.4f}, mean accept "
        f"{float(diag['accept'][:used].mean()):.4f}; {rate:.6g} "
        f"particle-temperatures/s ({dt:.2f} s) on {smi}")
    if not (err.mean() < 0.08 and err.max() < 0.30
            and np.isfinite(float(log_z))
            and (k2 > 0) == (torch.device(dev).type == "cuda")):
        raise AssertionError("banded SMC off the sparse LU oracle")
    return rate


def phase_smc(dev, smi, N=65536):
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import smc
    from lhvi_tpu_torch.models.lds import kalman_lds
    from lhvi_tpu_torch.models.toy import gaussian_grid

    g, xs, _ = kalman_lds(T=20, seed=0)
    fg = compile_graph(g, dev)
    log_z, mean, var = exact_gaussian(fg)
    idx = [fg.meta.loc(rv)[1] for rv in xs]
    for adaptive in (False, True):
        cfg = smc.SMCConfig(n_particles=N, n_temps=50, n_moves=2,
                            adaptive=adaptive)
        before = kernel_launches("k4")
        t0 = time.perf_counter()
        res = smc.sample(fg, torch.Generator(dev).manual_seed(0), cfg)
        dt = time.perf_counter() - t0
        k4 = kernel_launches("k4") - before
        errs = np.array([abs(res.mean(rv) - mean[i]) for rv, i in
                         zip(xs, idx)])
        vrel = np.array([abs(res.var(rv) - var[i]) / var[i] for rv, i in
                         zip(xs, idx)])
        lz_err = abs(res.log_z - log_z)
        name = "adaptive" if adaptive else "fixed"
        log(f"[smc] kalman_lds(T=20) {name} schedule, {N} particles: log Z "
            f"{res.log_z:.5f} (exact {log_z:.5f}, err {lz_err:.4f}), "
            f"temperatures {int(res.diag['n_temps_used'])} (K4 launches "
            f"{k4}), mean accept "
            f"{float(res.diag['accept'].mean()):.4f}, mean err mean "
            f"{errs.mean():.4f} max {errs.max():.4f}, var rel err mean "
            f"{vrel.mean():.4f}; {dt:.2f} s")
        if not (lz_err < 0.1 and errs.mean() < 0.1 and errs.max() < 0.3
                and vrel.mean() < 0.3):
            raise AssertionError(f"SMC ({name}) off the exact Kalman answer")
    # bench.py:194-212
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    log_z, _, _ = exact_gaussian(fg)
    cfg = smc.SMCConfig(n_particles=N, n_temps=50)
    lz = []

    def run(seed):
        out = smc.run_smc(fg, torch.Generator(dev).manual_seed(seed), cfg)
        lz.append(float(out[3]))

    before = kernel_launches("k4")
    dt, spread = timed_runs(run)
    k4 = (kernel_launches("k4") - before) / (4 * cfg.n_temps)
    rate = N * cfg.n_temps / dt
    log(f"[smc] throughput (10x10 grid): {rate:.6g} particle-temperature-"
        f"steps/s (rep spread {spread:.3f}; K4 launches a temperature "
        f"{k4:.4g}) on {smi}; log Z "
        f"{lz[-1]:.4f} against the closed form {log_z:.4f} (err "
        f"{abs(lz[-1] - log_z):.4f})")
    return rate, smc_banded_anchor(dev, smi)


def run_and_time(hmc, fg, cfg, dev, n_chains, n_samples):
    """Bench-style throughput: a sampling-only moments run (no warmup, no
    streamed diagnostics) → (chain-samples/s, rep spread)."""
    import torch

    def run(seed):
        gen = torch.Generator(dev).manual_seed(seed)
        moments, _, _ = hmc.run_hmc(fg, gen, cfg, n_chains=n_chains,
                                    n_warmup=0, n_samples=n_samples,
                                    collect="moments", stream_diag=False)
        float(moments["mean"][0])

    dt, spread = timed_runs(run)
    return n_chains * n_samples / dt, spread


def phase_slice(dev, smi, rows=128, chains=(65536, 1024)):
    import numpy as np
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
    lu, h = grid_lu(fg)
    mean_x = lu.solve(h)
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


SIGMA_1_2 = 1.0 / (1.0 + 2.718281828459045 ** -1.2)  # σ(1.2) = 0.76852


def friends_model(n_people, n_observed):
    """bench.py's flagship: ``friends_smokers(n, hybrid=True)`` with
    smokes(p_i) observed as i % 2 for i < n_observed. Given smokes(p),
    cancer(p) is σ(1.2) = 0.7685 for a smoker and 1/2 for a non-smoker
    exactly (docs/PERF.md:43-44)."""
    from lhvi_tpu_torch.models.relational import friends_smokers

    rg = friends_smokers(n_people=n_people, hybrid=True)
    for i in range(n_observed):
        rg.observe("smokes", (f"p{i}",), i % 2)
    return rg


def cancer_errors(marginal, n_observed):
    """Largest |P(cancer(p_i) = 1) − closed form| over the observed
    smokers and non-smokers: ``marginal(key) -> [P(0), P(1)]``."""
    err = [0.0, 0.0]
    for i in range(n_observed):
        want = SIGMA_1_2 if i % 2 else 0.5
        got = float(marginal(("cancer", (f"p{i}",)))[1])
        err[i % 2] = max(err[i % 2], abs(got - want))
    return err


def vi_fit_run(vi, fg, cfg, dev):
    """A ``fit`` ending in a read of its last ELBO → its params."""
    import torch

    out = {}

    def run(seed):
        out["params"], trace = vi.fit(fg, torch.Generator(dev).manual_seed(seed),
                                      cfg)
        out["elbo"] = float(trace[-1])

    return run, out


def phase_vi(dev, smi, n_lifted=320, n_c2f=1000):
    """Lifted hybrid VI through its entry points: ``vi10x10`` and
    ``vi_lifted320`` (bench.py:215-254), the lifting invariant at full
    width (``lift_invariant320``) and coarse-to-fine VI on the array IR at
    1,000 people (``vi_c2f_fast1000``)."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import vi
    from lhvi_tpu_torch.lift import color_refine, compile_lifted
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.relational.fast import fast_compile

    rates = {}
    # vi10x10: the fused closed-form quadratic ELBO; at the optimum
    # mean-field VI on a Gaussian target has the exact means
    t0 = time.perf_counter()
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    exact = np.linalg.solve(J, fg.meta.np_global["quad_h"].astype(np.float64))
    cfg = vi.VIConfig(K=8, n_iters=1000)
    run, out = vi_fit_run(vi, fg, cfg, dev)
    dt, spread = timed_runs(run)
    res = vi.VIResult(fg, out["params"])
    err = float(np.abs(res.w @ res.params.mu - exact).max())
    rates["vi_steps_per_s"] = cfg.n_iters / dt
    log(f"[vi] vi10x10: {fg.n_cont} latents, K={cfg.K}, {cfg.n_iters} steps: "
        f"vi_steps_per_s {rates['vi_steps_per_s']:.6g} (rep spread "
        f"{spread:.3f}) on {smi}; final ELBO {out['elbo']:.4f}; mixture "
        f"means against the dense solve: max abs err {err:.3e} (bound 0.05); "
        f"{time.perf_counter() - t0:.1f} s")
    if not err < 0.05:
        raise AssertionError(f"vi10x10: mixture means off the exact means "
                             f"({err})")

    # vi_lifted320: 103,040 ground RVs colour-refined by the native core
    t0 = time.perf_counter()
    n_obs = n_lifted // 10
    g, index = friends_model(n_lifted, n_obs).ground()
    n_edges = sum(len(f.nb) for f in g.factors)
    t1 = time.perf_counter()
    fg_l = compile_lifted(g, dev)
    t_lift = time.perf_counter() - t1
    n_rv_orbits = len(set(color_refine(g)[0].values()))
    cfg = vi.VIConfig(K=4, n_iters=1500)
    run, out = vi_fit_run(vi, fg_l, cfg, dev)
    dt, spread = timed_runs(run)
    res = vi.VIResult(fg_l, out["params"])
    err = cancer_errors(lambda k: res.disc_marginal(index[k]), n_obs)
    rates["vi_lifted_steps_per_s"] = cfg.n_iters / dt
    log(f"[vi] vi_lifted320: {len(g.rvs)} ground RVs, {n_edges} edges, "
        f"native refinement + lifted compile {t_lift:.2f} s: {n_rv_orbits} "
        f"RV orbits ({fg_l.n_cont} continuous + {fg_l.n_disc} discrete "
        f"latent slots), K={cfg.K}, {cfg.n_iters} steps: "
        f"vi_lifted_steps_per_s {rates['vi_lifted_steps_per_s']:.6g} (rep "
        f"spread {spread:.3f}) on {smi}; cancer of the observed smokers / "
        f"non-smokers: max err {err[1]:.3e} / {err[0]:.3e} from "
        f"{SIGMA_1_2:.4f} / 0.5 (bound 0.01); {time.perf_counter() - t0:.1f} s")
    if not max(err) < 0.01:
        raise AssertionError(f"vi_lifted320 off the closed forms ({err})")

    # lift_invariant320: the fitted lifted params carried to the grounded
    # graph give the same ELBO (tests/test_lift.py:88's tolerances)
    t0 = time.perf_counter()
    fg_g = compile_graph(g, dev)
    t_compile = time.perf_counter() - t0
    p_g = vi._transfer_params(fg_l, fg_g, out["params"])
    e_l = float(vi.elbo(fg_l, out["params"], cfg.n_quad))
    e_g = float(vi.elbo(fg_g, p_g, cfg.n_quad))  # builds the plans

    def step():
        leaves = [p.clone().requires_grad_(True) for p in p_g]
        e = vi.elbo(fg_g, vi.VIParams(*leaves), cfg.n_quad)
        e.backward()
        return leaves[3].grad

    step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    float(step().sum())
    t_step = time.perf_counter() - t1
    log(f"[vi] lift_invariant320: grounded compile {t_compile:.2f} s "
        f"({fg_g.n_cont} + {fg_g.n_disc} latents), one grounded ELBO step "
        f"(value and gradient) {t_step * 1e3:.3f} ms; lifted ELBO "
        f"{e_l:.6f}, grounded {e_g:.6f} (rel diff "
        f"{abs(e_l - e_g) / abs(e_g):.3e}; bound rtol 1e-4, atol 1e-3)")
    if not np.isclose(e_l, e_g, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"lifting invariant broken: {e_l} vs {e_g}")
    del fg_g, p_g

    # vi_c2f_fast1000: fast_compile → refine_ir stages → the grounded ELBO
    # at ~1M latents, the widest VI step the repo runs
    t0 = time.perf_counter()
    n_obs = n_c2f // 10
    fg = fast_compile(friends_model(n_c2f, n_obs), dev)
    t_compile = time.perf_counter() - t0
    cfg = vi.VIConfig(K=4, n_quad=7, n_iters=300)
    stages = []
    fit_from = vi._fit_from

    def timed_fit(fg_s, params, stage_cfg):  # per-stage clock, this phase only
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, trace = fit_from(fg_s, params, stage_cfg)
        float(trace[-1])
        stages.append((fg_s.n_cont, fg_s.n_disc, stage_cfg.n_iters,
                       time.perf_counter() - t1))
        return params, trace

    torch.cuda.reset_peak_memory_stats(dev)
    vi._fit_from = timed_fit
    try:
        res = vi.infer_c2f_fast(fg, 0, cfg, schedule=(1, None, "ground"))
    finally:
        vi._fit_from = fit_from
    peak = torch.cuda.max_memory_allocated(dev)
    err = cancer_errors(res.disc_marginal, n_obs)
    log(f"[vi] vi_c2f_fast1000: fast_compile {t_compile:.2f} s, "
        f"{fg.n_cont} + {fg.n_disc} latents, "
        f"{sum(b.n_factors for b in fg.buckets)} factor rows; K={cfg.K}, "
        f"n_quad={cfg.n_quad}, schedule (1, None, 'ground'); stages (orbits "
        f"continuous + discrete, steps, steps/s incl. their first ELBO): "
        + "; ".join(f"{c} + {d}, {n}, {n / t:.6g}" for c, d, n, t in stages)
        + f"; peak device memory {peak / 2**30:.3f} GiB on {smi}; cancer of "
        f"the observed smokers / non-smokers: max err {err[1]:.3e} / "
        f"{err[0]:.3e} (bound 0.02); {time.perf_counter() - t0:.1f} s")
    if not (max(err) < 0.02 and np.isfinite(res.trace).all()):
        raise AssertionError(f"vi_c2f_fast1000 off the closed forms ({err})")
    return rates


def phase_pod(dev, smi, n_people=320, C=128, S=16):
    """bench.py:344-376's pod cell (``pod_gibbs_chain_samples_per_s``):
    ``run_hmc`` on ``fast_compile`` of the lifted-VI model, mode swap off;
    then ``fast_compile`` against ``compile_graph`` on the same model
    (tests/test_fuzz_fast_compile.py:168 on the card)."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.relational.fast import fast_compile

    t0 = time.perf_counter()
    n_obs = n_people // 10
    fg = fast_compile(friends_model(n_people, n_obs), dev)
    t_compile = time.perf_counter() - t0
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1)
    keep = {}

    def run(seed):
        keep["m"], _, _ = hmc.run_hmc(
            fg, torch.Generator(dev).manual_seed(seed), cfg, n_chains=C,
            n_warmup=0, n_samples=S, collect="moments", stream_diag=False)
        float(keep["m"]["mean"][0])

    dt, spread = timed_runs(run)
    rate = C * S / dt
    # each draw of cancer(p) given the observed smokes(p) is an exact
    # conditional draw: pooled over the 16 smokers (non-smokers), a
    # binomial proportion of 16·C·S draws
    msg = pooled_cancer(fg, keep["m"]["disc_probs"].cpu().numpy(), n_obs,
                        C * S)
    log(f"[pod] pod320: fast_compile {t_compile:.2f} s, {fg.n_cont} + "
        f"{fg.n_disc} latents, {fg.n_colors} colours; {C} chains x {S} "
        f"samples, n_leapfrog 6, step 0.1, mode swap off: "
        f"pod_gibbs_chain_samples_per_s {rate:.6g} (rep spread {spread:.3f}) "
        f"on {smi}; pooled cancer marginal: " + cancer_line(msg))
    if not all(z < 5 for _, _, z in msg):
        raise AssertionError("pod320: cancer marginals off the closed forms")

    # the same IR as the object path: log p at mapped states, the discrete
    # full conditionals, and the colour plan's logits against disc_logits
    t0 = time.perf_counter()
    rg = friends_model(n_people, n_obs)
    g, index = rg.ground()
    fg_o = compile_graph(g, dev, fuse_quadratic=False)
    cont = np.zeros(fg_o.n_cont, np.int64)
    disc = np.zeros(fg_o.n_disc, np.int64)
    for key, rv in index.items():
        kind, i_o = fg_o.meta.loc(rv)
        kind_f, i_f = fg.meta.loc(key)
        if kind != kind_f:
            raise AssertionError(f"{key}: {kind} vs {kind_f}")
        if kind == "c":
            cont[i_o] = i_f
        elif kind == "d":
            disc[i_o] = i_f
    gen = torch.Generator(dev).manual_seed(5)
    xc_o, xd_o = fg_o.init_state_batched(gen, 3, jitter=1.0)
    xc_f = torch.zeros((3, fg.n_cont), device=dev)
    xd_f = torch.zeros((3, fg.n_disc), dtype=torch.int64, device=dev)
    cont_t, disc_t = torch.as_tensor(cont, device=dev), torch.as_tensor(
        disc, device=dev)
    xc_f[:, cont_t], xd_f[:, disc_t] = xc_o, xd_o
    lp_o = fg_o.log_prob_batched(xc_o, xd_o)
    lp_f = fg.log_prob_batched(xc_f, xd_f)
    lg_o = fg_o.disc_logits(xc_o, xd_o)
    lg_f = fg.disc_logits(xc_f, xd_f)[:, disc_t]
    lg_p = hmc.planned_logits(fg, xc_f, xd_f)
    lg_b = fg.disc_logits(xc_f, xd_f)
    big = lg_b < -1e29
    e_lp = rel_err(lp_f, lp_o)
    e_lg = rel_err(lg_f, lg_o)
    e_pl = rel_err(torch.where(big, 0.0, lg_p), torch.where(big, 0.0, lg_b))
    log(f"[pod] fast_compile against compile_graph on the card (errors "
        f"relative to max(1, |value|)): log p {e_lp:.3e} (bound 1e-5), "
        f"disc_logits {e_lg:.3e}, colour plan against disc_logits "
        f"{e_pl:.3e} (bounds 1e-4, tests/test_fuzz_fast_compile.py:58-85); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (e_lp < 1e-5 and e_lg < 1e-4 and e_pl < 1e-4):
        raise AssertionError("fast_compile disagrees with compile_graph")
    return {"pod_gibbs_chain_samples_per_s": rate}


def pooled_cancer(fg, probs, n_obs, n_draws):
    """Pooled P(cancer) of the observed smokers and non-smokers against
    σ(1.2) and 1/2: ``[(got, want, |z|)]`` with ``n_draws`` draws a person
    (each an exact conditional draw given the observed smokes)."""
    out = []
    for parity, want in ((1, SIGMA_1_2), (0, 0.5)):
        idx = [fg.meta.loc(("cancer", (f"p{i}",)))[1]
               for i in range(n_obs) if i % 2 == parity]
        got = float(probs[idx, 1].mean())
        se = (want * (1 - want) / (len(idx) * n_draws)) ** 0.5
        out.append((got, want, abs(got - want) / se))
    return out


def cancer_line(msg):
    return ", ".join(f"{g:.5f} against {w:.5f} ({z:.2f} SE)"
                     for g, w, z in msg) + " (bound 5 SE)"


def spin_clique(n=4, w=2.5, bias=0.4):
    """tests/test_modeswap.py:22-36: n exchangeable binary spins coupled
    all-pairs by a soft biimplication of weight w, each biased toward 1:
    single-site flips face a (n−1)·w barrier."""
    from lhvi_tpu_torch import F, Domain, Graph, RV
    from lhvi_tpu_torch.potentials import MLNPotential, leq

    dom = Domain([0, 1])
    spins = [RV(dom, name=f"s{i}") for i in range(n)]
    fs = [F(MLNPotential(lambda a: leq(a[0], a[1]), w=w), [spins[i], spins[j]])
          for i in range(n) for j in range(i + 1, n)]
    fs += [F(MLNPotential(lambda a: a[0], w=bias), [s]) for s in spins]
    return Graph(spins, fs), spins


def frozen_disagreeing(xd):
    """Latents frozen in every chain at values that disagree across chains
    (tests/test_modeswap.py:280-286): ``xd [S, C, n]``."""
    import numpy as np

    xd = xd.cpu().numpy()
    frozen = (xd.var(axis=0) == 0).all(axis=0)
    return int((frozen & (xd[0].std(axis=0) > 0)).sum())


def phase_modeswap(dev, smi, n_people=320, C=128, S=8, C_spin=4096,
                   n40=40):
    """The collapsed orbit-flip move: HMC, NUTS and SMC with it on the
    locked spin clique against exact enumeration (tests/test_modeswap.py's
    thresholds), the unlock at 40 people (``modeswap40``) and the pod
    flagship at 320 people with the move every transition and every 4th
    (``pod320_modeswap``)."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, modeswap, nuts, smc
    from lhvi_tpu_torch.relational.fast import fast_compile
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    # spin_clique: the reference's thresholds at 4,096 chains
    t0 = time.perf_counter()
    cases = (("hmc", 2.5, 0.4, 1, 0.04), ("hmc", 6.0, 0.25, 1, 0.05),
             ("hmc", 6.0, 0.25, 3, 0.06), ("nuts", 5.0, 0.3, 1, 0.06),
             ("smc", 4.0, 0.3, 1, 0.05))
    for engine, w, bias, every, bound in cases:
        g, spins = spin_clique(4, w, bias)
        exact = ExactPosterior(g)
        fg = compile_graph(g, dev)
        gen = torch.Generator(dev).manual_seed(int(10 * w) + every)
        if engine == "smc":
            res = smc.sample(fg, gen, smc.SMCConfig(
                n_particles=C_spin, n_temps=25, n_moves=2, mode_swap=True))
            acc = float("nan")
        else:
            mod, cfg = ((hmc, hmc.HMCConfig(mode_swap=True,
                                            mode_swap_every=every))
                        if engine == "hmc" else
                        (nuts, nuts.NUTSConfig(mode_swap=True)))
            res = mod.sample(fg, gen, cfg=cfg, n_chains=C_spin, n_warmup=100,
                             n_samples=300, collect="moments")
            acc = float(res.diag["mode_swap_accept"])
        err = max(float(np.abs(res.disc_marginal(s)
                               - exact.disc_marginal(s)).max()) for s in spins)
        log(f"[modeswap] spin_clique {engine}, w {w}, bias {bias}, every "
            f"{every}: marginal err {err:.4f} (bound {bound}); exact P(s=1) "
            f"{exact.disc_marginal(spins[0])[1]:.4f}; mode_swap_accept "
            f"{acc:.4f}")
        if not (err < bound and (engine == "smc" or acc > 0.02)):
            raise AssertionError(f"mode swap on the spin clique ({engine}, "
                                 f"w {w}) off exact enumeration")
    log(f"[modeswap] spin_clique: {time.perf_counter() - t0:.1f} s")

    # modeswap40: without the move the smokes clique freezes per chain
    t0 = time.perf_counter()
    fg = fast_compile(friends_model(n40, 4), dev)
    seen = []
    for on in (False, True):
        _, xd, diag = hmc.run_hmc(
            fg, torch.Generator(dev).manual_seed(0),
            hmc.HMCConfig(n_leapfrog=4, mode_swap=on), n_chains=8,
            n_warmup=50, n_samples=200, collect="samples")
        seen.append((frozen_disagreeing(xd),
                     float(diag.get("mode_swap_accept", float("nan")))))
    log(f"[modeswap] modeswap40: {fg.n_disc} discrete latents, 8 chains x "
        f"250 transitions: frozen and disagreeing latents {seen[0][0]} with "
        f"the move off, {seen[1][0]} on (mode_swap_accept {seen[1][1]:.4f}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (seen[0][0] > 0 and seen[1][0] == 0):
        raise AssertionError("modeswap40: the move did not unlock the clique")

    # pod320_modeswap: phase_pod's model and chains, the move on
    n_obs = n_people // 10
    fg = fast_compile(friends_model(n_people, n_obs), dev)
    t0 = time.perf_counter()
    plan = modeswap.plan_for(fg)
    t_plan = time.perf_counter() - t0
    sizes = [int((plan.vars_[g] < fg.n_disc).sum()) for g in
             range(plan.n_groups)]
    f_sizes = [int(plan.f_mask[g].sum()) for g in range(plan.n_groups)]
    rates = {}
    for every in (1, 4):
        cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1, mode_swap=True,
                            mode_swap_every=every)
        keep = {}

        def run(seed):
            keep["m"], _, keep["d"] = hmc.run_hmc(
                fg, torch.Generator(dev).manual_seed(seed), cfg, n_chains=C,
                n_warmup=0, n_samples=S, collect="moments",
                stream_diag=False)
            float(keep["m"]["mean"][0])

        dt, spread = timed_runs(run)
        rates[every] = C * S / dt
        msg = pooled_cancer(fg, keep["m"]["disc_probs"].cpu().numpy(), n_obs,
                            C * S)
        log(f"[modeswap] pod320_modeswap every {every}: {C} chains x {S} "
            f"samples: {rates[every]:.6g} chain-samples/s (rep spread "
            f"{spread:.3f}) on {smi}; mode_swap_accept "
            f"{float(keep['d']['mode_swap_accept']):.4f}; plan: "
            f"{plan.n_groups} groups of {sizes} members, F of {f_sizes}, "
            f"has_f {plan.has_f}, F's colour cells "
            f"{[len(c) for c in plan.f_cells]} of {fg.n_colors}, direct "
            f"buckets {plan.direct_buckets}, built in {t_plan:.2f} s; pooled "
            f"cancer marginal: " + cancer_line(msg))
        if not all(z < 5 for _, _, z in msg):
            raise AssertionError("pod320_modeswap: cancer marginals off the "
                                 "closed forms")
    return {f"pod320_modeswap{k}_chain_samples_per_s": v
            for k, v in rates.items()}


def phase_pod_scale(dev, smi, sizes=((600, 16), (1000, 8))):
    """bench.py:449-452's scale fields at full size, mode swap off: one
    sample a call, the median of 3 calls after a warm one."""
    import torch

    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.fg.compile import color_plan_bytes
    from lhvi_tpu_torch.relational.fast import fast_compile

    rates = {}
    for n_people, C in sizes:
        t0 = time.perf_counter()
        n_obs = n_people // 10
        torch.cuda.reset_peak_memory_stats(dev)
        fg = fast_compile(friends_model(n_people, n_obs), dev)
        t_compile = time.perf_counter() - t0
        plan_b = color_plan_bytes(fg)
        cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1)
        keep = {}

        def run(seed):
            keep["m"], _, _ = hmc.run_hmc(
                fg, torch.Generator(dev).manual_seed(seed), cfg, n_chains=C,
                n_warmup=0, n_samples=1, collect="moments", stream_diag=False)
            float(keep["m"]["mean"][0])

        dt, spread = timed_runs(run)
        peak = torch.cuda.max_memory_allocated(dev)
        rates[f"pod{n_people}"] = C / dt
        msg = pooled_cancer(fg, keep["m"]["disc_probs"].cpu().numpy(), n_obs, C)
        log(f"[pod_scale] pod{n_people}: fast_compile {t_compile:.2f} s, "
            f"{fg.n_cont} + {fg.n_disc} latents, {fg.n_colors} colours "
            f"({sum(g['n_colors'] for g in plan_b['per_group'])} in "
            f"{plan_b['n_groups']} plan groups), color_plan_bytes "
            f"{plan_b['total_bytes']}; {C} chains x 1 sample a call: "
            f"pod{n_people}_gibbs_chain_samples_per_s {C / dt:.6g} (rep spread "
            f"{spread:.3f}) on {smi}; peak device memory "
            f"{peak / 2**30:.3f} GiB; pooled cancer marginal: "
            + cancer_line(msg) + f"; {time.perf_counter() - t0:.1f} s")
        if not all(z < 5 for _, _, z in msg):
            raise AssertionError(f"pod{n_people}: cancer marginals off the "
                                 "closed forms")
        del fg, keep
    return rates


def grid_lu(fg):
    """A sparse LU of a compiled grid's ELL information form (scipy) →
    ``(lu, h)`` in the compiled latent order."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = fg.n_cont
    diag_np = fg.quad_diag.cpu().numpy().astype(np.float64)
    col = fg.quad_ell_col.cpu().numpy()
    w = fg.quad_ell_w.cpu().numpy().astype(np.float64)
    Jsp = sp.csc_matrix((np.concatenate([diag_np, w.ravel()]),
                         (np.concatenate([np.arange(n), np.repeat(np.arange(n),
                                                                  col.shape[1])]),
                          np.concatenate([np.arange(n), col.ravel()]))),
                        shape=(n, n))
    return spla.splu(Jsp), fg.quad_h.cpu().numpy().astype(np.float64)


def phase_bp(dev, smi, rows=128, n_lifted=320):
    """The BP and MAP engines on the card: GaBP on the 10×10 grid
    (BASELINE config 2) and the 128×128 grid against the dense solve and a
    sparse LU; LBP and EPBP on hybrid_chain (marginals and belief(x)
    against exact enumeration), EPBP on the 10×10 grid; lifted LBP on the
    320-person flagship against the closed forms; MaxWalkSAT against exact
    modes."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import gabp
    from lhvi_tpu_torch.engines.epbp import EPBP, EPBPConfig
    from lhvi_tpu_torch.engines.lbp import HybridLBP
    from lhvi_tpu_torch.engines.map_search import HybridMaxWalkSAT, MWSConfig
    from lhvi_tpu_torch.lift import compile_lifted
    from lhvi_tpu_torch.models.toy import gaussian_grid, hybrid_chain
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    rates = {}
    # GaBP (tests/test_gabp.py:31-37: means within 1e-3)
    for name, g_rows, seed, ev in (("gabp10x10", 10, 0, 0.2),
                                   (f"gabp{rows}", rows, 1, 0.05)):
        t0 = time.perf_counter()
        g, _ = gaussian_grid(g_rows, g_rows, seed=seed, evidence_frac=ev)
        eng = gabp.GaBP(g, dev)
        t_build = time.perf_counter() - t0
        fg = (compile_graph(g, dev) if g_rows == 10 else
              compile_graph(g, dev, quad_max_n=min(4096, g_rows * g_rows // 4)))
        if fg.quad_sparse:
            lu, h = grid_lu(fg)
            exact = lu.solve(h)
        else:
            J = fg.meta.np_global["quad_J"].astype(np.float64)
            exact = np.linalg.solve(J, fg.meta.np_global["quad_h"])
        order = np.array([fg.meta.loc(rv)[1] for rv in eng.latents])
        iters = 0
        for iters in (25, 50, 100, 200, 400, 1000):
            eng.run(iters=iters, warn_tol=np.inf)
            if eng.last_delta_ < 1e-5:
                break
        dt, _ = timed_runs(lambda _: eng.run(iters=iters, warn_tol=np.inf))
        err = float(np.abs(eng.mean_ - exact[order]).max())
        rates[name] = iters / dt
        log(f"[bp] {name}: {len(eng.latents)} latents, {eng.n_edges} directed "
            f"edges, host build {t_build:.2f} s; {iters} sweeps to last delta "
            f"{eng.last_delta_:.2e} (< 1e-5): {iters / dt:.6g} sweeps/s on "
            f"{smi}; means against the "
            f"{'sparse LU' if fg.quad_sparse else 'dense solve'}: max err "
            f"{err:.3e} (bound 1e-3)")
        if not (eng.last_delta_ < 1e-5 and err < 1e-3):
            raise AssertionError(f"{name} off the exact means")

    # hybrid_chain: LBP and EPBP against exact enumeration, belief(x)
    xq = np.array([-2.831, -1.117, -0.303, 0.517, 1.293, 2.719])
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fgh = compile_graph(g, dev)
    eng = EPBP(fgh, EPBPConfig(n_particles=128, n_iters=40))
    dt, _ = timed_runs(lambda _: eng.run(torch.Generator(dev).manual_seed(1)))
    rates["epbp_hybrid"] = 40 / dt
    errs = (float(np.abs(eng.disc_marginal(d) - exact.disc_marginal(d)).max()),
            max(abs(eng.mean(x) - exact.mean(x)) for x in (x1, x2)),
            abs(eng.var(x2) - exact.var(x2)) / exact.var(x2),
            max(float(np.abs(eng.belief(xq, x) - exact.density(xq, x)).max())
                for x in (x1, x2)))
    log(f"[bp] epbp_hybrid: P = 128, 40 iterations: {40 / dt:.6g} "
        f"iterations/s on {smi}; P(d) err {errs[0]:.4f} (< 0.08), mean err "
        f"{errs[1]:.4f} (< 0.22), var(x2) rel err {errs[2]:.4f} (< 0.4), "
        f"belief(x) err {errs[3]:.4f} (< 0.09)")
    if not (errs[0] < 0.08 and errs[1] < 0.22 and errs[2] < 0.4
            and errs[3] < 0.09):
        raise AssertionError("EPBP on hybrid_chain off the exact posterior")
    for x in (x1, x2):
        x.domain.integral_points = np.linspace(-6, 6, 64)
    exact = ExactPosterior(g, cont_grid=161)
    eng = HybridLBP(compile_graph(g, dev))
    dt, _ = timed_runs(lambda _: eng.run(n_iters=30))
    rates["lbp_hybrid"] = 30 / dt
    errs = (float(np.abs(eng.disc_marginal(d) - exact.disc_marginal(d)).max()),
            max(abs(eng.mean(x) - exact.mean(x)) for x in (x1, x2)),
            max(float(np.abs(eng.belief(xq, x) - exact.density(xq, x)).max())
                for x in (x1, x2)))
    log(f"[bp] lbp_hybrid: 64 integral points, 30 iterations: "
        f"{30 / dt:.6g} iterations/s on {smi}; tables {eng.table_bytes} B; "
        f"P(d) err {errs[0]:.4f} (< 0.05), mean err {errs[1]:.4f} (< 0.1), "
        f"belief(x) err {errs[2]:.4f} (< 0.06)")
    if not (errs[0] < 0.05 and errs[1] < 0.1 and errs[2] < 0.06):
        raise AssertionError("LBP on hybrid_chain off the exact posterior")

    # epbp10x10: tests/test_epbp.py:28-45's thresholds against the dense solve
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    dense, latents = gabp.dense_gaussian_marginals(g)
    eng = EPBP(compile_graph(g, dev), EPBPConfig(n_particles=128, n_iters=50))
    dt, _ = timed_runs(lambda _: eng.run(torch.Generator(dev).manual_seed(0)))
    rates["epbp10x10"] = 50 / dt
    e_m = max(abs(eng.mean(rv) - dense[id(rv)][0]) for rv in latents)
    e_v = max(abs(eng.var(rv) - dense[id(rv)][1]) / dense[id(rv)][1]
              for rv in latents)
    log(f"[bp] epbp10x10: {len(latents)} latents, P = 128, 50 iterations: "
        f"{50 / dt:.6g} iterations/s on {smi}; max mean err {e_m:.4f} (< 0.25), "
        f"max var rel err {e_v:.4f} (< 0.4)")
    if not (e_m < 0.25 and e_v < 0.4):
        raise AssertionError("EPBP on the 10x10 grid off the dense solve")

    # lbp_lifted320: lifted LBP on vi_lifted320's model, the closed forms
    t0 = time.perf_counter()
    n_obs = n_lifted // 10
    g, index = friends_model(n_lifted, n_obs).ground()
    fg_l = compile_lifted(g, dev)
    t_lift = time.perf_counter() - t0
    eng = HybridLBP(fg_l)
    dt, _ = timed_runs(lambda _: eng.run(n_iters=30))
    rates[f"lbp_lifted{n_lifted}"] = 30 / dt
    err = cancer_errors(lambda k: eng.disc_marginal(index[k]), n_obs)
    log(f"[bp] lbp_lifted{n_lifted}: {fg_l.n_cont} + {fg_l.n_disc} lifted latents, "
        f"compile_lifted {t_lift:.2f} s, S = {eng.S}, tables "
        f"{eng.table_bytes} B ({[tuple(t.log_phi.shape) for t in eng.tables]}); "
        f"30 iterations: {30 / dt:.6g} iterations/s on {smi}; cancer of the "
        f"observed smokers / non-smokers: max err {err[1]:.3e} / {err[0]:.3e} "
        f"from {SIGMA_1_2:.4f} / 0.5 (bound 0.01)")
    if not max(err) < 0.01:
        raise AssertionError(f"lbp_lifted320 off the closed forms ({err})")

    # mws: tests/test_nuts_map.py:44-70, and the 10x10 grid's mode
    g, (d, x1, x2) = hybrid_chain()
    want = ExactPosterior(g, cont_grid=201).map_state()
    eng = HybridMaxWalkSAT(compile_graph(g, dev),
                           MWSConfig(n_walkers=64, n_steps=400, grad_step=0.1))
    dt, _ = timed_runs(lambda _: eng.run(torch.Generator(dev).manual_seed(1)))
    rates["mws"] = 400 / dt
    e_h = max(abs(eng.map(x1) - want[x1]), abs(eng.map(x2) - want[x2]))
    ok = eng.map(d) == want[d] and e_h < 0.15
    from lhvi_tpu_torch import F, Domain, Graph, RV
    from lhvi_tpu_torch.potentials import GaussianPotential

    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g2 = Graph([a, b], [F(GaussianPotential([1.5, -0.5],
                                            [[1.0, 0.4], [0.4, 1.0]]), [a, b])])
    eng2 = HybridMaxWalkSAT(compile_graph(g2, dev),
                            MWSConfig(n_walkers=32, n_steps=200)).run(
        torch.Generator(dev).manual_seed(0))
    e_g = max(abs(eng2.map(a) - 1.5), abs(eng2.map(b) + 0.5))
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    mode = np.linalg.solve(J, fg.meta.np_global["quad_h"].astype(np.float64))
    lp_mode = float(fg.log_prob(torch.tensor(mode, dtype=torch.float32,
                                             device=dev),
                                torch.zeros(0, dtype=torch.int64, device=dev)))
    eng3 = HybridMaxWalkSAT(fg, MWSConfig()).run(
        torch.Generator(dev).manual_seed(2))
    excess = (eng3.energy - lp_mode) / abs(lp_mode)
    log(f"[bp] mws: hybrid_chain, 64 walkers x 400 steps: {400 / dt:.6g} "
        f"steps/s on {smi}; d {eng.map(d)} (exact {want[d]}), continuous "
        f"err {e_h:.4f} (< 0.15); Gaussian mode err {e_g:.4f} (< 0.1); 10x10 "
        f"grid: best log p {eng3.energy:.6f} against {lp_mode:.6f} at the "
        f"dense-solve mode (excess {excess:.3e} of |log p|; bound 1e-5)")
    if not (ok and e_g < 0.1 and excess <= 1e-5):
        raise AssertionError("MaxWalkSAT off the exact modes")
    return rates


# ---- the runtime path: resumable sampling, two ranks, the comparison ----


def _ckpt_timer():
    """Wrap ``CheckpointManager.save`` to record each save's seconds (from
    a device that has finished the chunk's work: the copy to the host,
    ``torch.save``, fsync and the rename) and file bytes; returns
    (records, undo)."""
    import os

    import torch

    from lhvi_tpu_torch.utils import checkpoint

    real = checkpoint.CheckpointManager.save
    rec = []

    def save(self, step, payload, wait=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(self, step, payload, wait)
        rec.append((time.perf_counter() - t0,
                    os.path.getsize(self._path(step))))

    checkpoint.CheckpointManager.save = save

    def undo():
        checkpoint.CheckpointManager.save = real

    return rec, undo


def _as_torch(res):
    """An ``HMCMoments``' numpy moments and diag as CPU tensors, the form
    ``check_moments`` reads."""
    import torch

    return ({k: torch.as_tensor(v) for k, v in res.moments.items()},
            {k: torch.as_tensor(v) for k, v in res.diag.items()})


def resume_case(dev, smi, name, fg, cfg, engine, C, n_warmup, n_samples,
                chunk, max_to_keep, keys):
    """``sample_checkpointed`` uninterrupted, then interrupted at the
    warmup's phase boundary (``n_warmup // 2`` must be a chunk boundary),
    resumed, interrupted after one sample chunk, resumed to the end: the
    moments and ``keys`` of ``diag`` bitwise equal. Prints checkpoint bytes,
    seconds per save and chain-samples/s beside ``run_hmc``/``run_nuts``'s
    at the same size. Returns (result, rates)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lhvi_tpu_torch.engines import hmc, nuts
    from lhvi_tpu_torch.engines.resumable import sample_checkpointed

    assert (n_warmup // 2) % chunk == 0
    root = tempfile.mkdtemp(prefix=f"lhvi_resume_{name}_")
    kw = dict(engine=engine, n_chains=C, n_warmup=n_warmup,
              n_samples=n_samples, chunk_size=chunk, max_to_keep=max_to_keep)
    run = nuts.run_nuts if engine == "nuts" else hmc.run_hmc
    # a warm call first (plans, handles, first launches), then the timed one
    run(fg, torch.Generator(dev).manual_seed(4), cfg, n_chains=C,
        n_warmup=2, n_samples=2, collect="moments")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, _, _ = run(fg, torch.Generator(dev).manual_seed(5), cfg, n_chains=C,
                  n_warmup=n_warmup, n_samples=n_samples, collect="moments")
    float(m["mean"].sum())
    dt_plain = time.perf_counter() - t0
    rec, undo = _ckpt_timer()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = sample_checkpointed(fg, torch.Generator(dev).manual_seed(5),
                                   cfg, ckpt_dir=f"{root}/full", **kw)
        dt_full = time.perf_counter() - t0
        saves = list(rec)
        shutil.rmtree(f"{root}/full")
        part = f"{root}/part"
        assert sample_checkpointed(
            fg, torch.Generator(dev).manual_seed(5), cfg, ckpt_dir=part,
            _interrupt_warmup_after=n_warmup // 2 // chunk, **kw) is None
        assert sample_checkpointed(
            fg, torch.Generator(dev).manual_seed(5), cfg, ckpt_dir=part,
            _interrupt_after=1, **kw) is None
        resumed = sample_checkpointed(fg, torch.Generator(dev).manual_seed(5),
                                      cfg, ckpt_dir=part, **kw)
    finally:
        undo()
        shutil.rmtree(root, ignore_errors=True)
    same = {k: bool(np.array_equal(full.moments[k], resumed.moments[k]))
            for k in ("mean", "var", "disc_probs")}
    same.update({k: bool(np.array_equal(full.diag[k], resumed.diag[k]))
                 for k in keys})
    save_s = [s for s, _ in saves]
    rates = {f"resume_{name}_chain_samples_per_s": C * n_samples / dt_full,
             f"plain_{name}_chain_samples_per_s": C * n_samples / dt_plain}
    log(f"[runtime] resume {name}: {C} chains, {n_warmup}+{n_samples} in "
        f"chunks of {chunk}: bitwise after a warmup interruption at the "
        f"phase boundary and a sample-chunk interruption: {same}; "
        f"checkpoint {saves[-1][1]} B, {len(saves)} saves, median "
        f"{statistics.median(save_s):.4f} s a save ({sum(save_s):.3f} s of "
        f"{dt_full:.3f} s); sample_checkpointed "
        f"{rates[f'resume_{name}_chain_samples_per_s']:.6g} chain-samples/s "
        f"(warmup and saves in the clock) against {run.__name__} "
        f"{rates[f'plain_{name}_chain_samples_per_s']:.6g} at the same size "
        f"on {smi}")
    if not all(same.values()):
        raise AssertionError(f"resume {name} is not bitwise: {same}")
    rates[f"ckpt_{name}_bytes"] = saves[-1][1]
    rates[f"ckpt_{name}_save_s"] = statistics.median(save_s)
    return full, rates


def phase_resume(dev, smi, C=65536, C_big=1024, rows=128, C_hybrid=16384,
                 steps=(100, 100, 50), big_steps=(200, 200, 100)):
    """Bitwise resume on the card through K1 (10×10 grid), K2 (the banded
    grid), K3 (NUTS on the 10×10 grid) and K5 (``hybrid_chain`` fused),
    each held to its oracle as well."""
    import numpy as np

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, nuts
    from lhvi_tpu_torch.models.toy import gaussian_grid, hybrid_chain
    from lhvi_tpu_torch.utils.oracle import ExactPosterior

    rates = {}
    diag_keys = ("accept_rate", "rhat", "ess_bm", "step_size", "inv_mass")
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    mean_x, var_x = np.linalg.solve(J, h), np.diag(np.linalg.inv(J))
    for name, engine, cfg in (
            ("grid10x10", "hmc", hmc.HMCConfig(n_leapfrog=8,
                                               init_step_size=0.12)),
            ("nuts10x10", "nuts", nuts.NUTSConfig(max_depth=4,
                                                  init_step_size=0.12))):
        res, r = resume_case(dev, smi, name, fg, cfg, engine, C, *steps, 2,
                             diag_keys)
        rates.update(r)
        check_moments(f"resume {name}", *_as_torch(res), mean_x,
                      np.arange(fg.n_cont), var_x)
    g, _ = gaussian_grid(rows, rows, seed=1, evidence_frac=0.05)
    fg = compile_graph(g, dev, quad_max_n=min(4096, rows * rows // 4))
    assert fg.quad_sparse and hmc._use_dia(fg, hmc.HMCConfig())
    lu, h = grid_lu(fg)
    spot = np.random.default_rng(0).choice(fg.n_cont, 64, replace=False)
    var_x = np.array([lu.solve(np.eye(fg.n_cont, 1, -int(i)).ravel())[i]
                      for i in spot])
    res, r = resume_case(dev, smi, f"grid{rows}x{rows}", fg,
                         hmc.HMCConfig(n_leapfrog=6, init_step_size=0.05),
                         "hmc", C_big, *big_steps, 2, diag_keys)
    rates.update(r)
    check_moments(f"resume grid{rows}x{rows}", *_as_torch(res), lu.solve(h),
                  spot, var_x)
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g, dev)
    res, r = resume_case(dev, smi, "hybrid_chain_fused", fg,
                         hmc.HMCConfig(fused_logpot=True), "hmc", C_hybrid,
                         *steps, 2, diag_keys + ("rhat_disc",))
    rates.update(r)
    exact = ExactPosterior(g, cont_grid=161)
    errs = [abs(res.mean(x) - exact.mean(x)) for x in (x1, x2)]
    derr = float(np.abs(res.disc_marginal(d) - exact.disc_marginal(d)).max())
    log(f"[runtime] resume hybrid_chain_fused: mean err {max(errs):.4f} "
        f"(< 0.12), P(d) err {derr:.4f} (< 0.08), rhat_disc "
        f"{float(res.diag['rhat_disc'].max()):.4f}")
    if not (max(errs) < 0.12 and derr < 0.08):
        raise AssertionError("resume hybrid_chain off the exact posterior")
    return rates


def dryrun_steps(dev, dp, tp, n_pod=40, rows=8, vi_people=40, vi_steps=50):
    """The port's counterpart of ``dryrun_multichip``
    (``__graft_entry__.py:45-202``): one step of every backend under a
    (dp, tp) layout of process groups, through public entry points. ``dp``
    and ``tp`` are this rank's ``ChainShard``s (one group may be both).
    VI takes an Adam step with every bucket's rows sharded over ``tp``
    (``friends_smokers(6, hybrid=True)``, ``pad_to=max(8, tp)``), held to
    the unsharded step; HMC, NUTS and SMC run a few steps with the chains
    sharded over ``dp``; the pod path (``fast_compile`` of
    ``friends_smokers(n_pod)``, 8 observed smokers) runs with the mode-swap
    move; the banded route (``gaussian_grid(rows, rows)`` with
    ``quad_max_n=16``) with ``dia_kernel`` on and off. Then the tp-sharded
    and unsharded VI step rates on the grounded
    ``friends_smokers(vi_people)``. Returns what the caller checks."""
    import dataclasses

    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, nuts, smc, vi
    from lhvi_tpu_torch.models.relational import friends_smokers
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.parallel import replicas_equal, shard_fg_factors
    from lhvi_tpu_torch.relational.fast import fast_compile

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def finite(*ts):
        return all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in ts)

    out = {}
    g, _ = friends_smokers(n_people=6, hybrid=True).ground()
    fg = compile_graph(g, dev, pad_to=max(8, tp.world))
    cfg = vi.VIConfig(K=2, n_quad=5, n_iters=1, lr=1e-2)
    p0 = vi.init_params(fg, gen(0), cfg)
    p_tp, tr_tp = vi._fit_from(shard_fg_factors(fg, tp), p0, cfg)
    p_1, tr_1 = vi._fit_from(fg, p0, cfg)
    out["vi"] = {
        "loss": -float(tr_tp[0]), "loss_whole": -float(tr_1[0]),
        "param_diff": max(float((a - b).abs().max() / (1 + b.abs().max()))
                          for a, b in zip(p_tp, p_1) if b.numel()),
        "same": all(replicas_equal(p, tp) for p in p_tp)}

    kw = dict(n_chains=4 * dp.world, n_warmup=2, n_samples=2,
              collect="moments", shard=dp)
    scfg = smc.SMCConfig(n_particles=8 * dp.world, n_temps=3, n_moves=1,
                         n_leapfrog=2, adaptive=True)
    sxc, _, _, slz, _ = smc.run_smc(fg, gen(2), scfg, shard=dp)
    m, _, d = nuts.run_nuts(fg, gen(3), nuts.NUTSConfig(
        max_depth=3, init_step_size=0.05), **kw)
    hm, _, hd = hmc.run_hmc(fg, gen(4), hmc.HMCConfig(
        n_leapfrog=3, init_step_size=0.05), **kw)
    out["dp"] = finite(slz, sxc, d["accept_rate"], m["mean"],
                       hd["accept_rate"], hm["mean"])

    rg = friends_smokers(n_people=n_pod, hybrid=True)
    for i in range(8):
        rg.observe("smokes", (f"p{i}",), i % 2)
    pod = fast_compile(rg, dev)
    pm, _, pd = hmc.run_hmc(
        pod, gen(5), hmc.HMCConfig(n_leapfrog=2, init_step_size=0.05,
                                   adapt_mass=False, mode_swap=True),
        n_chains=2 * dp.world, n_warmup=1, n_samples=4, collect="moments",
        shard=dp)
    out["pod"] = {
        "plan": pod.color_plan is not None,
        "finite": finite(pd["accept_rate"], pd["mode_swap_accept"],
                         pm["mean"], pd["rhat"], pd["rhat_disc"]),
        "n_rhat_disc": int(pd["rhat_disc"].numel()),
        "ms_accept": float(pd["mode_swap_accept"])}

    g, _ = gaussian_grid(rows=rows, cols=rows, seed=0, evidence_frac=0.1)
    fge = compile_graph(g, dev, quad_max_n=16)  # force the sparse form
    out["banded"] = {"dia": (fge.quad_sparse and fge.cont_pure_quad
                             and fge.quad_dia_offsets is not None)}
    for dia_on in (True, False):
        _, _, ed = hmc.run_hmc(
            fge, gen(6), hmc.HMCConfig(n_leapfrog=3, init_step_size=0.05,
                                       adapt_mass=False, dia_kernel=dia_on),
            n_chains=2 * dp.world, n_warmup=1, n_samples=2,
            collect="moments", shard=dp)
        out["banded"][dia_on] = finite(ed["accept_rate"])

    # the tp-sharded VI step against the unsharded one, timed
    g, _ = friends_smokers(n_people=vi_people, hybrid=True).ground()
    fg = compile_graph(g, dev, pad_to=max(8, tp.world))
    cfg = vi.VIConfig(K=4, n_quad=7, n_iters=vi_steps)
    p0 = vi.init_params(fg, gen(7), cfg)
    rates = {}
    for name, fgr in (("tp", shard_fg_factors(fg, tp)), ("whole", fg)):
        vi._fit_from(fgr, p0, dataclasses.replace(cfg, n_iters=2))
        t0 = time.perf_counter()
        _, tr = vi._fit_from(fgr, p0, cfg)
        float(tr[-1])
        rates[name] = (vi_steps / (time.perf_counter() - t0), float(tr[-1]))
    out["vi_rate"] = {"n_rows": sum(b.n_factors for b in fg.buckets),
                      **rates}
    return out


def host_moments(m):
    """A moments dict with its tensors copied to host numpy arrays."""
    import torch

    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in m.items()}


def pooled_diff(sh, loc):
    """A sharded run's moments ``sh`` against the pooled unsharded runs of
    each rank's chains ``loc`` → (discrete counts equal, mean difference,
    variance difference). Each difference is relative to the largest term
    the f32 sums behind it hold: the rank means (and the pooled mean) for
    the mean, the rank second moments for the variance. Where the ranks'
    means cancel, the pooled mean is far smaller than its terms, and their
    f32 rounding alone would exceed 1e-5 of it."""
    import numpy as np

    world = len(loc)
    n_obs = sh["n_obs"]
    counts = np.rint(sh["disc_probs"] * n_obs)
    pooled = sum(np.rint(x["disc_probs"] * x["n_obs"]) for x in loc)
    means = [x["mean"].astype(np.float64) for x in loc]
    seconds = [x["var"].astype(np.float64) + m ** 2 for x, m in zip(loc, means)]
    mean = sum(means) / world
    var = sum(seconds) / world - mean ** 2
    scale_m = np.maximum(np.max(np.abs(means), axis=0), np.abs(mean))
    scale_v = np.max(seconds, axis=0)
    dm = float(np.max(np.abs(sh["mean"] - mean) / np.maximum(scale_m, 1e-6)))
    dv = float(np.max(np.abs(sh["var"] - var) / np.maximum(scale_v, 1e-6)))
    return bool(np.array_equal(counts, pooled)), dm, dv


def owed_checks(dev, shard, rows=128, quad_max_n=4096, C=1024, S=20,
                C_hybrid=16384, hybrid_steps=(50, 200, 300), C_robot=16384,
                S_robot=20):
    """The sharded runs through K2 and K5 (one rank's part). K2: the banded
    ``gaussian_grid(rows, rows)`` at ``C`` chains, adaptation off, sharded
    and this rank's unsharded run of its own stream; one proposal from a
    start shared by the ranks, its momenta drawn from the rank's generator
    (the ranks' ``x1`` must differ). K5 (``fused_logpot=True``):
    ``hybrid_chain`` sharded with adaptation off beside this rank's run,
    then sharded with adaptation against the closed forms
    (``hybrid_steps``: samples of the first run, warmup and samples of the
    second);
    ``robot_map(100)`` at ``C_robot`` chains sharded beside this rank's
    run. Returns what the parent checks."""
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.models.toy import gaussian_grid, hybrid_chain
    from lhvi_tpu_torch.ops.dia import _KEY_TAG, dia_hmc_proposal
    from lhvi_tpu_torch.parallel import all_reduce, split_generator

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def pair(fg, cfg, seed, n_chains, n_samples):
        """(sharded moments, this rank's unsharded moments, launches of
        the sharded run's K2 and K5, its seconds after a warm run)."""
        kw = dict(n_warmup=0, collect="moments", stream_diag=False)
        m1, _, _ = hmc.run_hmc(fg, gen(seed + 100), cfg, n_chains=n_chains,
                               n_samples=2, shard=shard, **kw)
        float(m1["mean"][0])
        k2, k5 = kernel_launches("k2"), kernel_launches("k5")
        t0 = time.perf_counter()
        m1, _, _ = hmc.run_hmc(fg, gen(seed), cfg, n_chains=n_chains,
                               n_samples=n_samples, shard=shard, **kw)
        float(m1["mean"][0])
        dt = time.perf_counter() - t0
        k2 = kernel_launches("k2") - k2
        k5 = kernel_launches("k5") - k5
        m0, _, _ = hmc.run_hmc(fg, split_generator(gen(seed), shard.rank)[0],
                               cfg, n_chains=n_chains // shard.world,
                               n_samples=n_samples, **kw)
        return {"sharded": host_moments(m1), "local": host_moments(m0),
                "k2": k2, "k5": k5, "s": dt}

    out = {}
    g, _ = gaussian_grid(rows, rows, seed=1, evidence_frac=0.05)
    fg = compile_graph(g, dev, quad_max_n=quad_max_n)
    assert fg.quad_sparse and hmc._use_dia(fg, hmc.HMCConfig())
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.05, adapt_mass=False)
    out["k2"] = pair(fg, cfg, 7, C, S)
    # one proposal from a start every rank shares: only the momenta differ
    rank_gen = split_generator(gen(8), shard.rank)[0]
    x0, _ = fg.init_state_batched(gen(9), C // shard.world)
    x1, log_acc = dia_hmc_proposal(
        rank_gen, x0, fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w,
        fg.quad_h, torch.ones(fg.n_cont, device=dev), 0.05, 6,
        pos=fg.quad_dia_pos, inv=fg.quad_dia_inv)
    same = torch.all(all_reduce(x1, shard, "max") == -all_reduce(
        -x1, shard, "max"), dim=1)
    out["k2"].update(rows_equal=int(same.sum()), rows=int(x1.shape[0]),
                     finite=bool(torch.isfinite(log_acc).any()),
                     seed=rank_gen.initial_seed() ^ _KEY_TAG)

    g, (d, x1_, x2_) = hybrid_chain()
    fgh = compile_graph(g, dev)
    out["hybrid"] = pair(fgh, hmc.HMCConfig(init_step_size=0.2,
                                            fused_logpot=True), 10, C_hybrid,
                         hybrid_steps[0])
    k5 = kernel_launches("k5")
    m, _, diag = hmc.run_hmc(fgh, gen(11), hmc.HMCConfig(
        init_step_size=0.2, fused_logpot=True), n_chains=C_hybrid,
        n_warmup=hybrid_steps[1], n_samples=hybrid_steps[2],
        collect="moments", shard=shard)
    out["hybrid"]["exact"] = {
        "k5": kernel_launches("k5") - k5,
        "pd": float(m["disc_probs"][fgh.meta.loc(d)[1], 1]),
        "x1": float(m["mean"][fgh.meta.loc(x1_)[1]]),
        "x2": float(m["mean"][fgh.meta.loc(x2_)[1]]),
        "step": float(diag["step_size"])}
    fgr, _ = robot_fg(dev)
    out["robot"] = pair(fgr, hmc.HMCConfig(n_leapfrog=8, init_step_size=0.05,
                                           fused_logpot=True), 12, C_robot,
                        S_robot)
    return out


def sharded_checks(dev, shard, C=65536, N=65536, S=50, steps=(100, 100)):
    """One rank's part of the two-rank path (``rank_worker``): sharded
    ``run_hmc`` with adaptation off beside this rank's unsharded run from
    its own stream, sharded ``run_hmc`` and ``run_nuts`` with adaptation,
    sharded ``run_smc`` on ``kalman_lds(T=20)`` with both schedules, the
    dry-run step list (``dryrun_steps``, both ranks on ``dp`` and on
    ``tp``) and the sharded runs through K2 and K5 (``owed_checks``).
    Returns what the parent checks."""
    import numpy as np
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, nuts, smc
    from lhvi_tpu_torch.models.lds import kalman_lds
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.parallel import replicas_equal, split_generator

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    out = {}
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, dev)
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    mean_x, var_x = np.linalg.solve(J, h), np.diag(np.linalg.inv(J))
    off = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.12, adapt_mass=False)
    kw = dict(n_warmup=0, collect="moments", stream_diag=False)
    hmc.run_hmc(fg, gen(1), off, n_chains=C, n_samples=2, shard=shard, **kw)
    sync()
    t0 = time.perf_counter()
    m1, _, d1 = hmc.run_hmc(fg, gen(0), off, n_chains=C, n_samples=S,
                            shard=shard, **kw)
    float(m1["mean"].sum())
    dt = time.perf_counter() - t0
    m0, _, d0 = hmc.run_hmc(fg, split_generator(gen(0), shard.rank)[0], off,
                            n_chains=C // shard.world, n_samples=S, **kw)
    out["off"] = {"sharded": host_moments(m1), "local": host_moments(m0),
                  "s": dt,
                  "acc": (float(d1["accept_rate"]), float(d0["accept_rate"]))}
    for name, run, cfg in (
            ("hmc", hmc.run_hmc, hmc.HMCConfig(n_leapfrog=8,
                                               init_step_size=0.12)),
            ("nuts", nuts.run_nuts, nuts.NUTSConfig(max_depth=4,
                                                    init_step_size=0.12))):
        m, _, d = run(fg, gen(2), cfg, n_chains=C, n_warmup=steps[0],
                      n_samples=steps[1], collect="moments", shard=shard)
        mm = m["mean"].cpu().numpy().astype(np.float64)
        v = m["var"].cpu().numpy().astype(np.float64)
        out[name] = {
            "same": (replicas_equal(d["step_size"], shard)
                     and replicas_equal(d["inv_mass"], shard)),
            "err": (float(np.abs(mm - mean_x).mean()),
                    float(np.abs(mm - mean_x).max())),
            "rel": (float(np.abs(v / var_x - 1).mean()),
                    float(np.abs(v / var_x - 1).max())),
            "acc": float(d["accept_rate"]), "step": float(d["step_size"]),
            "ess_min": float(d["ess_bm"].min()),
            "div": float(d.get("divergence_rate", torch.zeros(()))),
        }
    g, _, _ = kalman_lds(T=20, seed=0)
    fg = compile_graph(g, dev)
    for adaptive in (False, True):
        cfg = smc.SMCConfig(n_particles=N, n_temps=50, n_moves=2,
                            adaptive=adaptive)
        _, _, lw, lz, d = smc.run_smc(fg, gen(3), cfg, shard=shard)
        out[f"smc_{adaptive}"] = {
            "lz": float(lz), "rows": int(lw.shape[0]),
            "n_used": int(d["n_temps_used"]),
            "same": replicas_equal(torch.stack([lz, d["final_step"]]), shard)}
    out["dryrun"] = dryrun_steps(dev, shard, shard)
    out["owed"] = owed_checks(dev, shard)
    return out


# the kernels the two-rank path reaches, by the name of their counter
RANK_KERNELS = {"quad_leapfrog": "k1", "dia_proposal": "k2", "nuts_traj": "k3",
                "weights": "k4", "logpot_leapfrog": "k5"}


def rank_worker(rank: int, world: int, port: int, out: str) -> int:
    """One rank of the two-rank path: joins a gloo group on localhost, works
    on ``cuda:0``, saves its results and launch counts to ``out``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import lhvi_tpu_torch  # noqa: F401  (turns TF32 off)
    from lhvi_tpu_torch.parallel import init_distributed
    from lhvi_tpu_torch.utils.metrics import reset_tracing

    torch.cuda.set_device(0)
    shard = init_distributed("gloo", f"tcp://127.0.0.1:{port}", rank, world)
    reset_tracing()
    res = sharded_checks(torch.device("cuda", 0), shard)
    res["launches"] = {k: kernel_launches(c) for k, c in RANK_KERNELS.items()}
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def spawn_ranks(argv_tail, world=2, timeout=600):
    """Run ``world`` ranks of this script (``--rank-worker``), wait for all,
    and return their saved results; a rank's non-zero exit fails."""
    import os
    import socket
    import tempfile

    import torch

    out = tempfile.mkdtemp(prefix="lhvi_ranks_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", str(r),
         str(world), str(port), out] + list(argv_tail),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    res = [torch.load(f"{out}/rank{r}.pt", weights_only=False)
           for r in range(world)]
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    return res


def check_ranks(res, smi, C=65536, N=65536, S=50, log_z=-3.81307):
    """The parent's checks of the two-rank path → (rates, launches)."""
    import numpy as np

    world = len(res)
    launches = {k: [r["launches"][k] for r in res]
                for k in res[0]["launches"]}
    log(f"[runtime] two ranks on one card (gloo, cuda:0): launches per "
        f"rank {launches}")
    for k, per in launches.items():
        if min(per) <= 0:
            raise AssertionError(f"{k} never ran on a rank: {per}")
    sh = [r["off"]["sharded"] for r in res]
    loc = [r["off"]["local"] for r in res]
    n_obs = sh[0]["n_obs"]
    counts = np.rint(sh[0]["disc_probs"] * n_obs)
    pooled_counts = sum(np.rint(x["disc_probs"] * x["n_obs"]) for x in loc)
    mean = sum(x["mean"].astype(np.float64) for x in loc) / world
    second = sum(x["var"].astype(np.float64) + x["mean"].astype(np.float64)
                 ** 2 for x in loc) / world
    var = second - mean ** 2
    rm = float(np.max(np.abs(sh[0]["mean"] - mean) / np.maximum(
        np.abs(mean), 1e-6)))
    rv = float(np.max(np.abs(sh[0]["var"] - var) / var))
    log(f"[runtime] sharded run_hmc, adaptation off ({C} chains, {C // world} "
        f"a rank, {S} samples) against the pooled rank runs: counts equal "
        f"{bool(np.array_equal(counts, pooled_counts))}, mean rel diff "
        f"{rm:.3e}, var rel diff {rv:.3e} (rtol 1e-5); ranks agree "
        f"{all(np.array_equal(sh[0][k], sh[1][k]) for k in ('mean', 'var'))}")
    if not (np.array_equal(counts, pooled_counts) and rm < 1e-5
            and rv < 1e-5 and all(np.array_equal(sh[0][k], s[k])
                                  for s in sh for k in ("mean", "var"))):
        raise AssertionError("sharded HMC is not the pooled rank runs")
    rates = {"sharded_grid10x10_chain_samples_per_s":
             C * S / max(r["off"]["s"] for r in res)}
    for name in ("hmc", "nuts"):
        a = res[0][name]
        log(f"[runtime] sharded {name} with adaptation: step {a['step']:.6g} "
            f"and inv_mass identical on the ranks {[r[name]['same'] for r in res]}; "
            f"accept {a['acc']:.4f}, mean err mean {a['err'][0]:.4f} max "
            f"{a['err'][1]:.4f}, var rel err mean {a['rel'][0]:.4f} max "
            f"{a['rel'][1]:.4f}, ess_bm min {a['ess_min']:.1f}, divergence "
            f"{a['div']:.3e}")
        if not (all(r[name]["same"] for r in res)
                and all(r[name]["step"] == a["step"] for r in res)
                and 0.6 < a["acc"] <= 1.0 and a["err"][0] < 0.05
                and a["err"][1] < 0.25 and a["rel"][0] < 0.10
                and a["rel"][1] < 0.35 and a["ess_min"] > 100
                and a["div"] < 0.01):
            raise AssertionError(f"sharded {name} off the oracle or the ranks "
                                 "disagree")
    for adaptive in (False, True):
        a = res[0][f"smc_{adaptive}"]
        log(f"[runtime] sharded run_smc, {'adaptive' if adaptive else 'fixed'} "
            f"schedule, {N} particles: log Z {a['lz']:.5f} (exact {log_z}; err "
            f"{abs(a['lz'] - log_z):.4f}), temperatures {a['n_used']}, ranks "
            f"agree {[r[f'smc_{adaptive}']['same'] for r in res]}")
        if not (abs(a["lz"] - log_z) < 0.1 and a["rows"] == N // world
                and all(r[f"smc_{adaptive}"]["same"] for r in res)):
            raise AssertionError("sharded SMC off the exact log Z")
    log(f"[runtime] sharded grid10x10: "
        f"{rates['sharded_grid10x10_chain_samples_per_s']:.6g} "
        f"chain-samples/s over two ranks on one card on {smi}")
    rates.update(check_dryrun([r["dryrun"] for r in res], smi))
    rates.update(check_owed([r["owed"] for r in res], smi))
    return rates, launches


def check_dryrun(res, smi):
    """The parent's checks of ``dryrun_steps`` (every rank's results) →
    rates: the VI step on the sharded factor rows takes the unsharded
    step (the ELBO at rtol 1e-5, the same parameters on every rank), and
    every dp-sharded step ends finite."""
    import math

    a = res[0]
    vi = a["vi"]
    log(f"[dryrun] tp-sharded VI Adam step on friends_smokers(6) over "
        f"{len(res)} ranks: loss {vi['loss']:.6g} (unsharded "
        f"{vi['loss_whole']:.6g}), parameters against the unsharded step "
        f"{vi['param_diff']:.3e} of their scale, identical on the ranks "
        f"{[r['vi']['same'] for r in res]}")
    if not (math.isfinite(vi["loss"])
            and abs(vi["loss"] - vi["loss_whole"]) <= 1e-5 * abs(
                vi["loss_whole"]) and vi["param_diff"] < 1e-4
            and all(r["vi"]["same"] for r in res)):
        raise AssertionError("the tp-sharded VI step is not the unsharded one")
    log(f"[dryrun] dp-sharded SMC, NUTS and HMC steps finite "
        f"{[r['dp'] for r in res]}; pod path with the mode-swap move: plan "
        f"{a['pod']['plan']}, mode_swap_accept {a['pod']['ms_accept']:.4f}, "
        f"rhat_disc over {a['pod']['n_rhat_disc']} latents, finite "
        f"{[r['pod']['finite'] for r in res]}; banded route (DIA "
        f"{a['banded']['dia']}) finite with dia_kernel True "
        f"{[r['banded'][True] for r in res]} and False "
        f"{[r['banded'][False] for r in res]}")
    if not all(r["dp"] and r["pod"]["plan"] and r["pod"]["finite"]
               and r["pod"]["n_rhat_disc"] > 0 and r["banded"]["dia"]
               and r["banded"][True] and r["banded"][False] for r in res):
        raise AssertionError("a dp-sharded dry-run step failed")
    vr = a["vi_rate"]
    log(f"[dryrun] VI steps/s on friends_smokers(40) grounded "
        f"({vr['n_rows']} factor rows), K=4, n_quad=7: tp-sharded over "
        f"{len(res)} ranks on one card {vr['tp'][0]:.6g}, unsharded "
        f"{vr['whole'][0]:.6g} (last ELBO {vr['tp'][1]:.6g} and "
        f"{vr['whole'][1]:.6g}) on {smi}")
    if abs(vr["tp"][1] - vr["whole"][1]) > 1e-4 * abs(vr["whole"][1]):
        raise AssertionError("tp-sharded and unsharded VI fits diverged")
    return {"vi_tp_steps_per_s": vr["tp"][0],
            "vi_untp_steps_per_s": vr["whole"][0]}


def check_owed(res, smi, C=1024, S=20, C_robot=16384, S_robot=20):
    """The parent's checks of ``owed_checks`` → rates. Every sharded run
    launched its kernel on each rank and equals the pooled rank runs
    (``pooled_diff``: counts exactly, moments within 1e-5); the ranks'
    first banded proposals from one start differ in every row, their K2
    seeds differ; ``hybrid_chain`` sharded through K5 meets
    ``phase_robot``'s closed-form bounds."""
    for name, kernel in (("k2", "K2"), ("hybrid", "K5"), ("robot", "K5")):
        per = [r[name][kernel.lower()] for r in res]
        eq, dm, dv = pooled_diff(res[0][name]["sharded"],
                                 [r[name]["local"] for r in res])
        agree = all((res[0][name]["sharded"][k] == r[name]["sharded"][k]).all()
                    for r in res for k in ("mean", "var"))
        log(f"[owed] sharded {name} against the pooled rank runs: {kernel} "
            f"launches per rank {per}, counts equal {eq}, mean diff {dm:.3e}, "
            f"var diff {dv:.3e} (1e-5), ranks agree {agree}")
        if not (min(per) > 0 and eq and dm < 1e-5 and dv < 1e-5 and agree):
            raise AssertionError(f"sharded {name} is not the pooled rank runs")
    k2 = [r["k2"] for r in res]
    log(f"[owed] banded proposal from one start on {len(res)} ranks: rows "
        f"equal across ranks {k2[0]['rows_equal']} of {k2[0]['rows']}; K2 "
        f"seeds {[hex(r['seed']) for r in k2]}")
    if not (k2[0]["rows_equal"] == 0 and len({r["seed"] for r in k2})
            == len(k2) and all(r["finite"] for r in k2)):
        raise AssertionError("ranks drew the same banded momenta")
    e = res[0]["hybrid"]["exact"]
    log(f"[owed] sharded hybrid_chain through K5 (K5 launches {e['k5']}, "
        f"step {e['step']:.4g}): P(d=1) {e['pd']:.4f} (0.7), E[x1] "
        f"{e['x1']:.4f} (0.3333), E[x2] {e['x2']:.4f} (0.2667)")
    if not (e["k5"] > 0 and abs(e["pd"] - 0.7) < 0.01
            and abs(e["x1"] - 1 / 3) < 0.02 and abs(e["x2"] - 4 / 15) < 0.02):
        raise AssertionError("sharded hybrid_chain off its closed forms")
    rates = {"sharded_grid128x128_chain_samples_per_s":
             C * S / max(r["k2"]["s"] for r in res),
             "sharded_robot100_chain_samples_per_s":
             C_robot * S_robot / max(r["robot"]["s"] for r in res)}
    for k, v in rates.items():
        log(f"[owed] {k} {v:.6g} over two ranks on one card on {smi}")
    return rates


# the bounds of the reference's own tests on hybrid_chain (tests/test_vi.py,
# test_lbp.py, test_epbp.py, test_hmc.py, test_nuts_map.py, test_smc.py),
# each held at the largest budget the comparison ran the engine
COMPARISON_BOUNDS = {"vi": 0.15, "lbp": 0.1, "epbp": 0.22, "hmc": 0.08,
                     "nuts": 0.1, "smc": 0.1}


def phase_comparison(smi, extra=()):
    """``examples/torch_run_engine_comparison.py --model chain --quick`` on
    the card (its table printed) and the ladders, three processes at once
    (so each one's ``wall_s`` shares the host with the others): the quick
    run, the full ladders of VI, LBP, EPBP and SMC, and HMC's and NUTS's up
    to 150 samples. Every engine's mean error at the largest budget it ran
    stays within its bound (``COMPARISON_BOUNDS``): one rung is too few for
    VI (10 Adam steps) and LBP (1 iteration), in the reference's script as
    in the port's."""
    import json as _json
    import os
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "examples", "torch_run_engine_comparison.py")
    runs = [("quick", ["--quick"]),
            ("ladders vi,lbp,epbp,smc", ["--engines", "vi,lbp,epbp,smc"]),
            ("ladders hmc,nuts to 150", ["--engines", "hmc,nuts",
                                         "--max-budget", "150"])]
    best = {}
    procs = []
    t0 = time.perf_counter()
    for label, args in runs:
        fd, path = tempfile.mkstemp(suffix=".jsonl")
        os.close(fd)
        procs.append((label, path, subprocess.Popen(
            [sys.executable, script, "--model", "chain", "--metrics",
             path] + args + list(extra),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        outs = [p.communicate(timeout=600) for _, _, p in procs]
    finally:  # every process this phase started is stopped
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (label, path, p), (out, err) in zip(procs, outs):
        with open(path) as fh:
            recs = [_json.loads(line) for line in fh]
        os.remove(path)
        if p.returncode != 0:
            raise AssertionError(f"engine comparison ({label}) exited "
                                 f"{p.returncode}:\n{err[-3000:]}")
        errors = [x for x in recs if x["event"] == "error"]
        if errors:
            raise AssertionError(f"engine comparison ({label}): {errors}")
        log(f"[runtime] engine comparison --model chain ({label}; "
            f"{len(runs)} processes at once, "
            f"{time.perf_counter() - t0:.1f} s on {smi}):")
        for line in out[out.rindex("engine  budget"):].rstrip().splitlines():
            log(f"[runtime]   {line}")
        for x in recs:
            if x["event"] == "point" and x["budget"] >= best.get(
                    x["engine"], {"budget": -1})["budget"]:
                best[x["engine"]] = x
    bad = {e: (x["budget"], x["mean_err_avg"]) for e, x in best.items()
           if not x["mean_err_avg"] < COMPARISON_BOUNDS[e]}
    log("[runtime] comparison at each engine's largest budget: " + ", ".join(
        f"{e} {x['mean_err_avg']} at {x['budget']} (< "
        f"{COMPARISON_BOUNDS[e]})" for e, x in best.items()))
    if bad or set(best) != set(COMPARISON_BOUNDS):
        raise AssertionError(f"engine comparison out of bounds: {bad}")


def run_scripts(runs, timeout=900):
    """Start every ``(label, argv)`` of ``runs`` at once (each writes JSONL
    records to the path after its ``--metrics-path``), wait for all, stop
    any left → ``{label: (its own seconds, records, output)}``; a non-zero
    exit fails."""
    import json as _json
    import os
    import tempfile

    procs = []
    out = {}
    try:
        t0 = time.perf_counter()
        for label, argv in runs:
            fh = tempfile.TemporaryFile(mode="w+")
            procs.append((label, argv, fh, subprocess.Popen(
                argv, stdout=fh, stderr=subprocess.STDOUT, text=True)))
        done = {}
        while len(done) < len(procs):
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"scripts still running after {timeout} "
                                     f"s: {[p[0] for p in procs if p[0] not in done]}")
            for label, _, _, p in procs:
                if label not in done and p.poll() is not None:
                    done[label] = time.perf_counter() - t0
            time.sleep(0.2)
        for label, argv, fh, p in procs:
            fh.seek(0)
            text = fh.read()
            if p.returncode != 0:
                raise AssertionError(f"{label} exited {p.returncode}:\n"
                                     f"{text[-3000:]}")
            path = argv[argv.index("--metrics-path") + 1]
            with open(path) as rec:
                out[label] = (done[label], [_json.loads(line) for line in rec],
                              text)
            os.remove(path)
    finally:  # every process this phase started is stopped
        for _, _, fh, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            fh.close()
    return out


def pod_example_args(n_people=320, C=128):
    """``examples/torch_run_pod_scale.py``'s arguments on the card: the
    320-person model at full width (``--fast``), the depth cut to 200
    lifted VI steps (of 2,000), a warm and two timed runs of 4 samples a
    probe, 4 warmup + 8 samples of production run (of 500 + 1,000) in
    chunks of 4."""
    return ["--fast", "--n-people", str(n_people), "--n-chains", str(C),
            "--vi-iters", "200", "--n-warmup", "4", "--n-samples", "8",
            "--chunk", "4"]


def check_pod_example(label, dt, recs, smi):
    """The pod-scale example's JSONL records → rates: the lifted VI's
    cancer marginals within 0.01 of σ(1.2) and 1/2 (``cancer_errors``'
    bound), the HMC's within 5 standard errors of its draws, finite
    streamed R̂ and ``rhat_disc`` (and, where the production run ran, its
    R̂, ``rhat_disc`` and mode-swap acceptance); the two-rank ``scaling``
    figure printed as what it is on one card, time-slicing."""
    import math

    by = {}
    for r in recs:
        by.setdefault(r["event"], []).append(r)
    q = {(r["method"], r["rv"]): r for r in by["query"]}
    vi_err = [abs(q[("lifted_vi", f"cancer({who})")]["marginal"][1] - want)
              for who, want in (("p1", SIGMA_1_2), ("p0", 0.5))]
    z = []
    for who, want in (("p1", SIGMA_1_2), ("p0", 0.5)):
        r = q[("hmc", f"cancer({who})")]
        se = math.sqrt(want * (1 - want) / r["n_draws"])
        z.append(abs(r["marginal"][1] - want) / se)
    conv = by["convergence"]
    tput = {r["config"]: r["samples_per_s"] for r in by["throughput"]}
    fin = [c["rhat_max"] for c in conv] + [c["rhat_disc_max"] for c in conv]
    prod = by.get("production_run", [None])[0]
    if prod is not None:
        fin += [prod["rhat_max"], prod["rhat_disc_max"],
                prod["mode_swap_accept"]]
    log(f"[pod_scale_example] {label}: {dt:.1f} s; fast_compile "
        f"{by['fast_compile'][0]['n_cont']} + {by['fast_compile'][0]['n_disc']}"
        f" latents; lifted VI cancer err {vi_err[0]:.4f} / {vi_err[1]:.4f} "
        f"(bound 0.01); HMC cancer {z[0]:.2f} / {z[1]:.2f} SE (bound 5); "
        f"chain-samples/s {tput}; convergence "
        f"{[(c['config'], c['rhat_max'], c['rhat_disc_max']) for c in conv]}"
        + ("" if prod is None else
           f"; production run {prod['wall_s']} s, rhat_max "
           f"{prod['rhat_max']}, rhat_disc_max {prod['rhat_disc_max']}, "
           f"mode_swap_accept {prod['mode_swap_accept']}") + f" on {smi}")
    if not (max(vi_err) < 0.01 and max(z) < 5 and all(
            v is not None and math.isfinite(v) for v in fin)
            and (prod is None or by["checkpoint"])):
        raise AssertionError(f"pod-scale example ({label}) off")
    if "scaling" in by:
        s = by["scaling"][0]
        log(f"[pod_scale_example] two ranks time-slicing one card (not "
            f"scaling): throughput ratio against one rank {s['efficiency']} "
            f"({s['devices']} ranks, {s['cards']} card)")
    tag = label.split()[0]
    return {f"pod_example_{tag}_{config}_chain_samples_per_s": v
            for config, v in tput.items()}


def phase_pod_scale_example(smi, extra=()):
    """``examples/torch_run_pod_scale.py`` on the card as two ranks on
    ``cuda:0`` under ``torch.distributed.run`` (gloo: NCCL takes one rank
    a card), alone on the card (``pod_example_args``): the chains sharded
    over the ranks, the one-rank probe (rank 0 alone, the other rank
    waiting), the production run through ``sample_checkpointed(shard=…)``
    and the VI checkpoint; checked by ``check_pod_example``. The
    one-process run is in ``phase_examples``."""
    import os
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="lhvi_pod_")
    label = "two ranks"
    try:
        res = run_scripts([(label, [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2",
            os.path.join(here, "examples", "torch_run_pod_scale.py"),
            "--distributed"] + pod_example_args() + list(extra) + [
            "--metrics-path", os.path.join(tmp, "two.jsonl"),
            "--checkpoint-dir", os.path.join(tmp, "ckpt")])])
        dt, recs, _ = res[label]
        return check_pod_example(label, dt, recs, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def example_checks():
    """Each example's arguments and check at its default config: the
    bound of the reference test of its engine (``COMPARISON_BOUNDS`` on
    ``hybrid_chain``; tests/test_nuts_map.py:32-41 and 59-69,
    tests/test_smc.py:30-44 and 65, tests/test_models_extra.py:16-27),
    the friends-smokers closed form at ``cancer_errors``' bound →
    ``{script: (argv, what, check(records))}``. One depth is cut: the
    image-denoising script's NUTS to 50 warmup + 100 samples of its 500 +
    1,000 (its 16×16 grid and 32 chains kept; the whole default run took
    753 s on an NVIDIA H100, PERF.md §4)."""
    b = COMPARISON_BOUNDS
    return {
        "torch_run_hybrid_chain": (
            [], f"NUTS E[x] err < {b['nuts']}, P(d) err < 0.06",
            lambda r: r[0]["mean_err_max"] < b["nuts"]
            and r[0]["disc_err_max"] < 0.06),
        "torch_run_gaussian_grid": (
            [], f"NUTS mean err avg < {b['nuts']}",
            lambda r: r[0]["mean_err_avg"] < b["nuts"]),
        "torch_run_friends_smokers": (
            [], "lifted VI P(cancer(p0)) within 0.01 of σ(1.2)",
            lambda r: r[0]["cancer_err"] < 0.01),
        "torch_run_lds_smc": (
            [], f"SMC mean err avg < {b['smc']}, max < 0.3, log Z err < 0.5",
            lambda r: r[0]["mean_err_avg"] < b["smc"]
            and r[0]["mean_err_max"] < 0.3 and r[0]["log_z_err"] < 0.5),
        "torch_run_image_denoise": (
            ["--n-warmup", "50", "--n-samples", "100"],
            "NUTS denoised MSE < 0.6 x observed",
            lambda r: r[0]["mse_est"] < 0.6 * r[0]["mse_obs"]),
        "torch_run_robot_map": (
            [], f"VI misclassified share < {b['vi']}",
            lambda r: 1 - r[0]["correct"] / r[0]["n_unlabeled"] < b["vi"]),
        "torch_demo": (
            [], "each engine's errors within its COMPARISON_BOUNDS; MaxWalkSAT "
            "d* exact, x1* within 0.15",
            lambda r: all(max(x["mean_err_max"], x["disc_err_max"])
                          < b[x["engine"]] for x in r[:-1])
            and r[-1]["map_d_equal"] and r[-1]["map_x1_err"] < 0.15),
    }


def phase_examples(smi, extra=()):
    """The port's example scripts (``examples/torch_*.py`` other than the
    comparison) on the card at their default configs (one depth cut,
    ``example_checks``), all at once (each one's wall time shares the
    host and the card with the others): each held to ``example_checks``,
    and the pod-scale one, as one process at ``pod_example_args``, to
    ``check_pod_example``."""
    import os
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="lhvi_examples_")
    checks = example_checks()
    pod = "one process"
    try:
        res = run_scripts([(name, [
            sys.executable, os.path.join(here, "examples", f"{name}.py"),
            "--metrics-path", os.path.join(tmp, f"{name}.jsonl")] + argv
            + list(extra)) for name, (argv, _, _) in checks.items()] + [
            (pod, [sys.executable,
                   os.path.join(here, "examples", "torch_run_pod_scale.py"),
                   "--metrics-path", os.path.join(tmp, "pod.jsonl")]
             + pod_example_args() + list(extra))])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rates = check_pod_example(pod + " (with the other scripts at once)",
                              res[pod][0], res[pod][1], smi)
    bad = []
    for name, (_, what, check) in checks.items():
        dt, recs, _ = res[name]
        recs = [r for r in recs if r["event"] == "result"]
        ok = check(recs)
        fields = [{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items() if k not in ("t", "event")}
                  for r in recs]
        log(f"[examples] {name}: process {dt:.1f} s; {fields}; check "
            f"({what}) {ok} on {smi}")
        rates[f"example_{name}_s"] = dt
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"examples out of bounds: {bad}")
    return rates


def phase_runtime(dev, smi):
    """Resumable sampling on the card (K1, K2, K3, K5), the two-rank path
    (K1 to K5 on each rank) and the engine comparison."""
    from lhvi_tpu_torch.utils.metrics import count

    t0 = time.perf_counter()
    rates = phase_resume(dev, smi)
    log(f"[time] runtime: resume {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r, launches = check_ranks(spawn_ranks(()), smi)
    rates.update(r)
    # the ranks' launches are this path's: fold them into the counts
    for k, c in RANK_KERNELS.items():
        count(f"ops.{c}.launches", sum(launches[k]))
    log(f"[time] runtime: two ranks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_comparison(smi)
    log(f"[time] runtime: comparison {time.perf_counter() - t0:.1f} s")
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


def profile_window(label, run, units, unit, smi):
    """One ``run()`` under ``torch.profiler`` after a warm call, and three
    unprofiled ones: kernels per unit, device idle share (1 − summed
    device time / host wall time of the profiled run; one stream, so
    kernels do not overlap) and the largest kernels' shares of the device
    time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    dt, spread = timed_runs(lambda seed: run())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        # a user annotation (torch.optim's "Optimizer.step#...") spans the
        # kernels it launched on the device timeline: not a device op
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    busy = sum(t for _, t in by_name.values())
    count = sum(c for c, _ in by_name.values())
    if busy <= 0:
        log(f"[profile] {label}: the profiler recorded no device time")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"[profile] {label}: unprofiled {dt / units * 1e3:.4f} ms per {unit} "
        f"(rep spread {spread:.3f}); profiled {wall_us / units / 1e3:.4f} ms "
        f"per {unit}, device busy {busy / units / 1e3:.4f} ms per {unit}, "
        f"device idle {1 - busy / wall_us:.4f}, {count / units:.2f} device "
        f"operations per {unit}; on {smi}")
    for name, (c, t) in top:
        log(f"[profile]   {t / busy:.4f} of device time, {c / units:.2f} per "
            f"{unit}, {t / c / 1e3:.4f} ms each: {name[:110]}")


def profile_cells(dev, smi):
    """``--profile``: the ``grid10x10`` HMC cell (65,536 chains, 20
    transitions, K1), the ``nuts10x10`` cell (65,536 chains, max_depth 4,
    20 transitions, K3), the ``grid128x128`` HMC cell (1,024 chains, 20
    transitions, K2), the ``smc_denoise11`` fused cell (16,384
    particles, a fixed schedule of 50 temperatures, K5), all with
    streamed diagnostics off, and the ``vi10x10`` and ``vi_lifted320``
    cells (200 Adam steps of ``fit``), as PERF.md §5 reads them."""
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, nuts, smc
    from lhvi_tpu_torch.models.toy import gaussian_grid

    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg10 = compile_graph(g, dev)
    hcfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.12)
    ncfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.12, adapt_mass=False)

    def grid10():
        m, _, _ = hmc.run_hmc(fg10, torch.Generator(dev).manual_seed(0), hcfg,
                              n_chains=65536, n_warmup=0, n_samples=20,
                              collect="moments", stream_diag=False)
        float(m["mean"][0])

    def nuts10():
        m, _, _ = nuts.run_nuts(fg10, torch.Generator(dev).manual_seed(0),
                                ncfg, n_chains=65536, n_warmup=0,
                                n_samples=20, collect="moments",
                                stream_diag=False)
        float(m["mean"][0])

    profile_window("grid10x10 HMC, 65,536 chains x 20 samples", grid10, 20,
                   "transition", smi)
    profile_window("nuts10x10, 65,536 chains x 20 samples, max_depth 4",
                   nuts10, 20, "transition", smi)
    g, _ = gaussian_grid(128, 128, seed=1, evidence_frac=0.05)
    fg = compile_graph(g, dev, quad_max_n=4096)
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.05)

    def grid():
        m, _, _ = hmc.run_hmc(fg, torch.Generator(dev).manual_seed(0), cfg,
                              n_chains=1024, n_warmup=0, n_samples=20,
                              collect="moments", stream_diag=False)
        float(m["mean"][0])

    profile_window("grid128x128 HMC, 1,024 chains x 20 samples", grid, 20,
                   "transition", smi)
    fgd = denoise_fg(dev)
    scfg = smc.SMCConfig(n_particles=16384, n_temps=50, adaptive=False,
                         fused_logpot=True)

    def denoise():
        float(smc.sample(fgd, torch.Generator(dev).manual_seed(0), scfg).log_z)

    profile_window("smc_denoise11 fused, 16,384 particles, 50 temperatures",
                   denoise, 50, "temperature", smi)
    from lhvi_tpu_torch.engines import vi
    from lhvi_tpu_torch.lift import compile_lifted

    fg_l = compile_lifted(friends_model(320, 32).ground()[0], dev)
    for label, fg, cfg in (("vi10x10, K=8", fg10, vi.VIConfig(K=8, n_iters=200)),
                           ("vi_lifted320, K=4", fg_l,
                            vi.VIConfig(K=4, n_iters=200))):
        run, _ = vi_fit_run(vi, fg, cfg, dev)
        profile_window(f"{label}, {cfg.n_iters} Adam steps",
                       lambda: run(0), cfg.n_iters, "step", smi)
    profile_pod_cells(dev, smi)
    step_costs(dev, smi)


def profile_pod_cells(dev, smi, cells=((320, 128, 8, False),
                                       (320, 128, 8, True),
                                       (1000, 8, 1, False))):
    """``--profile`` (alone: ``--profile pod``): the pod cells as the
    main path runs them, mode swap off and on (``pod320``,
    ``pod320_modeswap`` every transition: 128 chains × 8 samples) and
    ``pod1000`` (8 chains, one sample), as PERF.md §5 reads them."""
    import torch

    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.relational.fast import fast_compile

    for n_people, C, S, swap in cells:
        fg = fast_compile(friends_model(n_people, n_people // 10), dev)
        cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1, mode_swap=swap)

        def run():
            m, _, _ = hmc.run_hmc(fg, torch.Generator(dev).manual_seed(0),
                                  cfg, n_chains=C, n_warmup=0, n_samples=S,
                                  collect="moments", stream_diag=False)
            float(m["mean"][0])

        profile_window(f"pod{n_people}{'_modeswap' if swap else ''}, {C} "
                       f"chains x {S} samples, {fg.n_colors} colours", run, S,
                       "transition", smi)
        del fg


def step_costs(dev, smi):
    """K1, K2, K3 and K5 alone (their launchers, CUDA-event medians) at
    zero steps (depths) and at the main path's: what a call costs before
    its first step, and what each step adds. K1 at the 10×10 grid, 65,536
    chains, 0 / 1 / 8 steps; K3 there at max_depth 0 / 1 / 4 on the main
    path's route (in-kernel Philox) from the posterior."""
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.ops import dia, leapfrog as lf, logpot
    from lhvi_tpu_torch.ops import nuts_traj as nt

    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg10 = compile_graph(g, dev)
    n10, C10 = fg10.n_cont, 65536
    gen10 = torch.Generator(dev).manual_seed(3)
    xc = posterior_draws(fg10.quad_J, fg10.quad_h, C10, gen10)
    p10 = torch.randn((C10, n10), generator=gen10, device=dev)
    im10 = torch.ones(n10, device=dev)
    eps10 = torch.full((), 0.12, device=dev)
    ms = [time_ms(lambda: lf._cuda_quad_leapfrog(
        xc, p10, fg10.quad_J, fg10.quad_h, im10, eps10, s)) for s in (0, 1, 8)]
    log(f"[profile] K1 alone, 10x10 grid, C={C10}: 0 / 1 / 8 steps "
        f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms; on {smi}")
    ms = [time_ms(lambda: nt._cuda_nuts_traj(
        xc, p10, fg10.quad_J, fg10.quad_h, im10, eps10, d, 12345, 0))
        for d in (0, 1, 4)]
    log(f"[profile] K3 alone (in-kernel Philox), 10x10 grid, C={C10}: "
        f"max_depth 0 / 1 / 4 {ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms; on "
        f"{smi}")

    fg = k6_grid(dev)
    n = fg.n_cont
    gen = torch.Generator(dev).manual_seed(0)
    im = 0.5 + torch.rand((n,), generator=gen, device=dev)
    eps = torch.full((), 0.05, device=dev)
    for C in (128, 1024):
        x = torch.randn((C, n), generator=gen, device=dev)
        ms = [time_ms(lambda: dia._cuda_dia_proposal(
            x, fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w, fg.quad_h, im,
            eps, s, 99, 0, inv=fg.quad_dia_inv)) for s in (0, 1, 8)]
        log(f"[profile] K2 alone, 128x128 grid, C={C}: 0 / 1 / 8 steps "
            f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms; on {smi}")
    for name, fgk, C, steps in (("robot100", robot_fg(dev)[0], 16384, 8),
                                ("denoise11x11", denoise_fg(dev), 4096, 5)):
        plan = logpot.kernel_plan(fgk)
        x = fgk.cont_lo + (fgk.cont_hi - fgk.cont_lo) * torch.rand(
            (C, fgk.n_cont), generator=gen, device=dev)
        p = torch.randn((C, fgk.n_cont), generator=gen, device=dev)
        xd = torch.zeros((C, fgk.n_disc), dtype=torch.int64, device=dev)
        imk = torch.ones((fgk.n_cont,), device=dev)
        use_base, b_, mid, is2 = logpot._tempering(fgk, dev, None, None, None)
        dv = plan.disc_values(xd)
        ms = [time_ms(lambda: logpot._cuda_logpot_leapfrog(
            plan, x, p, dv, imk, eps, b_, mid, is2, s, use_base))
            for s in (0, 1, steps)]
        log(f"[profile] K5 alone, {name}, C={C}: 0 / 1 / {steps} steps "
            f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms; on {smi}")
    k4_profile(dev, smi)


def k4_profile(dev, smi, sizes=(1, 4096, 16384, 65536)):
    """K4 at the SMC sizes as ``phase_k4`` times it, then the other cluster
    geometries that cover N, by the kernel's device time."""
    import torch

    from lhvi_tpu_torch.ops import resample as rs

    log(f"[profile] K4 on {smi}")
    for N in sizes:
        k4_timed_line(dev, N, device=True)
        lw = k4_lw(dev, N)
        out = (torch.empty_like(lw), torch.empty_like(lw),
               torch.empty((2,), device=dev))
        sweep = []
        for S in (1, 2, 4, 8, 16):
            for T in rs.K4_BLOCK_THREADS:
                for E in rs.K4_PER_THREAD:
                    if N <= S * T * E < 4 * N:
                        g = rs.K4Launch("cluster", S, T, E, S, 0)
                        sweep.append((k4_device_ms(lw, out, g), g))
        if sweep:
            log(f"[profile] K4 N={N} geometries by device time: " + ", ".join(
                f"{g.cluster}x{g.threads}x{g.per_thread} {t:.4f}"
                for t, g in sorted(sweep, key=lambda x: x[0])[:6]))


def main() -> int:
    import torch

    if "--rank-worker" in sys.argv[1:]:
        i = sys.argv.index("--rank-worker")
        return rank_worker(*map(int, sys.argv[i + 1:i + 4]), sys.argv[i + 4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # the port is imported before anything is printed: outside a checkout
    # the script fails here, with no output on stdout
    import lhvi_tpu_torch  # noqa: F401  (turns TF32 off)
    from lhvi_tpu_torch.ops import _build
    from lhvi_tpu_torch.utils.metrics import reset_tracing

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
    if "--profile" in sys.argv[1:]:
        if sys.argv[-1] == "pod":
            profile_pod_cells(dev, smi)
        else:
            profile_cells(dev, smi)
        return 0
    only = None
    if "--phase" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--phase") + 1].split(",")

    if only is None:
        t0 = time.perf_counter()
        k1 = phase_k1(dev)
        k2 = phase_k2(dev)
        k3 = phase_k3(dev)
        k4 = phase_k4(dev)
        k5 = phase_k5(dev)
        k6 = phase_k6(dev)
        log(f"[time] kernel phases {time.perf_counter() - t0:.1f} s")

    kernel_of = {**RANK_KERNELS, "dia_leapfrog": "k6", "stream_diag": "k7",
                 "moment_sums": "k8"}
    launches = {}
    keep = {}
    # each path: every count set to 0 just before it, read just after
    for path, fn, kernels in (
            # the slice's moments queries stream their diagnostics: K7 and
            # K8 once a kept draw
            ("hmc", lambda: phase_slice(dev, smi),
             ("quad_leapfrog", "dia_proposal", "stream_diag", "moment_sums")),
            ("nuts", lambda: phase_nuts(dev, smi), ("nuts_traj",)),
            ("smc", lambda: keep.update(
                smc_banded64_particle_temps_per_s=phase_smc(dev, smi)[1]),
             ("weights", "dia_proposal")),
            ("robot", lambda: phase_robot(dev, smi, keep),
             ("logpot_leapfrog",)),
            ("dia_leapfrog", lambda: path_dia_leapfrog(dev),
             ("dia_leapfrog",)),
            # K7 and K8 at the grid cells' shapes, checked and timed
            ("moments", lambda: keep.update(moments=phase_moments(dev)),
             ("stream_diag", "moment_sums")),
            # K2's select against the launch and _mh_accept, at the grid
            # cells' shapes, checked and timed
            ("k2_select",
             lambda: keep.update(k2_select=phase_k2_select(dev, smi)),
             ("dia_proposal",)),
            ("hybrid", lambda: phase_hybrid(dev, smi, keep["robot_hmc"]),
             ("weights",)),
            # VI, the pod cells, the mode-swap move and the BP/MAP engines
            # reach no TPU kernel in the reference (SMC with the move
            # launches K4, held on the smc path)
            ("vi", lambda: keep.update(phase_vi(dev, smi)), ()),
            ("pod", lambda: keep.update(phase_pod(dev, smi)), ()),
            ("modeswap", lambda: keep.update(phase_modeswap(dev, smi)), ()),
            ("pod_scale", lambda: keep.update(phase_pod_scale(dev, smi)), ()),
            ("bp", lambda: keep.update(phase_bp(dev, smi)), ()),
            # resumable sampling through K1, K2, K3 and K5; two ranks on
            # the card, each launching K1, K3 and K4 (their counts folded
            # in); the engine comparison
            ("runtime", lambda: keep.update(phase_runtime(dev, smi)),
             ("quad_leapfrog", "dia_proposal", "nuts_traj", "weights",
              "logpot_leapfrog")),
            # the example scripts, each in processes of its own (their
            # launches are not this process's counts)
            ("pod_scale_example",
             lambda: keep.update(phase_pod_scale_example(smi)), ()),
            ("examples", lambda: keep.update(phase_examples(smi)), ())):
        if only is not None and path not in only:
            continue
        reset_tracing()
        t0 = time.perf_counter()
        fn()
        seen = {k: kernel_launches(c) for k, c in kernel_of.items()}
        log(f"[{path}] kernel launches on the path: {seen}; "
            f"{time.perf_counter() - t0:.1f} s")
        for k in kernels:
            if seen[k] <= 0:
                raise AssertionError(f"{k} never ran on the {path} path")
            launches.setdefault(k, seen[k])
    if only is not None:  # a rehearsal of some paths: no result lines
        return 0

    kernels = [
        {"name": "quad_leapfrog", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/quad_leapfrog.cu",
         "replaces": "lhvi_tpu/ops/leapfrog.py:53",
         "launches": launches["quad_leapfrog"], **k1},
        {"name": "dia_proposal", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/dia_proposal.cu",
         "replaces": "lhvi_tpu/ops/dia.py:354",
         "launches": launches["dia_proposal"], **k2,
         "select": keep["k2_select"]},
        {"name": "nuts_traj", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/nuts_traj.cu",
         "replaces": "lhvi_tpu/ops/nuts_traj.py:48",
         "launches": launches["nuts_traj"], **k3},
        {"name": "weights", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/weights.cu",
         "replaces": "lhvi_tpu/ops/resample.py:48",
         "launches": launches["weights"], **k4},
        {"name": "logpot_leapfrog", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/logpot_leapfrog.cu",
         "replaces": "lhvi_tpu/ops/logpot.py:271",
         "launches": launches["logpot_leapfrog"], **k5},
        {"name": "dia_leapfrog", "route": "cuda",
         "source": "lhvi_tpu_torch/ops/csrc/dia_leapfrog.cu",
         "replaces": "lhvi_tpu/ops/dia.py:184",
         "launches": launches["dia_leapfrog"], **k6},
        *({"name": name, "route": "cuda",
           "source": "lhvi_tpu_torch/ops/csrc/moments.cu", "replaces": None,
           "launches": launches[name], "times": rows}
          for name, rows in keep["moments"].items()),
    ]
    for k in ("vi_steps_per_s", "vi_lifted_steps_per_s",
              "pod_gibbs_chain_samples_per_s",
              "pod320_modeswap1_chain_samples_per_s",
              "pod320_modeswap4_chain_samples_per_s", "pod600", "pod1000",
              "gabp10x10", "gabp128", "lbp_hybrid", "epbp_hybrid",
              "epbp10x10", "lbp_lifted320", "mws",
              "resume_grid10x10_chain_samples_per_s",
              "plain_grid10x10_chain_samples_per_s",
              "sharded_grid10x10_chain_samples_per_s",
              "resume_nuts10x10_chain_samples_per_s",
              "plain_nuts10x10_chain_samples_per_s",
              "resume_grid128x128_chain_samples_per_s",
              "plain_grid128x128_chain_samples_per_s",
              "resume_hybrid_chain_fused_chain_samples_per_s",
              "plain_hybrid_chain_fused_chain_samples_per_s",
              "ckpt_grid10x10_bytes", "ckpt_grid10x10_save_s",
              "ckpt_grid128x128_bytes", "ckpt_grid128x128_save_s",
              "smc_banded64_particle_temps_per_s", "vi_tp_steps_per_s",
              "vi_untp_steps_per_s", "sharded_grid128x128_chain_samples_per_s",
              "sharded_robot100_chain_samples_per_s",
              *sorted(k for k in keep if k.startswith(("pod_example_",
                                                        "example_")))):
        log(f"[rates] {k} {keep[k]:.6g} on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
