"""BASELINE config 5 on the PyTorch port: the pod-scale lifted MRF (~1e5
grounded variables), the port's counterpart of
``examples/run_pod_scale.py``. Runs on the card unless given --cpu.

The production path end to end:
  1. ground a ~1e5-variable hybrid relational model (partial evidence
     breaks full exchangeability), with ``--fast`` straight to the tensor
     IR (``relational/fast.py::fast_compile``);
  2. colour refinement → lifted VI (orbit-tied parameters);
  3. grounded HMC-within-Gibbs with the chains sharded over the ranks of
     the process group, streamed moments and convergence diagnostics, JSONL
     metrics;
  4. a scaling harness: chain-samples/s of one rank against all ranks;
  5. a checkpointed production run (``engines/resumable.py``) and the VI
     parameters saved with ``CheckpointManager`` (``--checkpoint-dir``).

Several processes: launch one per rank with ``torchrun`` and pass
``--distributed`` (``parallel.init_distributed`` reads torchrun's
environment); ``--n-chains`` counts the chains of all ranks.

    python examples/torch_run_pod_scale.py --cpu --n-people 120   # smoke test
    python examples/torch_run_pod_scale.py --n-people 320 --fast
    torchrun --nproc-per-node 2 examples/torch_run_pod_scale.py --fast \\
        --distributed --checkpoint-dir /tmp/pod_ckpt
"""

import dataclasses
import time

import numpy as np

from torch_common import device_of, make_parser, sync
from lhvi_tpu_torch.config import PodConfig, from_args


def _rounded(v, nd):
    return round(float(v), nd) if np.isfinite(v) else None


def main():
    parser = make_parser(PodConfig(), __doc__)
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group that torchrun "
                        "describes and shard the chains over its ranks")
    parser.add_argument("--chunk", type=int, default=4,
                        help="samples per run of the throughput probes and "
                        "per checkpointed chunk of the production run (the "
                        "streamed split-R-hat needs at least 4 draws)")
    parser.add_argument("--mode-swap", type=lambda s: s.lower() in
                        ("1", "true", "yes"), default=True,
                        help="collapsed orbit-flip MH move after each "
                        "Gibbs sweep (engines/modeswap.py); without it the "
                        "ferromagnetic smokes clique freezes per chain and "
                        "rhat_disc saturates")
    parser.add_argument("--mode-swap-every", type=int, default=1,
                        help="apply the mode-swap move with probability "
                        "1/k per transition (a random-scan mixture, still "
                        "exact), amortizing its two conditional-logit "
                        "passes")
    parser.add_argument("--fast", action="store_true",
                        help="ground via the vectorized relational→IR "
                        "compiler (relational/fast.py), with no per-ground "
                        "Python objects; lifted VI runs on the IR-level "
                        "orbit refinement (lift/fast.py). Needed in "
                        "practice beyond ~3e5 groundings.")
    args = parser.parse_args()
    cfg = from_args(PodConfig, args)
    dev = device_of(args)

    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.engines import hmc, vi
    from lhvi_tpu_torch.lift import compile_lifted, lifting_report
    from lhvi_tpu_torch.models.relational import friends_smokers
    from lhvi_tpu_torch.utils.metrics import MetricsLogger

    shard = None
    if args.distributed:
        from lhvi_tpu_torch.parallel import init_distributed

        shard = init_distributed("gloo" if dev == "cpu" else None)
    rank0 = shard is None or shard.rank == 0
    # one record per event: rank 0 writes (every rank holds the same
    # moments and diagnostics)
    log = MetricsLogger(cfg.metrics_path if rank0 else None, echo=rank0)

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    # ---- 1. ground --------------------------------------------------------
    t0 = time.perf_counter()
    rg = friends_smokers(n_people=cfg.n_people, hybrid=True)
    for i in range(cfg.evidence_people):
        rg.observe("smokes", (f"p{i}",), i % 2)

    vi_cfg = vi.VIConfig(K=cfg.vi_k, n_iters=cfg.vi_iters, lr=cfg.vi_lr)
    if args.fast:
        # vectorized relational→IR path: templates ground straight to
        # tensor buckets; engines are queried by (pred, consts) keys
        from lhvi_tpu_torch.fg.compile import color_plan_bytes
        from lhvi_tpu_torch.lift.fast import fast_lift
        from lhvi_tpu_torch.relational.fast import fast_compile

        fg = fast_compile(rg, dev)
        log.log("fast_compile", wall_s=round(time.perf_counter() - t0, 2),
                n_cont=fg.n_cont, n_disc=fg.n_disc,
                plan_mb=round(color_plan_bytes(fg)["total_bytes"] / 1e6, 1))

        # ---- 2. lifted VI on the IR-level orbits ---------------------------
        t0 = time.perf_counter()
        fg_l = fast_lift(fg)
        log.log("fast_lift", n_rv_orbits=fg_l.n_cont + fg_l.n_disc,
                n_factor_orbits=int(sum(
                    (b["scale"] > 0).sum() for b in fg_l.meta.np_buckets)),
                wall_s=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        res_vi = vi.infer(fg_l, gen(cfg.seed), vi_cfg)
        log.log("lifted_vi", elbo=float(res_vi.trace[-1]),
                wall_s=round(time.perf_counter() - t0, 2))
        # queries by (pred, consts) key resolve through the orbit map
        for who in ("p1", "p0"):
            log.log("query", rv=f"cancer({who})", method="lifted_vi",
                    marginal=res_vi.disc_marginal(
                        ("cancer", (who,))).round(4))
    else:
        g, index = rg.ground()
        log.log("ground", n_rvs=len(g.rvs), n_factors=len(g.factors),
                wall_s=round(time.perf_counter() - t0, 2))

        # ---- 2. lifted VI -------------------------------------------------
        t0 = time.perf_counter()
        rep = lifting_report(g)
        fg_l = compile_lifted(g, dev)
        log.log("lift", **rep, wall_s=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        res_vi = vi.infer(fg_l, gen(cfg.seed), vi_cfg)
        log.log("lifted_vi", elbo=float(res_vi.trace[-1]),
                wall_s=round(time.perf_counter() - t0, 2))
        # p1 observes smokes=1 (evidence is i%2), so cancer(p1) = σ(1.2)
        # ≈ 0.77; p0 observes smokes=0, leaving cancer(p0) at 0.5
        for who in ("p1", "p0"):
            rv = index[("cancer", (who,))]
            log.log("query", rv=f"cancer({who})", method="lifted_vi",
                    marginal=res_vi.disc_marginal(rv).round(4))
        t0 = time.perf_counter()
        fg = compile_graph(g, dev)
        log.log("compile_grounded", wall_s=round(time.perf_counter() - t0, 2),
                n_cont=fg.n_cont, n_disc=fg.n_disc)
    vi_params_host = res_vi.params  # numpy copies (VIResult)
    del res_vi, fg_l

    # ---- 3. grounded sharded HMC-within-Gibbs -----------------------------
    # gibbs_max_colors=0: the compile-time per-colour plan, full exact
    # chromatic sweeps at O(Σ deg) kernel-row cost per sweep
    hcfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1,
                         mode_swap=args.mode_swap,
                         mode_swap_every=args.mode_swap_every)
    if args.mode_swap:
        # build and attach the orbit plan once (refine_ir costs seconds at
        # pod scale), and log what the move will flip
        from lhvi_tpu_torch.engines.modeswap import plan_for

        t0 = time.perf_counter()
        plan = plan_for(fg)
        if plan is not None:
            fg = dataclasses.replace(fg, mode_swap_plan=plan)
            log.log("mode_swap_plan", n_groups=plan.n_groups,
                    group_width=plan.n_vars,
                    wall_s=round(time.perf_counter() - t0, 2))
        else:
            log.log("mode_swap_plan", n_groups=0)

    def measure(shard_, n_chains, tag):
        """A warm run, then two timed runs of ``--chunk`` samples each
        (the clock waits on the device at both ends)."""
        kw = dict(n_chains=n_chains, n_warmup=0, n_samples=args.chunk,
                  collect="moments", shard=shard_)
        out = hmc.run_hmc(fg, gen(0), hcfg, **kw)
        float(out[0]["mean"][0])
        sync(dev)
        t0 = time.perf_counter()
        n_chunks = 2
        for rep in range(n_chunks):
            out = hmc.run_hmc(fg, gen(1 + rep), hcfg, **kw)
            float(out[0]["mean"][0])
        dt = time.perf_counter() - t0
        sps = n_chains * args.chunk * n_chunks / dt
        log.log("throughput", config=tag, chains=n_chains,
                samples_per_s=round(sps, 1), wall_s=round(dt, 2))
        # streamed convergence evidence of the last run (split-R̂ needs
        # at least 4 draws a run)
        diag = out[2]
        rhat = diag["rhat"].cpu().numpy()
        if np.isfinite(rhat).any():
            rhat_d = diag["rhat_disc"].cpu().numpy()
            ok_d = np.isfinite(rhat_d).any()
            log.log("convergence", config=tag,
                    rhat_max=round(float(np.nanmax(rhat)), 4),
                    ess_proxy_min=round(float(np.nanmin(
                        diag["ess_proxy"].cpu().numpy())), 1),
                    # discrete-value split-R̂ over the colour-stratified
                    # monitored subset. The max saturates on any variable
                    # frozen at chain-specific values; the share above 1.1
                    # is the readable mode-locking measure
                    rhat_disc_max=(round(float(np.nanmax(rhat_d)), 4)
                                   if ok_d else None),
                    rhat_disc_frac_gt_1p1=(
                        round(float(np.mean(rhat_d > 1.1)), 4)
                        if ok_d else None),
                    n_disc_monitored=int(diag["disc_diag_idx"].numel()),
                    accept=round(float(diag["accept_rate"]), 3))
        return sps, out

    n_ranks = 1 if shard is None else shard.world
    sps_full, out_full = measure(shard, cfg.n_chains, f"{n_ranks}rank")
    if args.fast:
        # posterior queries straight from the streamed moments;
        # fast_compile grounds no RV objects, so queries are keys
        probs = out_full[0]["disc_probs"].cpu().numpy()
        for who in ("p1", "p0"):
            _, i = fg.meta.loc(("cancer", (who,)))
            log.log("query", rv=f"cancer({who})", method="hmc",
                    n_draws=int(out_full[0]["n_obs"]),
                    marginal=probs[i, :2].round(4))

    # ---- 4. one rank against all ranks ------------------------------------
    if n_ranks > 1:
        import torch.distributed as dist

        if rank0:  # the other ranks wait at the barrier meanwhile
            sps_1, _ = measure(None, cfg.n_chains // n_ranks, "1rank")
            eff = sps_full / (sps_1 * n_ranks)
            n_cards = (torch.cuda.device_count() if dev == "cuda" else 0)
            log.log("scaling", devices=n_ranks, efficiency=round(eff, 3),
                    # ranks on fewer cards than ranks time-slice the cards
                    cards=n_cards)
        dist.barrier(group=shard.group)

    # ---- 5. production run: checkpointed chunks, full-run convergence -----
    # the resumable payload makes the run preemption-safe, and the
    # streamed split-R̂/ESS accumulate across chunks, so the convergence
    # evidence covers every draw
    if cfg.checkpoint_dir:
        from lhvi_tpu_torch.engines.resumable import sample_checkpointed

        t0 = time.perf_counter()
        res = sample_checkpointed(
            fg, gen(cfg.seed + 1), cfg=hcfg, engine="hmc",
            n_chains=cfg.n_chains, n_warmup=cfg.n_warmup,
            n_samples=cfg.n_samples, chunk_size=args.chunk,
            ckpt_dir=cfg.checkpoint_dir + "/hmc", shard=shard,
        )
        rhat = np.asarray(res.diag["rhat"])
        ess = np.asarray(res.diag["ess_proxy"])
        rhat_d = np.asarray(res.diag.get("rhat_disc", np.nan))
        ess_bm = np.asarray(res.diag.get("ess_bm", np.nan))
        # fewer than 4 samples give an all-NaN R̂ (the split needs two
        # draws a half): report None, never NaN
        has_rhat = rhat.size and bool(np.isfinite(rhat).any())
        log.log(
            "production_run",
            n_samples=cfg.n_samples, chunk=args.chunk,
            wall_s=round(time.perf_counter() - t0, 2),
            accept=round(float(res.diag["accept_rate"]), 3),
            rhat_max=(round(float(np.nanmax(rhat)), 4) if has_rhat
                      else None),
            ess_proxy_min=(round(float(np.nanmin(ess)), 1)
                           if has_rhat and np.isfinite(ess).any()
                           else None),
            rhat_disc_max=(round(float(np.nanmax(rhat_d)), 4)
                           if np.isfinite(rhat_d).any() else None),
            rhat_disc_frac_gt_1p1=(
                round(float(np.mean(rhat_d > 1.1)), 4)
                if np.isfinite(rhat_d).any() else None),
            n_disc_monitored=int(
                np.asarray(res.diag.get("disc_diag_idx", [])).size),
            ess_bm_min=(round(float(np.nanmin(ess_bm)), 1)
                        if np.isfinite(ess_bm).any() else None),
            mode_swap_accept=(
                _rounded(res.diag["mode_swap_accept"], 4)
                if "mode_swap_accept" in res.diag else None),
        )
        if rank0:
            from lhvi_tpu_torch.utils.checkpoint import CheckpointManager

            mgr = CheckpointManager(cfg.checkpoint_dir + "/vi")
            mgr.save(0, {"vi_params": vi_params_host._asdict()}, wait=True)
            log.log("checkpoint", step=0, path=cfg.checkpoint_dir)

    log.close()
    if shard is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
