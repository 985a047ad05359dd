"""Checkpoint-in-the-loop sampling: chunked HMC/NUTS with resume (PyTorch
port of ``lhvi_tpu/engines/resumable.py``).

``sample_checkpointed`` runs the two-phase warmup and then the sampling in
chunks of at most ``chunk_size`` transitions, and after every chunk saves
the sampler state, the streamed moment sums and diagnostics, and the
run's bookkeeping through ``utils.checkpoint.CheckpointManager``. A killed
run re-invoked with the same arguments restores the latest chunk and
continues.

Random streams: the reference folds the chunk index into its key. Here
each chunk draws from a generator of its own, seeded from (one draw of
the caller's generator, the phase, the chunk's first transition, the
rank), as ``vi._stage_gen`` seeds VI's stages. So an interrupted and
resumed run draws exactly what an uninterrupted one draws, and nothing
about a random stream is saved. K2's and K3's in-kernel momenta are keyed
by the generator's seed, which differs per chunk. The mode-swap gate's
host generator is drawn per chunk from the chunk generator that every
rank shares.

Payload format 4 (the reference's ``_payload_to_host``): ``state`` (the
``HMCState`` fields, ``ms_acc_sum``/``ms_acc_n`` included), ``sums``
(``"0"``..``"16"``: the two moment sums, the discrete counts, the
acceptance sum, the 9 ``_StreamDiag`` and the 4 ``_StreamDiagDisc``
arrays), ``chunks_done``, ``n_chains``, ``warmup_done`` and ``fmt``.
Zero-size entries are left out, as the reference leaves them out.

Under ``shard`` (a ``parallel.ChainShard``) each rank runs its block of
chains; a checkpoint is gathered, then saved: the chain-leading arrays
are assembled over the ranks and rank 0 writes them, so a checkpoint
holds all chains and names no rank. At each save the sums are brought to
one form (rank 0 holds the totals, the other ranks zeros; the acceptance
sums hold the mean over the ranks on every rank), which is also what a
restore gives, so a resumed sharded run is bitwise equal to an
uninterrupted one.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from lhvi_tpu_torch.engines import hmc as _hmc
from lhvi_tpu_torch.engines import nuts as _nuts
from lhvi_tpu_torch.fg.compile import CompiledFG
from lhvi_tpu_torch.parallel.mesh import (all_reduce, assemble_rows,
                                          local_count, n_chain_shards)

FMT = 4
# the seed words of a chunk's generator: init, the two warmup phases,
# sampling
_INIT, _WARM1, _WARM2, _SAMPLE = range(4)


def _chunk_gen(device, seed: int, phase: int, index: int, rank=None):
    """The generator of one chunk, seeded from (run seed, phase, the
    chunk's first transition, rank); ``rank=None`` gives the generator
    that every rank shares."""
    words = [seed, phase, index] + ([0] if rank is None else [1, rank])
    s = int(np.random.SeedSequence(words).generate_state(
        2, np.uint32).view(np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device).manual_seed(s)


def _shapes(n_chains: int, n_cont: int, n_disc: int, max_v: int,
            n_sel: int):
    """(state field → (shape, dtype), the sums' shapes) of a payload."""
    f32, i64 = torch.float32, torch.int64
    vec = ((n_cont,), f32)
    state = {"xc": ((n_chains, n_cont), f32), "xd": ((n_chains, n_disc), i64),
             "welford_mean": vec, "welford_m2": vec, "inv_mass": vec}
    for k in _hmc.HMCState._fields:
        state.setdefault(k, ((), f32))
    sums = ([(n_cont,), (n_cont,), (max(n_disc, 1), max_v), ()]
            + [(n_chains, n_cont)] * 9 + [(n_chains, n_sel)] * 4)
    return state, sums


def unpack_payload(payload: dict, device, n_cont: int, n_disc: int,
                   max_v: int, n_sel: int, where: str = "checkpoint"):
    """``(HMCState, sums)`` of all chains on ``device`` from a format-4
    payload (tensors or numpy arrays). Refuses another ``fmt`` and a
    missing non-empty entry, as the reference does: zero-filling it would
    finalize confidently wrong moments or R̂."""
    if payload.get("fmt") != FMT:
        raise ValueError(
            f"{where} has payload format {payload.get('fmt')!r} (expected "
            f"{FMT}): it was written by an incompatible lhvi_tpu version. "
            "Finalize it with the version that wrote it, or restart the "
            "run.")
    st_shapes, sum_shapes = _shapes(int(payload["n_chains"]), n_cont, n_disc,
                                    max_v, n_sel)

    def get(name, saved, shape, dtype):
        if name in saved:
            v = torch.as_tensor(np.asarray(saved[name])
                                if not isinstance(saved[name], torch.Tensor)
                                else saved[name])
            return v.to(device=device, dtype=dtype).reshape(shape)
        if int(np.prod(shape)) == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        raise ValueError(
            f"{where} lacks accumulator {name!r} (shape {shape}): it was "
            "written by an incompatible lhvi_tpu version. Finalize it with "
            "the version that wrote it, or restart the run.")

    state = _hmc.HMCState(**{k: get(k, payload["state"], *st_shapes[k])
                             for k in _hmc.HMCState._fields})
    sums = tuple(get(str(i), payload["sums"], sh, torch.float32)
                 for i, sh in enumerate(sum_shapes))
    return state, sums


def _payload(state, sums, chunks_done: int, n_chains: int,
             warmup_done: int) -> dict:
    return {
        "state": {k: v for k, v in state._asdict().items() if v.numel()},
        "sums": {str(i): v for i, v in enumerate(sums) if v.numel()},
        "chunks_done": chunks_done,
        "n_chains": n_chains,
        "warmup_done": warmup_done,
        "fmt": FMT,
    }


def _per_chain(i: int) -> bool:
    """Whether sums entry ``i`` is chain-leading (the stream diagnostics)."""
    return i >= 4


def _moment_stream(fg: CompiledFG, sums, n_samples: int, n_chains: int,
                   sel, shard):
    """``hmc._MomentStream`` holding the payload's accumulators ``sums``
    (the discrete stream on the latents ``sel``, where there are any)."""
    ms = _hmc._MomentStream(fg, n_chains, n_samples, True, 0, shard)
    ms.s1, ms.s2, ms.cnt = sums[:3]
    ms.sd = _hmc._StreamDiag(*sums[4:13])
    if sel is not None and len(sel):
        ms.sel = torch.as_tensor(np.asarray(sel), dtype=torch.int64,
                                 device=fg.device)
        ms.sdd = _hmc._StreamDiagDisc(*sums[13:])
    return ms


def _sums_of(ms, acc_sum, empty_disc):
    """The payload's 17 accumulators from a stream and the acceptance sum
    (``empty_disc``: the 4 ``[C, 0]`` discrete arrays where no discrete
    latent is monitored)."""
    return (ms.s1, ms.s2, ms.cnt, acc_sum, *ms.sd,
            *(empty_disc if ms.sdd is None else ms.sdd))


def finalize(fg: CompiledFG, state, sums, n_samples: int, n_chains: int,
             mode_swap: bool = False, sel=None, shard=None):
    """``HMCMoments`` of a finished run from its accumulators (this rank's
    part under ``shard``): the reference's closing block, through the
    window diagnostics of ``hmc.run_chains``."""
    moments, stream = _moment_stream(fg, sums, n_samples, n_chains, sel,
                                     shard).finalize()
    diag = _hmc._window_diag(state, {"accept_rate": sums[3]}, n_samples,
                             mode_swap, shard)
    return _hmc.HMCMoments(fg, moments, {**diag, **stream})


def sample_checkpointed(
    fg: CompiledFG,
    gen: torch.Generator,
    cfg=None,
    *,
    engine: str = "hmc",
    n_chains: int = 8,
    n_warmup: int = 500,
    n_samples: int = 1000,
    chunk_size: int = 100,
    ckpt_dir: str,
    shard=None,
    max_to_keep: int = 3,
    disc_diag_cap: int = 4096,
    _interrupt_after: Optional[int] = None,
    _interrupt_warmup_after: Optional[int] = None,
):
    """Run (or resume) a chunked sampling job; returns ``HMCMoments``.

    ``gen`` (a ``torch.Generator`` on ``fg.device``) gives the run's seed
    (one draw): a resumed run passes a generator in the same state as the
    first invocation's, as the reference passes the same key.

    Warmup is chunk-dispatched and checkpointed exactly like sampling, and
    a run preempted mid-warmup resumes from its last warmup chunk.
    ``_interrupt_after=k`` stops after saving sample chunk k (returns
    None); ``_interrupt_warmup_after=k`` stops after saving warmup chunk k:
    the fault-injection hooks of the resume tests. ``disc_diag_cap`` bounds
    the streamed discrete-value split-R̂ as in ``hmc.run_hmc``. ``shard``:
    see the module docstring; every rank returns the whole run's moments.
    """
    from lhvi_tpu_torch.utils.checkpoint import CheckpointManager

    if engine == "hmc":
        fg, cfg = _hmc._ensure_mode_swap_plan(fg, cfg or _hmc.HMCConfig())
        hcfg, step = cfg, _hmc.chain_step(fg, cfg, shard)
    elif engine == "nuts":
        fg, cfg = _hmc._ensure_mode_swap_plan(fg, cfg or _nuts.NUTSConfig())
        hcfg, step = cfg.to_hmc(), _nuts.chain_step(fg, cfg, shard)
    else:
        raise ValueError(f"unknown engine {engine!r} (hmc|nuts)")

    dev = fg.device
    C = local_count(n_chains, shard)
    rank = 0 if shard is None else shard.rank
    k = n_chain_shards(shard)
    lo, hi = (0, n_chains) if shard is None else shard.rows(n_chains)
    seed = int(torch.randint(0, 2**62, (1,), generator=gen,
                             device=gen.device).item())
    n_chunks = math.ceil(n_samples / chunk_size)
    sel = (_hmc.disc_diag_select(fg, disc_diag_cap)
           if fg.n_disc and disc_diag_cap > 0 else np.zeros(0, np.int32))
    n_sel = int(sel.size)

    def chunk_gens(phase, index):
        g = _chunk_gen(dev, seed, phase, index, rank)
        return g, _hmc._gate(cfg, _chunk_gen(dev, seed, phase, index))

    def fresh_sums():
        ms = _hmc._MomentStream(fg, n_chains, n_samples, True, disc_diag_cap,
                                shard)
        return _sums_of(ms, torch.zeros((), device=dev),
                        _hmc._stream_diag_disc_init(C, 0, dev))

    def local_part(state, sums):
        """The rank's part of an all-chains (state, sums)."""
        if shard is None:
            return state, sums
        state = state._replace(xc=state.xc[lo:hi].clone(),
                               xd=state.xd[lo:hi].clone())
        # the acceptance sum (3) is the ranks' mean on every rank; the
        # other sums are totals, which rank 0 alone carries on
        sums = tuple(
            s[lo:hi].clone() if _per_chain(i)
            else s if i == 3 or rank == 0 else torch.zeros_like(s)
            for i, s in enumerate(sums))
        return state, sums

    mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)

    def save(step, state, sums, chunks_done, warmup_done):
        """Gather, then save (rank 0 writes); returns the (state, sums)
        the run goes on from, in the form a restore gives."""
        if shard is not None:
            acc = all_reduce(sums[3], shard) / k
            ms_acc = all_reduce(state.ms_acc_sum, shard) / k
            state = state._replace(xc=assemble_rows(state.xc, shard),
                                   xd=assemble_rows(state.xd, shard),
                                   ms_acc_sum=ms_acc)
            sums = tuple(assemble_rows(s, shard) if _per_chain(i)
                         else acc if i == 3 else all_reduce(s, shard)
                         for i, s in enumerate(sums))
        if rank == 0:
            mgr.save(step, _payload(state, sums, chunks_done, n_chains,
                                    warmup_done), wait=True)
        # every rank waits for the write (an all_reduce as the barrier)
        all_reduce(torch.zeros((1,), device=dev), shard)
        return local_part(state, sums)

    latest = mgr.latest_step()
    if latest is None:
        g, _ = chunk_gens(_INIT, 0)
        state = _hmc.init_hmc_state(fg, g, hcfg, C)
        sums = fresh_sums()
        warmup_done = chunks_done = next_step = 0
    else:
        payload = mgr.restore(latest)
        if payload["n_chains"] != n_chains:
            raise ValueError(
                f"checkpoint has n_chains={payload['n_chains']}, "
                f"requested {n_chains}")
        state, sums = unpack_payload(payload, dev, fg.n_cont, fg.n_disc,
                                     fg.max_v, n_sel,
                                     where=f"checkpoint at {ckpt_dir!r}")
        state, sums = local_part(state, sums)
        chunks_done = int(payload["chunks_done"])
        warmup_done = int(payload.get("warmup_done", n_warmup))
        next_step = latest + 1

    # --- warmup, chunk-dispatched + checkpointed ---------------------------
    # the two phases of hmc.run_warmup, with its phase boundary at half_w
    # and n_warmup (on a resume from mid-warmup too). A chunk's generator
    # is keyed by its phase and first transition, so the same chunks draw
    # the same numbers on a resume.
    half_w = max(n_warmup // 2, 1) if n_warmup > 0 else 0
    w_chunks_saved = 0
    while warmup_done < n_warmup:
        if warmup_done < half_w:
            phase, pos, pend = _WARM1, warmup_done, half_w
        else:
            phase, pos, pend = _WARM2, warmup_done - half_w, n_warmup - half_w
        n = min(chunk_size, pend - pos)
        g, gate = chunk_gens(phase, pos)
        for _ in range(n):
            state, _ = step(state, g, gate, True)
        warmup_done += n
        if warmup_done == half_w:
            state = _hmc._warmup_boundary(fg, hcfg, state, final=False)
        if warmup_done == n_warmup:
            state = _hmc._warmup_boundary(fg, hcfg, state, final=True)
        state, sums = save(next_step, state, sums, 0, warmup_done)
        next_step += 1
        w_chunks_saved += 1
        if (_interrupt_warmup_after is not None
                and w_chunks_saved >= _interrupt_warmup_after):
            mgr.close()
            return None
    if n_warmup == 0 and latest is None:
        state, sums = save(next_step, state, sums, 0, 0)
        next_step += 1

    for c in range(chunks_done, n_chunks):
        n = min(chunk_size, n_samples - c * chunk_size)
        g, gate = chunk_gens(_SAMPLE, c)
        ms = _moment_stream(fg, sums, n_samples, n_chains, sel, shard)
        acc_sum = sums[3]
        for i in range(n):
            state, stats = step(state, g, gate, False)
            acc_sum = acc_sum + torch.mean(stats["accept_rate"])
            ms.update(c * chunk_size + i, state.xc, state.xd)
        sums = _sums_of(ms, acc_sum, sums[13:])
        state, sums = save(next_step, state, sums, c + 1, n_warmup)
        next_step += 1
        if _interrupt_after is not None and (c + 1) >= _interrupt_after:
            mgr.close()
            return None
    mgr.close()
    return finalize(fg, state, sums, n_samples, n_chains,
                    getattr(cfg, "mode_swap", False), sel, shard)
