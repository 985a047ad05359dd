"""Chain and particle sharding over ``torch.distributed`` (PyTorch port of
the chain half of ``lhvi_tpu/parallel/mesh.py``).

The reference lays the chain (or particle) axis over a ``jax.sharding.Mesh``
and lets XLA insert the collectives. Here each rank of a process group
holds a contiguous block of the chains and runs its own kernels on them
(K1, K2, K3, K5 per rank: chains never talk inside a transition); the
engines call the collectives below where a quantity spans all chains:
the acceptance that drives dual averaging, the batched Welford update,
the moment sums, and the streamed diagnostics once at the end (the
assembled ``[C, n]`` accumulators).

A :class:`ChainShard` names this rank, the world size and the process
group. ``n_chain_shards`` is the one authority for divisibility: a chain
count that does not divide over the ranks raises (the reference warns
and gathers onto one device; that gather has no counterpart here).

Every collective is an ``all_reduce`` (sum or max); an all-gather is an
``all_reduce`` into a zero buffer in which each rank fills its own rows
(:func:`assemble_rows`). On the gloo backend a CUDA tensor is staged
through host memory inside the helper (the work itself stays on the
card), so two ranks can share one GPU, which NCCL refuses.

Random streams: each rank draws from its own generator, seeded from (a
seed drawn from the caller's generator, the rank), so no two ranks draw
the same momenta; draws every rank must agree on (the SMC resampler's
offset, the mode-swap gate) come from a generator shared by all ranks
(:func:`split_generator`).

The factor axis (the reference's ``tp``): :func:`shard_fg_factors` gives
each rank of a group the rows ``[lo, hi)`` of every bucket; VI's ELBO and
``log_prob`` then sum the bucket terms over the group
(:func:`sum_over_shards`) and VI all-reduces its gradient.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChainShard:
    """This rank's place on the chain axis: ``rank`` of ``world`` in the
    process ``group`` (None: the default group)."""

    rank: int
    world: int
    group: Any = None

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's chain range ``[lo, hi)`` of ``n`` chains."""
        per = local_count(n, self)
        return self.rank * per, (self.rank + 1) * per


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> ChainShard:
    """Join (or reuse) the default process group and return this rank's
    :class:`ChainShard`. Rank, world size and address default to
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); the backend defaults to NCCL where every rank has a
    GPU of its own, gloo otherwise (NCCL refuses two ranks on one GPU;
    under gloo such ranks share the current GPU). With NCCL each rank
    takes the GPU ``LOCAL_RANK``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        if backend is None:
            backend = ("nccl" if world_size <= torch.cuda.device_count()
                       else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return chain_sharding()


def chain_sharding(group=None) -> ChainShard:
    """The :class:`ChainShard` of this rank in ``group`` (an initialized
    process group; None: the default one)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("chain_sharding needs an initialized process "
                           "group (see init_distributed)")
    return ChainShard(dist.get_rank(group), dist.get_world_size(group), group)


def n_chain_shards(shard: Optional[ChainShard]) -> int:
    """How many ways ``shard`` splits the chain axis (1 for None). THE
    divisibility authority: every site that splits chains asks
    :func:`local_count`, which asks this."""
    return 1 if shard is None else int(shard.world)


def local_count(n: int, shard: Optional[ChainShard]) -> int:
    """Chains (or particles) of ``n`` this rank holds; raises where ``n``
    does not divide over the ranks."""
    k = n_chain_shards(shard)
    if n % k:
        raise ValueError(
            f"{n} chains do not divide over {k} ranks: pass a multiple of "
            f"{k} (the port has no gathered fallback)")
    return n // k


def split_generator(gen: torch.Generator, rank: int):
    """``(rank generator, shared generator)`` on ``gen``'s device, seeded
    from one 62-bit draw of ``gen`` with the rank (or, for the shared one,
    with no rank). Every rank given a generator in the same state derives
    the same shared generator and distinct rank generators; an unsharded
    run given ``split_generator(gen, r)[0]`` draws what rank ``r`` of a
    sharded run draws."""
    s = int(torch.randint(0, 2**62, (1,), generator=gen,
                          device=gen.device).item())

    def derive(*words):
        seed = int(np.random.SeedSequence([s, *words]).generate_state(
            2, np.uint32).view(np.uint64)[0] >> np.uint64(1))
        return torch.Generator(gen.device).manual_seed(seed)

    return derive(1, int(rank)), derive(0)


def _staged(t: torch.Tensor, shard: ChainShard):
    """``(buffer the collective runs on, copy back?)``: on the gloo
    backend, which reduces in host memory, a CUDA tensor is staged through
    the host explicitly."""
    import torch.distributed as dist

    if t.is_cuda and dist.get_backend(shard.group) == "gloo":
        return t.detach().to("cpu"), True
    return t.detach().clone(), False


def all_reduce(t: torch.Tensor, shard: Optional[ChainShard],
               op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks (``op``: "sum" or "max"), as a new
    tensor on ``t``'s device; ``t`` itself where ``shard`` is None."""
    if shard is None:
        return t
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    buf, back = _staged(t, shard)
    dist.all_reduce(buf, ops[op], group=shard.group)
    return buf.to(t.device) if back else buf


def assemble_rows(local: torch.Tensor, shard: Optional[ChainShard]):
    """The whole chain-leading tensor on every rank from each rank's block
    of rows: an ``all_reduce`` (sum) into a zero buffer in which this rank
    fills its own rows (exact: every other rank adds zeros)."""
    if shard is None:
        return local
    n = local.shape[0] * shard.world
    lo, hi = shard.rows(n)
    full = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    full[lo:hi] = local
    return all_reduce(full, shard)


def replicas_equal(t: torch.Tensor, shard: Optional[ChainShard]) -> bool:
    """Whether ``t`` holds the same values on every rank (max and −max(−t)
    agree elementwise; a host read)."""
    if shard is None:
        return True
    hi = all_reduce(t, shard, "max")
    lo = -all_reduce(-t, shard, "max")
    return bool(torch.equal(hi, lo))


class _ValueOf(torch.autograd.Function):
    """``value`` forward, the gradient of ``share`` backward."""

    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_shards(replicated: torch.Tensor, local: torch.Tensor,
                    shard: Optional[ChainShard]) -> torch.Tensor:
    """``replicated + Σ_ranks local`` on every rank, where ``replicated``
    is the same on every rank and ``local`` is this rank's part (``[]`` or
    ``[C]``). Its gradient is this rank's share, that of
    ``replicated / world + local``: summing the ranks' gradients (an
    ``all_reduce``) gives the gradient of the whole, with the replicated
    terms counted once. ``replicated + local`` where ``shard`` is None."""
    if shard is None:
        return replicated + local
    share = replicated / shard.world + local
    value = replicated.detach() + all_reduce(local.detach(), shard)
    return _ValueOf.apply(share, value)


def shard_fg_factors(fg, shard: ChainShard):
    """Factor-axis placement: a copy of the compiled graph ``fg`` whose
    every bucket holds only this rank's rows ``[lo, hi)`` of ``shard``
    (usually a ``tp`` subgroup, ``chain_sharding(group=...)``).

    Every bucket's row count must divide over the ranks: compile with
    ``pad_to`` a multiple of ``shard.world``. Per-variable tables and the
    fused information form stay whole. The copy records ``shard``
    (``CompiledFG.factor_shard``): ``vi.elbo`` and ``log_prob`` /
    ``log_prob_batched`` return the whole graph's value on every rank
    (:func:`sum_over_shards`; a rank whose rows are all padding adds
    zeros, and every rank runs the same buckets, ``lp_bucket_idx``, so the
    collectives pair up) and ``vi.fit`` all-reduces the gradient. The
    copy serves VI and ``log_prob``; the samplers and BP engines refuse it
    (they shard chains instead, ``shard=``). It starts with no VI plans
    of its own: plans built on the whole buckets do not carry over."""
    from lhvi_tpu_torch.fg.compile import _BUCKET_TABLES

    for b in fg.buckets:
        if b.n_factors % shard.world != 0:
            raise ValueError(
                f"bucket {b.kind} has {b.n_factors} rows, not divisible by "
                f"tp={shard.world}; compile with pad_to a multiple of it")

    def rows(b):
        lo, hi = shard.rows(b.n_factors)
        cut = {k: getattr(b, k)[lo:hi] for k in _BUCKET_TABLES}
        params = {k: (v[lo:hi] if v.dim() else v)
                  for k, v in b.params.items()}
        return dataclasses.replace(b, params=params, **cut)

    return dataclasses.replace(
        fg, buckets=tuple(rows(b) for b in fg.buckets), factor_shard=shard,
        vi_plans={})
