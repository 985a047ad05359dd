"""The port's checkpointed, resumable sampling (``engines/resumable.py``)
held to the reference's resume tests (``tests/test_resume.py``,
``tests/test_modeswap.py::test_resume_bitwise_with_mode_swap``): a run
interrupted at a sample chunk or mid-warmup and resumed is BITWISE equal
to an uninterrupted one, an incompatible checkpoint is refused, and the
answers match the exact oracles. A reference format-4 payload, written by
the JAX ``sample_checkpointed`` and read with the JAX
``CheckpointManager``, finalizes in the port to the JAX's moments and
diagnostics to f32 rounding.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.engines.resumable import sample_checkpointed as ref_sample  # noqa: E402
from lhvi_tpu.models.toy import hybrid_chain as ref_hybrid_chain  # noqa: E402
from lhvi_tpu.utils.checkpoint import CheckpointManager as RefManager  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.potentials as pot  # noqa: E402
from lhvi_tpu_torch.engines import hmc, nuts, resumable  # noqa: E402
from lhvi_tpu_torch.engines.resumable import sample_checkpointed  # noqa: E402
from lhvi_tpu_torch.models.toy import gaussian_grid, hybrid_chain  # noqa: E402
from lhvi_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from lhvi_tpu_torch.utils.convert import resumable_payload_from_numpy  # noqa: E402
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _assert_bitwise(full, resumed, keys=("accept_rate",)):
    for k in ("mean", "var", "disc_probs"):
        assert np.array_equal(full.moments[k], resumed.moments[k]), k
    for k in keys:
        assert np.array_equal(full.diag[k], resumed.diag[k]), k


def test_resume_bitwise_identical(tmp_path):
    g, (d, x1, x2) = hybrid_chain()
    fg = lt.compile_graph(g, "cpu")
    kw = dict(engine="hmc", n_chains=16, n_warmup=100, n_samples=250,
              chunk_size=100)
    full = sample_checkpointed(fg, _gen(7), ckpt_dir=str(tmp_path / "full"),
                               **kw)
    # interrupted after chunk 1 of 3, then resumed
    out = sample_checkpointed(fg, _gen(7), ckpt_dir=str(tmp_path / "part"),
                              _interrupt_after=1, **kw)
    assert out is None
    resumed = sample_checkpointed(fg, _gen(7), ckpt_dir=str(tmp_path / "part"),
                                  **kw)
    _assert_bitwise(full, resumed, ("accept_rate", "rhat", "ess_proxy",
                                    "ess_bm", "rhat_disc", "step_size",
                                    "inv_mass"))
    assert np.isfinite(resumed.diag["rhat"]).all()
    assert np.isfinite(resumed.diag["ess_bm"]).all()
    assert resumed.diag["rhat_disc"].shape == (fg.n_disc,)
    assert np.isfinite(resumed.diag["rhat_disc"]).all()
    exact = ExactPosterior(g, cont_grid=161)
    assert abs(resumed.mean(x1) - exact.mean(x1)) < 0.12
    assert np.abs(resumed.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.08


def test_resume_mid_warmup_bitwise_identical(tmp_path):
    """chunk_size=40 over n_warmup=100: warmup chunks of 40+10 | 40+10
    (phase boundary at 50), so interrupting after 2 warmup chunks lands on
    the phase-1 mass refresh."""
    g, _ = hybrid_chain()
    fg = lt.compile_graph(g, "cpu")
    kw = dict(engine="hmc", n_chains=16, n_warmup=100, n_samples=80,
              chunk_size=40)
    full = sample_checkpointed(fg, _gen(9), ckpt_dir=str(tmp_path / "full"),
                               **kw)
    out = sample_checkpointed(fg, _gen(9), ckpt_dir=str(tmp_path / "part"),
                              _interrupt_warmup_after=2, **kw)
    assert out is None
    payload = CheckpointManager(str(tmp_path / "part")).restore()
    assert payload["warmup_done"] == 50 and payload["fmt"] == 4
    resumed = sample_checkpointed(fg, _gen(9), ckpt_dir=str(tmp_path / "part"),
                                  **kw)
    _assert_bitwise(full, resumed, ("accept_rate", "step_size", "inv_mass",
                                    "rhat"))


@pytest.mark.parametrize("fault", ["stripped", "fmt", "n_chains"])
def test_resume_rejects_incompatible_checkpoint(tmp_path, fault):
    """A checkpoint missing a non-empty accumulator, of another payload
    format or of another chain count is refused, never zero-filled."""
    g, _ = hybrid_chain()
    fg = lt.compile_graph(g, "cpu")
    kw = dict(engine="hmc", n_chains=8, n_warmup=20, n_samples=60,
              chunk_size=30)
    ckpt = str(tmp_path / "old")
    assert sample_checkpointed(fg, _gen(10), ckpt_dir=ckpt,
                               _interrupt_after=1, **kw) is None
    mgr = CheckpointManager(ckpt)
    step = mgr.latest_step()
    payload = mgr.restore(step)
    if fault == "stripped":
        # as a payload written before the streamed diagnostics
        payload["sums"] = {k: v for k, v in payload["sums"].items()
                           if int(k) < 4}
        match = "incompatible"
    elif fault == "fmt":
        payload["fmt"] = 3
        match = "payload format 3 .expected 4.*incompatible"
    else:
        match = "checkpoint has n_chains=8, requested 16"
        kw["n_chains"] = 16
    mgr.save(step + 1, payload, wait=True)
    with pytest.raises(ValueError, match=match):
        sample_checkpointed(fg, _gen(10), ckpt_dir=ckpt, **kw)


def test_resume_nuts_runs(tmp_path):
    g, (d, x1, x2) = hybrid_chain()
    fg = lt.compile_graph(g, "cpu")
    res = sample_checkpointed(fg, _gen(8), engine="nuts", n_chains=16,
                              n_warmup=150, n_samples=200, chunk_size=80,
                              ckpt_dir=str(tmp_path / "n"),
                              cfg=nuts.NUTSConfig(max_depth=5))
    exact = ExactPosterior(g, cont_grid=161)
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.12
    assert abs(res.mean(x2) - exact.mean(x2)) < 0.12


def _spin_clique(n=4, w=3.0, bias=0.3):
    dom = lt.Domain([0, 1])
    spins = [lt.RV(dom, name=f"s{i}") for i in range(n)]
    fs = [lt.F(pot.MLNPotential(lambda a: pot.leq(a[0], a[1]), w=w),
               [spins[i], spins[j]])
          for i in range(n) for j in range(i + 1, n)]
    fs += [lt.F(pot.MLNPotential(lambda a: a[0], w=bias), [s]) for s in spins]
    return lt.Graph(spins, fs)


@pytest.mark.parametrize("every", [1, 3])
def test_resume_bitwise_with_mode_swap(tmp_path, every):
    """tests/test_modeswap.py:190: the ms_acc accumulators (format 4) and
    the move's streams survive preemption, with the move every transition
    and gated every third (the gate's generator is drawn per chunk)."""
    fg = lt.compile_graph(_spin_clique(), "cpu")
    kw = dict(engine="hmc",
              cfg=hmc.HMCConfig(mode_swap=True, mode_swap_every=every),
              n_chains=8, n_warmup=40, n_samples=120, chunk_size=60)
    full = sample_checkpointed(fg, _gen(13), ckpt_dir=str(tmp_path / "f"),
                               **kw)
    out = sample_checkpointed(fg, _gen(13), ckpt_dir=str(tmp_path / "p"),
                              _interrupt_after=0, **kw)
    assert out is None
    resumed = sample_checkpointed(fg, _gen(13), ckpt_dir=str(tmp_path / "p"),
                                  **kw)
    _assert_bitwise(full, resumed, ("accept_rate", "mode_swap_accept"))
    assert float(full.diag["mode_swap_accept"]) > 0.0


@pytest.mark.parametrize("engine", ["hmc", "nuts"])
def test_chunk_generators_key_k2_and_k3_apart(tmp_path, monkeypatch, engine):
    """Every chunk draws from a generator of its own: the generators that
    reach K2's wrapper (HMC on a banded grid) and NUTS's route to K3's
    (``_nuts_sweep_batched`` on a dense grid), whose seeds key the
    kernels' in-kernel Philox on the card, have a distinct initial seed in
    every chunk, and each chunk's proposals all see that chunk's
    generator."""
    from lhvi_tpu_torch.ops import dia

    seen = []
    if engine == "hmc":
        g, _ = gaussian_grid(8, 8, seed=1, evidence_frac=0.05)
        fg = lt.compile_graph(g, "cpu", quad_max_n=16)
        assert hmc._use_dia(fg, hmc.HMCConfig())
        real = dia.dia_hmc_proposal

        def spy(gen, *a, **k):
            seen.append(gen.initial_seed())
            return real(gen, *a, **k)

        monkeypatch.setattr(dia, "dia_hmc_proposal", spy)
        cfg = hmc.HMCConfig(n_leapfrog=3)
    else:
        g, _ = gaussian_grid(3, 3, seed=0, evidence_frac=0.2)
        fg = lt.compile_graph(g, "cpu")
        real = nuts._nuts_sweep_batched

        def spy(fg_, gen, *a, **k):
            seen.append(gen.initial_seed())
            return real(fg_, gen, *a, **k)

        monkeypatch.setattr(nuts, "_nuts_sweep_batched", spy)
        cfg = nuts.NUTSConfig(max_depth=3)
    # warmup 12 → chunks of 5+1 | 5+1; samples 12 → 5+5+2
    res = sample_checkpointed(fg, _gen(4), cfg, engine=engine, n_chains=4,
                              n_warmup=12, n_samples=12, chunk_size=5,
                              ckpt_dir=str(tmp_path / "ck"))
    assert np.isfinite(res.moments["mean"]).all()
    sizes = [5, 1, 5, 1, 5, 5, 2]
    assert len(seen) == sum(sizes)
    per_chunk, i = [], 0
    for n in sizes:
        assert len(set(seen[i:i + n])) == 1, seen[i:i + n]
        per_chunk.append(seen[i])
        i += n
    assert len(set(per_chunk)) == len(sizes), per_chunk


def test_reference_payload_finalizes_to_reference_moments(tmp_path):
    """A JAX sample_checkpointed run is interrupted, its payload read with
    the JAX CheckpointManager and carried into the port, then the JAX run
    is resumed to its end: the port's finalize of the carried final
    accumulators equals the JAX's result to f32 rounding."""
    g_ref, _ = ref_hybrid_chain()
    fg_ref = ref_compile(g_ref)
    g, _ = hybrid_chain()
    fg = lt.compile_graph(g, "cpu")
    kw = dict(engine="hmc", n_chains=16, n_warmup=20, n_samples=60,
              chunk_size=30)
    ck = str(tmp_path / "ref")
    key = jax.random.PRNGKey(3)
    assert ref_sample(fg_ref, key, ckpt_dir=ck, _interrupt_after=1,
                      **kw) is None
    mgr = RefManager(ck)
    part = mgr.restore(mgr.latest_step())
    mgr.close()
    assert int(part["chunks_done"]) == 1
    state, sums = resumable_payload_from_numpy(part, "cpu")
    assert state.xc.shape == (16, 2) and state.xd.dtype == torch.int64
    assert len(sums) == 17 and sums[4].shape == (16, 2)
    want = ref_sample(fg_ref, key, ckpt_dir=ck, **kw)
    mgr = RefManager(ck)
    final = mgr.restore(mgr.latest_step())
    mgr.close()
    state, sums = resumable_payload_from_numpy(final, "cpu")
    sel = hmc.disc_diag_select(fg, 4096)
    got = resumable.finalize(fg, state, sums, 60, 16, sel=sel)
    for k in ("mean", "var", "disc_probs"):
        np.testing.assert_allclose(got.moments[k], want.moments[k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("accept_rate", "step_size", "inv_mass", "rhat", "ess_proxy",
              "ess_bm", "rhat_disc", "disc_diag_idx"):
        np.testing.assert_allclose(got.diag[k], want.diag[k], rtol=1e-5,
                                   err_msg=k)
    # a stripped reference payload is refused as a resume refuses it
    final["sums"] = {k: v for k, v in final["sums"].items() if int(k) < 4}
    with pytest.raises(ValueError, match="incompatible"):
        resumable_payload_from_numpy(final, "cpu")
