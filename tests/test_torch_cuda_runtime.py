"""The port's runtime on an NVIDIA GPU: resumable sampling bitwise through
the kernels (K1 dense HMC, K3 NUTS), and the collectives of
``parallel/mesh.py`` on CUDA tensors over gloo (staged through host
memory).

Marked ``cuda``: each test skips where no CUDA device is present. This
file imports only torch and the port (no JAX), so it runs on the card's
machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_runtime.py``.
"""

import socket

import numpy as np
import pytest
import torch

import lhvi_tpu_torch as lt
from lhvi_tpu_torch.engines import hmc, nuts
from lhvi_tpu_torch.engines.resumable import sample_checkpointed
from lhvi_tpu_torch.models.toy import gaussian_grid
from lhvi_tpu_torch.utils.metrics import counters

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("engine", ["hmc", "nuts"])
def test_resume_on_the_card_is_bitwise(dev, tmp_path, engine):
    """K1 and K3 are bitwise reproducible and each chunk's generator is
    seeded apart, so a run interrupted at the warmup's phase boundary and
    after a sample chunk, then resumed, equals an uninterrupted one."""
    g, _ = gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, dev)
    cfg = (hmc.HMCConfig(n_leapfrog=8, init_step_size=0.12) if engine == "hmc"
           else nuts.NUTSConfig(max_depth=4, init_step_size=0.12))
    counter = "ops.k1.launches" if engine == "hmc" else "ops.k3.launches"
    kw = dict(engine=engine, n_chains=4096, n_warmup=40, n_samples=40,
              chunk_size=20)
    before = counters()[counter]
    full = sample_checkpointed(fg, torch.Generator(dev).manual_seed(1), cfg,
                               ckpt_dir=str(tmp_path / "a"), **kw)
    assert counters()[counter] - before == 80
    for stop in (dict(_interrupt_warmup_after=1), dict(_interrupt_after=1)):
        assert sample_checkpointed(fg, torch.Generator(dev).manual_seed(1),
                                   cfg, ckpt_dir=str(tmp_path / "b"),
                                   **stop, **kw) is None
    res = sample_checkpointed(fg, torch.Generator(dev).manual_seed(1), cfg,
                              ckpt_dir=str(tmp_path / "b"), **kw)
    for k in ("mean", "var"):
        assert np.array_equal(full.moments[k], res.moments[k]), k
    for k in ("accept_rate", "rhat", "ess_bm", "step_size", "inv_mass"):
        assert np.array_equal(full.diag[k], res.diag[k]), k


def test_collectives_take_cuda_tensors_over_gloo(dev):
    """A one-rank gloo group: all_reduce (sum, max) and assemble_rows give
    CUDA tensors back with the right values."""
    import torch.distributed as dist

    from lhvi_tpu_torch.parallel import (all_reduce, assemble_rows,
                                         init_distributed)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    shard = init_distributed("gloo", f"tcp://127.0.0.1:{port}", 0, 1)
    try:
        x = torch.arange(6.0, device=dev).reshape(3, 2)
        for out in (all_reduce(x, shard), all_reduce(x, shard, "max"),
                    assemble_rows(x, shard)):
            assert out.device == x.device and torch.equal(out, x)
    finally:
        dist.destroy_process_group()
