"""The port's counterpart of the reference's multi-chip dry run
(``__graft_entry__.py:45-202``, ``dryrun_multichip``) over four gloo
processes on the CPU, laid out as 2 × 2 (dp, tp): two ``tp`` groups
({0, 1}, {2, 3}) and two ``dp`` groups ({0, 2}, {1, 3}) made with
``dist.new_group``, which two ranks cannot show.

Each rank runs ``chip_smoke.py::dryrun_steps`` (the step list the card's
two-rank path runs too: the tp-sharded VI Adam step, the dp-sharded SMC,
NUTS and HMC steps, the pod path with the mode-swap move, the banded route
with ``dia_kernel`` on and off) and ``chip_smoke.py::owed_checks`` at small
sizes over its dp group: the banded route forced with ``quad_max_n=64``
(as ``tests/test_torch_smc.py:239``), adaptation off, equals the pooled
per-rank runs; one proposal from a shared start differs between the dp
ranks in every row, and the rank generators' K2 seeds
(``gen.initial_seed() ^ _KEY_TAG``) differ between dp ranks and agree
between the tp ranks that hold the same chains.

The worker is this file itself (``python test_torch_multichip.py <rank>
<world> <port> <dir>``); it imports torch, the port and ``chip_smoke.py``,
never jax.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
DP, TP = 2, 2


def _worker(rank: int, world: int, port: int, out: str) -> None:
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    import torch.distributed as dist

    import chip_smoke
    from lhvi_tpu_torch.parallel import chain_sharding, init_distributed

    init_distributed("gloo", f"tcp://127.0.0.1:{port}", rank, world)
    # every rank makes every group, in one order
    tp_groups = [dist.new_group([d * TP + t for t in range(TP)])
                 for d in range(DP)]
    dp_groups = [dist.new_group([d * TP + t for d in range(DP)])
                 for t in range(TP)]
    tp = chain_sharding(tp_groups[rank // TP])
    dp = chain_sharding(dp_groups[rank % TP])
    dev = torch.device("cpu")
    res = {
        "dp_rank": dp.rank, "tp_rank": tp.rank,
        "dryrun": chip_smoke.dryrun_steps(dev, dp, tp, vi_people=8,
                                          vi_steps=3),
        "owed": chip_smoke.owed_checks(dev, dp, rows=12, quad_max_n=64, C=16,
                                       S=10, C_hybrid=32,
                                       hybrid_steps=(10, 10, 20), C_robot=8,
                                       S_robot=2)}
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multichip")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(DP * TP), str(port), str(out)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DP * TP)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(DP * TP)]


def test_layout_places_every_rank(ranks):
    assert [(r["dp_rank"], r["tp_rank"]) for r in ranks] == [
        (d, t) for d in range(DP) for t in range(TP)]


def test_dryrun_steps_pass_on_every_rank(ranks):
    """The checks the card's two-rank path makes (``check_dryrun``): the
    tp-sharded VI step takes the unsharded step on every rank, every
    dp-sharded step ends finite, the pod path streams a non-empty finite
    rhat_disc and mode-swap acceptance."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    chip_smoke.check_dryrun([r["dryrun"] for r in ranks], "cpu")


@pytest.mark.parametrize("name", ["k2", "hybrid", "robot"])
@pytest.mark.parametrize("tp_rank", range(TP))
def test_dp_sharded_runs_equal_pooled_rank_runs(ranks, name, tp_rank):
    """Adaptation off, over each dp group: the banded route (K2's plain
    version here), ``hybrid_chain`` and ``robot_map(100)`` with
    ``fused_logpot=True`` (autograd on CPU tensors) equal the pooled
    unsharded runs of each dp rank's stream."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    group = [r["owed"][name] for r in ranks if r["tp_rank"] == tp_rank]
    eq, dm, dv = chip_smoke.pooled_diff(group[0]["sharded"],
                                        [g["local"] for g in group])
    assert eq and dm < 1e-5 and dv < 1e-5, (eq, dm, dv)
    for g in group:
        for k in ("mean", "var", "disc_probs"):
            np.testing.assert_array_equal(g["sharded"][k],
                                          group[0]["sharded"][k])


def test_banded_momenta_differ_between_dp_ranks(ranks):
    """K2's keys: a proposal from one start differs between the dp ranks
    in every row; the seeds differ between dp ranks and agree between the
    tp ranks of one dp index (they hold the same chains)."""
    from lhvi_tpu_torch.ops.dia import _KEY_TAG

    k2 = [r["owed"]["k2"] for r in ranks]
    assert all(x["rows_equal"] == 0 and x["rows"] > 0 for x in k2)
    seeds = {}
    for r in ranks:
        seeds.setdefault(r["dp_rank"], set()).add(r["owed"]["k2"]["seed"])
    assert all(len(s) == 1 for s in seeds.values())
    assert seeds[0] != seeds[1]
    assert all(s ^ _KEY_TAG != s for x in seeds.values() for s in x)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
