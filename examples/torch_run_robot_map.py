"""Robot-mapping HMLN on the PyTorch port (the port's counterpart of
``examples/run_robot_map.py``): classify hallway laser-scan segments into
wall/door/other and fill in unmeasured depths, from evidence on disk read
by ``relational/data.py::load_evidence``. Runs on the card unless given
--cpu.

    python examples/torch_run_robot_map.py --engine vi
    python examples/torch_run_robot_map.py --engine hmc --n-chains 128
    python examples/torch_run_robot_map.py --data my_scan.db
"""

import os

import numpy as np

from torch_common import device_of, make_parser, report, run_engine
from lhvi_tpu_torch.config import RobotMapConfig, from_args


def main():
    args = make_parser(RobotMapConfig(), __doc__).parse_args()
    cfg = from_args(RobotMapConfig, args)
    import torch

    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.lift import compile_lifted
    from lhvi_tpu_torch.models.relational import robot_map, robot_scan_evidence
    from lhvi_tpu_torch.relational.data import load_evidence

    dev = device_of(args)
    data = cfg.data or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data", "robot_map.db"
    )
    evidence = load_evidence(data)
    # ground-truth labels exist only for the bundled synthetic scan
    # (data/robot_map.db is robot_scan_evidence(seed=0) on disk); a
    # user-supplied --data file has no known labels to score against
    true_types = (
        robot_scan_evidence(cfg.n_segments, seed=0)[1]
        if not cfg.data
        else None
    )

    rg = robot_map(cfg.n_segments, evidence=evidence)
    g, index = rg.ground()
    n_lat = sum(1 for rv in g.rvs if not rv.observed)
    print(f"data={data}: {len(evidence)} evidence atoms; "
          f"{len(g.rvs)} ground RVs ({n_lat} latent), {len(g.factors)} factors")

    fg = compile_lifted(g, dev) if cfg.lifted else compile_graph(g, dev)
    res = run_engine(fg, cfg, torch.Generator(dev).manual_seed(cfg.seed))
    print(f"engine={cfg.engine}  wall={res.wall_s:.2f}s")

    correct = total = 0
    for i in range(cfg.n_segments):
        rv = index[("type", (f"s{i}",))]
        if rv.observed:
            continue
        probs = np.asarray(res.disc_marginal(rv))
        pred = int(probs.argmax())
        total += 1
        if true_types is not None:
            correct += pred == true_types[i]
        if i < 8:
            true = f" true={true_types[i]}" if true_types is not None else ""
            print(f"  type(s{i}): P={probs.round(3)}  pred={pred}{true}")
    if true_types is not None:
        print(f"type accuracy on {total} unlabeled segments: "
              f"{correct}/{total}")
    else:
        print(f"{total} unlabeled segments classified "
              "(no ground truth for user-supplied --data)")
    for i in range(cfg.n_segments):
        rv = index[("depth", (f"s{i}",))]
        if not rv.observed:
            true = (f" (true segment type {true_types[i]})"
                    if true_types is not None else "")
            print(f"  E[depth(s{i})] = {res.mean(rv):+.3f}{true}")
    report(cfg.metrics_path, engine=cfg.engine, wall_s=res.wall_s,
           n_unlabeled=total,
           correct=int(correct) if true_types is not None else None)


if __name__ == "__main__":
    main()
