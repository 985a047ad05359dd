"""Readings that set the limits of the cells whose reference draws exact
i.i.d. samples (``exact_moments``): ``robot100_hmc`` (kind
``hmc_hybrid``) and ``grid10_hmc`` (kind ``hmc_moments`` on
``gauss_grid10``), on the card, at the cell's size; ``control.py``'s
counterpart for them. ``grid10_hmc`` is parked: it runs here once its
entries (``tests/data/parked_grid10_hmc.json``) are in ``BENCHMARK.json``.

    python3 portbench/control_hybrid.py --workload <cell> \
        --seeds 11,12,13 --mode program|control|control32|fault:<name>

One process reads every seed. For each seed it makes the inputs, builds
the model as a run does and takes the cell's ``check_queries`` answers:

- ``program``: the program's answers (the lower readings);
- ``control``: the plain reference put in the program's place, computed
  in bfloat16, the precision below the configuration's float32: exact
  i.i.d. draws, as many chains and draws as a query, folded into moments,
  counts and streamed diagnostics as the program's answers are
  (``reference.exact_moments``);
- ``control32``: the same in float32, to show that the reference itself
  reads as the program does;
- ``fault:<name>``: the program with a fault of ``faults_hybrid.py``
  planted.

Each seed prints one JSON line with every number the judge compares; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_CHECKOUT = Path(__file__).resolve().parent.parent
if str(_CHECKOUT) not in sys.path:
    sys.path.insert(0, str(_CHECKOUT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import faults_hybrid, run  # noqa: E402
from portbench.control import program_answers  # noqa: E402
from portbench.registry import Registry, cell_spec, load_benchmark  # noqa

DTYPES = {"control": torch.bfloat16, "control32": torch.float32}
CELLS = ("robot100_hmc", "grid10_hmc")


def reference_answers(ref, cfg, mix, inputs, seed, n, device, dtype):
    """The reference in the program's place, in ``dtype``: answers in
    the reference's latent order, with the identity layout of the
    program's shape (``cont`` and ``disc`` where there are types)."""
    out = []
    for q in range(n):
        m, v, diag, *probs = ref.exact_moments(
            cfg, inputs, mix["n_chains"], mix["n_warmup"], mix["n_samples"],
            run.seed_of(seed, run.QUERY_TAG, q), dtype=dtype, device=device)
        out.append(dict(mean=m, var=v, diag=diag,
                        **({"disc_probs": probs[0]} if probs else {})))
    ident = np.arange(len(out[0]["mean"]))
    if "disc_probs" in out[0]:
        return out, dict(cont=ident,
                         disc=np.arange(len(out[0]["disc_probs"])))
    return out, ident


def main(argv=None, registry: Registry = None, bench: dict = None,
         device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    args = ap.parse_args(argv)
    if args.workload not in CELLS:
        raise KeyError(f"{args.workload}: this script reads {CELLS} "
                       "(control.py and control_nuts.py read the others)")
    reg = registry or Registry()
    spec = cell_spec(bench or load_benchmark(), args.workload)
    device = device or ("cuda:0" if torch.cuda.is_available() else "cpu")
    if device.startswith("cuda"):
        print(f"card (name, power limit): {run.power_line()}", flush=True)
    cell = reg.json("workloads", args.workload)
    cfg = reg.json("configs", spec["config"])
    mix = reg.json("traffic", spec["traffic"])
    kind = reg.module("traffic", mix["kind"])
    ref = reg.module("reference", spec["config"])
    model = reg.module("models", spec["config"])
    judge = reg.module("judges", f"{spec['config']}.{mix['kind']}")
    n = cell["check_queries"]
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        inputs = ref.make_inputs(cfg, seed)
        if args.mode in DTYPES:
            answers, layout = reference_answers(
                ref, cfg, mix, inputs, seed, n, device, DTYPES[args.mode])
        elif args.mode.startswith("fault:"):
            with faults_hybrid.plant(args.mode[len("fault:"):]):
                answers, layout = program_answers(kind, model, cfg, mix,
                                                  inputs, seed, n, device)
        elif args.mode == "program":
            answers, layout = program_answers(kind, model, cfg, mix, inputs,
                                              seed, n, device)
        else:
            raise KeyError(f"no mode {args.mode!r}")
        rng = np.random.default_rng(run.seed_of(seed, run.JUDGE_TAG))
        checks = judge.judge(ref, cfg, inputs, layout, answers,
                             cell["limits"], rng, mix)
        row = {name: v for name, v, _ in checks}
        for k, v in row.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(json.dumps(dict(mode=args.mode, seed=seed, readings=row,
                              seconds=time.perf_counter() - t0)), flush=True)
    print(json.dumps(dict(mode=args.mode, workload=args.workload,
                          worst=worst)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
