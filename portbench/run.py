"""Run one cell of the benchmark of lhvi_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the configuration's inputs from the seed, builds the model
with the port's DSL, compiles it with the port's compiler and warms the
cell's shapes with one short query. The window is then a closed loop of
queries from one client, each through the port's public entry with a
generator of its own, each ending when its results are on the host; it
ends at the end of the query that crosses ``--seconds``. With
``--trace 1`` the cell's ``trace_queries`` queries are timed untraced,
then as many more run under ``torch.profiler``, and the result holds the
per-layer metrics.

After the window: the peak of device memory is read, the program's state
freed, a sample of the answers drawn from the seed compared with the plain
reference, and the metrics read. As the last step before the result, the
loaded modules are checked (no ``jax``, ``jaxlib``, ``flax`` or
``lhvi_tpu``) and so are the imports of every file of the benchmark. The
last line of standard output is the result as one JSON object. Without a
CUDA card the run exits with 2 and prints no result; with a forbidden
module loaded or imported, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

_CHECKOUT = Path(__file__).resolve().parent.parent
if str(_CHECKOUT) not in sys.path:
    sys.path.insert(0, str(_CHECKOUT))

# few host threads; the port builds its kernels once into its own
# lhvi_tpu_torch/ops/_build/, inside the checkout
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "4")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import guard, trace  # noqa: E402
from portbench.registry import (PKG, Registry, cell_spec,  # noqa: E402
                                load_benchmark)

EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def seed_of(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for one stream of ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed_of(seed, *tags))


WARM_TAG, QUERY_TAG, SAMPLE_TAG, JUDGE_TAG = 1, 2, 3, 4


class Reservoir:
    """A uniform sample of ``k`` of the answers of the window, drawn from
    the seed (every answer is seen once; the sample is the same for the
    same seed and the same number of queries)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items = k, []
        self.rng = np.random.default_rng(seed_of(seed, SAMPLE_TAG))
        self.n = 0

    def offer(self, item) -> None:
        if self.n < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


def power_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e.__class__.__name__})"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def closed_loop(kind, fg, mix, device, seed, reservoir, first, done):
    """Queries ``first, first + 1, ...`` from one client, each with its own
    generator, until ``done(n_queries, seconds)``; returns (queries,
    seconds, n_failed)."""
    queries, n_failed = [], 0
    t0 = time.perf_counter()
    while True:
        gen = generator(device, seed, QUERY_TAG, first + len(queries))
        tq = time.perf_counter()
        answer, work = kind.query(fg, mix, gen)
        queries.append(dict(wall_s=time.perf_counter() - tq, **work))
        n_failed += not kind.finite(answer)
        reservoir.offer(answer)
        if done(len(queries), time.perf_counter() - t0):
            return queries, time.perf_counter() - t0, n_failed


def traced_window(kind, fg, mix, device, seed, n_traced, reservoir):
    """``n_traced`` queries timed untraced, then ``n_traced`` more under
    ``torch.profiler``; returns (untraced queries and their seconds,
    traced queries, their seconds, the trace's summary, n_failed)."""
    from torch.profiler import ProfilerActivity, profile

    enough = lambda n, _: n >= n_traced  # noqa: E731
    plain, plain_s, failed = closed_loop(kind, fg, mix, device, seed,
                                         reservoir, 0, enough)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    queries, window_s, f2 = closed_loop(kind, fg, mix, device, seed,
                                        reservoir, n_traced, enough)
    sync(device)
    prof.stop()
    summary = trace.summarize(prof.profiler.kineto_results.events(),
                              window_s)
    return (dict(queries=plain, seconds=plain_s), queries, window_s,
            summary, failed + f2)


def main(argv=None, registry: Registry = None, bench: dict = None,
         device=None, require_card: bool = True, out=None, err=None) -> int:
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)
    reg = registry or Registry()
    spec = cell_spec(bench or load_benchmark(), args.workload)

    if require_card:
        if not torch.cuda.is_available():
            print("no CUDA card: this benchmark runs only on the card",
                  file=err)
            return EXIT_NO_CARD
        if torch.cuda.device_count() < spec["chips"]:
            print(f"the cell needs {spec['chips']} cards, "
                  f"{torch.cuda.device_count()} found", file=err)
            return EXIT_NO_CARD
        device = device or "cuda:0"
        print(f"card (name, power limit): {power_line()}", file=err)
    device = device or "cpu"
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

    cell = reg.json("workloads", args.workload)
    cfg = reg.json("configs", spec["config"])
    mix = reg.json("traffic", spec["traffic"])
    kind = reg.module("traffic", mix["kind"])
    ref = reg.module("reference", spec["config"])
    model = reg.module("models", spec["config"])
    judge = reg.module("judges", f"{spec['config']}.{mix['kind']}")

    # ---- set-up ---------------------------------------------------------
    inputs = ref.make_inputs(cfg, args.seed)
    built = model.build(cfg, inputs, device)
    kind.warm(built["fg"], mix, generator(device, args.seed, WARM_TAG))
    sync(device)
    setup_s = time.perf_counter() - T_START

    # ---- the window -----------------------------------------------------
    reservoir = Reservoir(cell["check_queries"], args.seed)
    untraced = summary = None
    if args.trace:
        untraced, queries, window_s, summary, n_failed = traced_window(
            kind, built["fg"], mix, device, args.seed, cell["trace_queries"],
            reservoir)
    else:
        queries, window_s, n_failed = closed_loop(
            kind, built["fg"], mix, device, args.seed, reservoir, 0,
            lambda _, elapsed: elapsed >= args.seconds)
    attempted = len(queries) + (len(untraced["queries"]) if untraced else 0)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    layout, compile_s = built["layout"], built["compile_s"]
    del built
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- correctness ----------------------------------------------------
    rng = np.random.default_rng(seed_of(args.seed, JUDGE_TAG))
    checks = judge.judge(ref, cfg, inputs, layout, reservoir.items,
                         cell["limits"], rng, mix)
    correct = n_failed == 0 and all(v <= lim for _, v, lim in checks)

    # ---- metrics --------------------------------------------------------
    ctx = types.SimpleNamespace(
        queries=queries, window_s=window_s, setup_s=setup_s,
        compile_s=compile_s, trace=summary, untraced=untraced, mix=mix,
        cfg=cfg, cell=cell)
    metrics = {}
    for m in spec["per_layer" if args.trace else "end_to_end"]:
        value = reg.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    dev_info = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(device) if on_card else "cpu",
        count=spec["chips"] if on_card else 0,
        memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=attempted,
                  failed=n_failed, metrics=metrics, device=dev_info)
    if summary is not None:
        dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    # a non-finite reading (an answer with nan or inf) prints as null
    result["checks"] = {name: dict(value=v if np.isfinite(v) else None,
                                   limit=lim) for name, v, lim in checks}

    # ---- guards, the last step before the result ------------------------
    bad = guard.forbidden_loaded(list(sys.modules))
    bad += guard.source_offences(PKG)
    if bad:
        print(f"forbidden modules or imports: {bad}", file=err)
        return EXIT_FORBIDDEN
    print(json.dumps(result), file=out)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=err)
    out.flush()
    err.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
