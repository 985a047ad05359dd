"""Split one cell's query by the program's own layers, on the card.

    python3 portbench/split.py --workload <cell> --seed <n> \
        [--queries <k>] [--out <file.json>]

Set-up as ``run.py`` makes it (inputs from the seed, the model built and
compiled, one warm query), then three phases of ``k`` queries each (the
cell's ``trace_queries`` by default) in one closed loop:

1. untraced: the program's tracer off, no profiler (the phase ``step_mfu``
   reads);
2. spans only: the tracer on (``lhvi_tpu_torch.utils.metrics.tracing()``),
   no profiler; the host time by span (``spans.host_split``), and the
   phase's seconds beside the untraced phase's are the cost of tracing
   when it is on. It runs before the profiler starts;
3. profiled: the tracer on under ``torch.profiler``, so each span is a
   user annotation on the kernels' clock; the device time and idle are
   split by span (``spans.split``), as ``trace.summarize`` reduces the
   same events.

Every per-layer reader of ``metrics/`` that reads the sampler's queries is
applied to the result (the six span readers among them), with the
identities they keep: ``device_idle.loop`` + ``device_idle.edges`` =
``device_idle.sample``, the device time split by span summed against the
busy time. The last line of standard output is the result as one JSON
object, written to ``--out`` too. Without a CUDA card, or with a program
that has no tracer, it exits with 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run, spans, trace  # noqa: E402
from portbench.registry import Registry, cell_spec, load_benchmark  # noqa: E402

READERS = ("launches_per_transition", "proposal_roofline", "step_mfu",
           "device_idle.sample", "device_ms.transition", "device_ms.moments",
           "host_ms.transition", "host_ms.moments", "device_idle.loop",
           "device_idle.edges")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--queries", type=int, default=0,
                    help="queries a phase (default: the cell's trace_queries)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def phases(kind, fg, mix, device, seed, k, reservoir, tracer):
    """The three phases of ``k`` queries; returns the reader's context
    entries (``queries``, ``window_s``, ``trace``, ``untraced``, ``split``,
    ``spans_only``)."""
    from torch.profiler import ProfilerActivity, profile

    enough = lambda n, _: n >= k  # noqa: E731
    plain, plain_s, _ = run.closed_loop(kind, fg, mix, device, seed,
                                        reservoir, 0, enough)
    tracer.reset_tracing()
    with tracer.tracing():
        only, only_s, _ = run.closed_loop(kind, fg, mix, device, seed,
                                          reservoir, k, enough)
    so = dict(host_s=spans.host_split(tracer.spans()),
              counts=dict(tracer.counters()), seconds=only_s,
              queries=only)
    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    tracer.reset_tracing()
    prof = profile(activities=acts)
    with tracer.tracing():
        prof.start()
        queries, window_s, _ = run.closed_loop(kind, fg, mix, device, seed,
                                               reservoir, 2 * k, enough)
        run.sync(device)
        prof.stop()
    counts = dict(tracer.counters())
    events = prof.profiler.kineto_results.events()
    summary = trace.summarize(events, window_s)
    sp = dict(spans.split(events, window_s), counts=counts)
    tracer.reset_tracing()
    return dict(queries=queries, window_s=window_s, trace=summary,
                untraced=dict(queries=plain, seconds=plain_s), split=sp,
                spans_only=so)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the split runs only on the card", file=sys.stderr)
        return 2
    from lhvi_tpu_torch.utils import metrics as tracer

    if not hasattr(tracer, "tracing"):
        print("the program has no tracer (lhvi_tpu_torch.utils.metrics."
              "tracing)", file=sys.stderr)
        return 2
    device = "cuda:0"
    reg = Registry()
    spec = cell_spec(load_benchmark(), args.workload)
    cell = reg.json("workloads", args.workload)
    cfg = reg.json("configs", spec["config"])
    mix = reg.json("traffic", spec["traffic"])
    kind = reg.module("traffic", mix["kind"])
    ref = reg.module("reference", spec["config"])
    model = reg.module("models", spec["config"])
    card = run.power_line()

    t0 = time.perf_counter()
    built = model.build(cfg, ref.make_inputs(cfg, args.seed), device)
    kind.warm(built["fg"], mix, run.generator(device, args.seed,
                                              run.WARM_TAG))
    run.sync(device)
    setup_s = time.perf_counter() - t0
    k = args.queries or cell["trace_queries"]
    parts = phases(kind, built["fg"], mix, device, args.seed, k,
                   run.Reservoir(0, args.seed), tracer)
    ctx = types.SimpleNamespace(setup_s=setup_s,
                                compile_s=built["compile_s"], mix=mix,
                                cfg=cfg, cell=cell, **parts)
    metrics = {}
    for name in READERS:
        value = reg.module("metrics", name).read(ctx)
        if value is not None:
            metrics[name] = float(value)
    sp, so, summary = parts["split"], parts["spans_only"], parts["trace"]
    per_query = lambda q, s: s / len(q)  # noqa: E731
    result = dict(
        workload=args.workload, seed=args.seed, queries_a_phase=k,
        card=card, metrics=metrics,
        identities=dict(
            idle_parts_minus_sample_pp=(
                metrics.get("device_idle.loop", 0.0)
                + metrics.get("device_idle.edges", 0.0)
                - metrics.get("device_idle.sample", 0.0)),
            device_split_over_busy=(sum(sp["device_s"].values())
                                    / summary["busy_s"])),
        seconds_a_query=dict(
            untraced=per_query(parts["untraced"]["queries"],
                               parts["untraced"]["seconds"]),
            profiled=per_query(parts["queries"], parts["window_s"]),
            spans_only=per_query(so["queries"], so["seconds"])),
        split=dict(device_s=sp["device_s"], idle_s=sp["idle_s"],
                   edge_s=sp["edge_s"], busy_s=sp["busy_s"],
                   window_s=sp["window_s"], counts=sp["counts"],
                   n_device_ops=sp["n_device_ops"],
                   n_unlaunched=sp["n_unlaunched"], n_spans=sp["n_spans"],
                   device_ops=sp["device_ops"]),
        host_s=so["host_s"], host_counts=so["counts"],
        breakdown=dict(device_ops=summary["device_ops"],
                       idle_gaps=summary["idle_gaps"]))
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
