"""Lifted symmetry compression by colour refinement (colour passing):
the PyTorch port of ``lhvi_tpu/lift/color.py``.

RV colours start from (domain, evidence) and factor colours from the
potential's identity, then

    rv.color ← hash(rv.color, multiset of (nb-factor color, arg position))
    f.color  ← hash(f.color, tuple of nb RV colors)   # sorted if symmetric

until the numbers of colours stop changing. The groups are the RV orbits
and factor orbits of the symmetry the refinement detects. The refinement
runs on the host, once; its output is the compiled lifted IR: one
representative factor per factor orbit with ``scale = |orbit|``, variable
slots tied per RV orbit and per-slot orbit counts for the entropy terms.
Engines run unchanged on the lifted ``CompiledFG``; a query on any ground
RV resolves to its orbit's slot.

One deliberate difference from the reference: ``backend="auto"`` at
20,000 edges or more requires the native core and raises if it cannot be
built, where the reference falls back to Python without a word. Both
backends give the same partitions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from lhvi_tpu_torch.fg.compile import CompiledFG, compile_graph
from lhvi_tpu_torch.fg.graph import Graph


def color_refine(g: Graph, max_rounds: int = 10_000,
                 backend: str = "auto") -> Tuple[Dict, Dict]:
    """Run color passing to fixpoint.

    Returns ``(rv_color, f_color)``: dicts keyed by ``id(obj)`` with
    hashable color labels (ints after canonicalization).

    ``backend``: "auto" runs the native C++ core (``lhvi_tpu_torch.native``)
    on graphs with ≥ 20k edges and Python below; "native"/"python" force a
    choice. Both produce identical partitions; the native core raises if
    it cannot be built.
    """
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"color_refine: unknown backend {backend!r}")
    g.init_nb()
    n_edges = sum(len(f.nb) for f in g.factors)
    if backend == "native" or (backend == "auto" and n_edges >= 20_000):
        return _color_refine_native(g, max_rounds)
    rvc: Dict[int, int] = {}
    fc: Dict[int, int] = {}

    def canon(raw: Dict[int, object]) -> Dict[int, int]:
        lut: Dict[object, int] = {}
        return {k: lut.setdefault(v, len(lut)) for k, v in raw.items()}

    # init colors
    raw = {}
    for rv in g.rvs:
        dom = rv.domain
        ev = ("obs", rv.value) if rv.observed else ("lat",)
        raw[id(rv)] = (dom.continuous, dom.values, ev)
    rvc = canon(raw)
    fc = canon({id(f): f.potential.color_key() for f in g.factors})

    n_rv, n_f = len(set(rvc.values())), len(set(fc.values()))
    for _ in range(max_rounds):
        # factor colors see the ordered (or sorted, if symmetric) nb colors
        raw_f = {}
        for f in g.factors:
            nbc = [rvc[id(rv)] for rv in f.nb]
            if getattr(f.potential, "symmetric", False):
                nbc = sorted(nbc)
            raw_f[id(f)] = (fc[id(f)], tuple(nbc))
        fc = canon(raw_f)
        # rv colors see the multiset of (factor color, own position)
        raw_rv = {}
        for rv in g.rvs:
            sig = []
            for f in rv.nb:
                if getattr(f.potential, "symmetric", False):
                    sig.append((fc[id(f)], -1))
                else:
                    for pos, nb_rv in enumerate(f.nb):
                        if nb_rv is rv:
                            sig.append((fc[id(f)], pos))
            raw_rv[id(rv)] = (rvc[id(rv)], tuple(sorted(sig)))
        rvc = canon(raw_rv)

        n_rv2, n_f2 = len(set(rvc.values())), len(set(fc.values()))
        if (n_rv2, n_f2) == (n_rv, n_f):
            break
        n_rv, n_f = n_rv2, n_f2
    return rvc, fc


def _color_refine_native(g: Graph, max_rounds: int):
    """Array-ify the graph and run the C++ refinement core."""
    import ctypes

    from lhvi_tpu_torch.native import load_fastlift

    lib = load_fastlift()

    rvs = g.rvs
    rv_pos = {id(rv): i for i, rv in enumerate(rvs)}
    n_rv, n_f = len(rvs), len(g.factors)

    f_off = np.zeros(n_f + 1, np.int64)
    args = []
    f_sym = np.zeros(n_f, np.uint8)
    for i, f in enumerate(g.factors):
        f_off[i + 1] = f_off[i] + len(f.nb)
        args.extend(rv_pos[id(rv)] for rv in f.nb)
        f_sym[i] = 1 if getattr(f.potential, "symmetric", False) else 0
    f_rvs = np.asarray(args, np.int32)

    # initial colors: same keys as the Python path, canonicalized to ints
    def canon(keys):
        lut = {}
        return np.asarray(
            [lut.setdefault(k, len(lut)) for k in keys], np.int32
        )

    rv_color = canon(
        [
            (
                rv.domain.continuous,
                rv.domain.values,
                ("obs", rv.value) if rv.observed else ("lat",),
            )
            for rv in rvs
        ]
    )
    f_color = canon([f.potential.color_key() for f in g.factors])

    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    rounds = lib.lhvi_color_refine(
        n_rv,
        n_f,
        f_off.ctypes.data_as(p_i64),
        f_rvs.ctypes.data_as(p_i32),
        f_sym.ctypes.data_as(p_u8),
        rv_color.ctypes.data_as(p_i32),
        f_color.ctypes.data_as(p_i32),
        max_rounds,
    )
    if rounds < 0:
        raise RuntimeError("lhvi_color_refine rejected the graph's sizes")
    rvc = {id(rv): int(rv_color[i]) for i, rv in enumerate(rvs)}
    fc = {id(f): int(f_color[i]) for i, f in enumerate(g.factors)}
    return rvc, fc


def compile_lifted(g: Graph, device="cuda", pad_to: int = 8,
                   max_rounds: int = 10_000) -> CompiledFG:
    """Color-refine then compile the lifted IR (see module docstring) on
    ``device``, the card unless the caller names another.

    ``max_rounds`` truncates the refinement: fewer rounds → coarser
    partitions (round 0 groups purely by domain/evidence/potential type).
    The coarse-to-fine VI schedule (``engines.vi.infer_c2f``) exploits
    this hierarchy; the fixpoint partition is the exact lifted one.
    """
    rvc, fc = color_refine(g, max_rounds=max_rounds)

    cont_orbits: Dict[int, int] = {}
    disc_orbits: Dict[int, int] = {}
    var_overrides: Dict[int, Tuple[str, int]] = {}
    for rv in g.rvs:
        if rv.observed:
            continue
        c = rvc[id(rv)]
        if rv.domain.continuous:
            idx = cont_orbits.setdefault(c, len(cont_orbits))
            var_overrides[id(rv)] = ("c", idx)
        else:
            idx = disc_orbits.setdefault(c, len(disc_orbits))
            var_overrides[id(rv)] = ("d", idx)

    reps: Dict[int, object] = {}
    counts: Dict[int, int] = {}
    for f in g.factors:
        c = fc[id(f)]
        counts[c] = counts.get(c, 0) + 1
        reps.setdefault(c, f)

    cont_counts = np.zeros(max(len(cont_orbits), 0), np.float32)
    disc_counts = np.zeros(max(len(disc_orbits), 0), np.float32)
    for rv in g.rvs:
        if rv.observed:
            continue
        kind, idx = var_overrides[id(rv)]
        if kind == "c":
            cont_counts[idx] += 1
        else:
            disc_counts[idx] += 1

    sub = Graph(g.rvs, list(reps.values()))
    scales = {id(f): float(counts[c]) for c, f in reps.items()}
    fg = compile_graph(
        sub,
        device,
        pad_to=pad_to,
        scales=scales,
        var_overrides=var_overrides,
        n_cont_override=len(cont_orbits),
        n_disc_override=len(disc_orbits),
        cont_counts=cont_counts,
        disc_counts=disc_counts,
    )
    fg.meta.orbit_of = dict(var_overrides)
    return fg


def lifting_report(g: Graph) -> Dict[str, int]:
    """Compression stats (|V|, |F| → #orbits) for logging/tests."""
    rvc, fc = color_refine(g)
    return {
        "n_rvs": len(g.rvs),
        "n_factors": len(g.factors),
        "n_rv_orbits": len(set(rvc.values())),
        "n_factor_orbits": len(set(fc.values())),
    }
