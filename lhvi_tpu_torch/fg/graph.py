"""Hybrid factor-graph DSL (host side) for the PyTorch port.

A copy of ``lhvi_tpu/fg/graph.py``, kept identical below this docstring:
the JAX package cannot be imported where the port runs (it pulls in jax
and flax), so the port carries its own framework-free DSL. ``Domain``
carries a ``continuous`` flag, value range and optional fixed
``integral_points``; ``RV.value`` doubles as the evidence slot (``None`` =
latent); ``F`` wires a potential to an ordered tuple of neighbor RVs;
``Graph.init_nb()`` builds RV↔factor adjacency.

These are host-side declaration objects only. Engines consume the tensor
IR produced by :func:`lhvi_tpu_torch.fg.compile.compile_graph`.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional, Sequence

import numpy as np


class Domain:
    """Variable domain: discrete (finite ``values``) or continuous (interval).

    Args:
      values: for discrete domains, the finite value list; for continuous
        domains, the ``(low, high)`` interval bounds.
      continuous: whether the domain is an interval of reals.
      integral_points: optional fixed quadrature/discretization sites used by
        discretizing engines (hybrid LBP); defaults to a uniform grid of 30
        points over ``(low, high)`` for continuous domains.
    """

    def __init__(
        self,
        values: Sequence[float],
        continuous: bool = False,
        integral_points: Optional[Sequence[float]] = None,
    ):
        self.values = tuple(float(v) for v in values)
        self.continuous = bool(continuous)
        if continuous:
            if len(self.values) != 2:
                raise ValueError("continuous Domain takes (low, high) bounds")
            lo, hi = self.values
            if integral_points is None:
                integral_points = np.linspace(lo, hi, 30)
        else:
            if integral_points is None:
                integral_points = np.asarray(self.values)
        self.integral_points = np.asarray(integral_points, dtype=np.float64)

    @property
    def size(self) -> int:
        """Number of values (discrete domains only)."""
        if self.continuous:
            raise ValueError("continuous domain has no finite size")
        return len(self.values)

    @property
    def low(self) -> float:
        return self.values[0]

    @property
    def high(self) -> float:
        return self.values[-1]

    def value_index(self, v) -> int:
        """Index of value ``v`` in a discrete domain (exact match)."""
        for i, u in enumerate(self.values):
            if u == v:
                return i
        raise ValueError(f"{v} not in domain {self.values}")

    def __repr__(self):
        kind = "cont" if self.continuous else "disc"
        return f"Domain({kind}, {self.values})"


class RV:
    """Random variable. ``value`` is the evidence slot (``None`` = latent)."""

    __slots__ = ("domain", "value", "nb", "name")

    def __init__(self, domain: Domain, value=None, name: Optional[str] = None):
        self.domain = domain
        self.value = value
        self.nb: list = []  # neighbor factors, filled by Graph.init_nb()
        self.name = name

    @property
    def observed(self) -> bool:
        return self.value is not None

    def __repr__(self):
        tag = self.name or hex(id(self))[-6:]
        ev = f"={self.value}" if self.observed else ""
        return f"RV({tag}{ev})"


class F:
    """Factor: a potential applied to an ordered tuple of neighbor RVs."""

    __slots__ = ("potential", "nb")

    def __init__(self, potential=None, nb: Iterable[RV] = ()):
        self.potential = potential
        self.nb = tuple(nb)

    def __repr__(self):
        return f"F({type(self.potential).__name__}, arity={len(self.nb)})"


class Graph:
    """A hybrid Markov random field: a set of RVs and factors over them."""

    def __init__(self, rvs: Iterable[RV] = (), factors: Iterable[F] = ()):
        self.rvs: list[RV] = list(rvs)
        self.factors: list[F] = list(factors)

    def init_nb(self) -> "Graph":
        """Build RV↔factor adjacency (reference ``Graph.init_nb`` parity)."""
        for rv in self.rvs:
            rv.nb = []
        for f in self.factors:
            for rv in f.nb:
                rv.nb.append(f)
        return self

    def add_rv(self, rv: RV) -> RV:
        self.rvs.append(rv)
        return rv

    def add_factor(self, f: F) -> F:
        self.factors.append(f)
        return f

    # --- conveniences used by tests/oracles -------------------------------
    def latent_rvs(self) -> list[RV]:
        return [rv for rv in self.rvs if not rv.observed]

    def discrete_latents(self) -> list[RV]:
        return [rv for rv in self.latent_rvs() if not rv.domain.continuous]

    def continuous_latents(self) -> list[RV]:
        return [rv for rv in self.latent_rvs() if rv.domain.continuous]

    def __repr__(self):
        return f"Graph(|V|={len(self.rvs)}, |F|={len(self.factors)})"


def enumerate_discrete_assignments(rvs: Sequence[RV]):
    """Yield dicts mapping each discrete RV to one of its domain values."""
    doms = [rv.domain.values for rv in rvs]
    for combo in itertools.product(*doms):
        yield dict(zip(rvs, combo))
