"""Relational (first-order / MLN) layer: templates → ground factor graphs
(PyTorch port of ``lhvi_tpu/relational/graph.py``).

A copy of the reference's framework-free module, identical below this
docstring except that it imports the port's ``fg/graph.py``: ``Atom``
names a predicate applied to logical variables; ``ParamF`` couples a
potential to an atom tuple with an optional substitution constraint;
``ground()`` substitutes every combination of constants, get-or-creates
ground RVs keyed by ``(predicate, args)`` and instantiates one ground
factor per substitution. Evidence is loaded into ``RV.value`` slots by
key. Grounding runs once on the host; its output feeds ``compile_graph``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from lhvi_tpu_torch.fg.graph import Domain, F, Graph, RV


class Predicate:
    """A predicate symbol with a value domain and fixed arity."""

    def __init__(self, name: str, domain: Domain, arity: int):
        self.name = name
        self.domain = domain
        self.arity = arity

    def __call__(self, *lvars: str) -> "Atom":
        if len(lvars) != self.arity:
            raise ValueError(
                f"{self.name} has arity {self.arity}, got {len(lvars)} args"
            )
        return Atom(self, tuple(lvars))

    def __repr__(self):
        return f"Predicate({self.name}/{self.arity})"


class Atom:
    """A predicate applied to logical variables (or constants)."""

    def __init__(self, pred: Predicate, args: Tuple[str, ...]):
        self.pred = pred
        self.args = args

    def __repr__(self):
        return f"{self.pred.name}({', '.join(map(str, self.args))})"


class ParamF:
    """Parametrized factor: one potential template over an atom tuple."""

    def __init__(
        self,
        potential,
        atoms: Sequence[Atom],
        constraint: Optional[Callable[[Dict[str, str]], bool]] = None,
    ):
        self.potential = potential
        self.atoms = tuple(atoms)
        self.constraint = constraint


class RelationalGraph:
    """First-order model: logical variables + predicates + ParamF templates."""

    def __init__(self):
        self.lvs: Dict[str, List[str]] = {}
        self.preds: Dict[str, Predicate] = {}
        self.param_fs: List[ParamF] = []
        self.evidence: Dict[Tuple[str, Tuple[str, ...]], float] = {}

    def lv(self, name: str, constants: Iterable[str]) -> str:
        """Declare a logical-variable sort (returns its name for reuse)."""
        self.lvs[name] = list(constants)
        return name

    def predicate(self, name: str, domain: Domain, arity: int = None,
                  lvs: Sequence[str] = None) -> Predicate:
        if arity is None:
            arity = len(lvs) if lvs is not None else 1
        p = Predicate(name, domain, arity)
        self.preds[name] = p
        return p

    def param_factor(self, potential, atoms: Sequence[Atom],
                     constraint=None) -> ParamF:
        pf = ParamF(potential, atoms, constraint)
        self.param_fs.append(pf)
        return pf

    def observe(self, pred: Predicate | str, args: Sequence[str], value):
        name = pred if isinstance(pred, str) else pred.name
        self.evidence[(name, tuple(args))] = value

    def observe_many(self, items: Dict[Tuple[str, Tuple[str, ...]], float]):
        self.evidence.update(items)

    # ------------------------------------------------------------------
    def ground(self) -> Tuple[Graph, Dict[Tuple[str, Tuple[str, ...]], RV]]:
        """Ground all templates (SURVEY.md §4.1 trace).

        Returns ``(graph, index)`` where ``index[(pred_name, constants)]``
        is the ground RV.
        """
        index: Dict[Tuple[str, Tuple[str, ...]], RV] = {}
        factors: List[F] = []

        def get_rv(pred: Predicate, consts: Tuple[str, ...]) -> RV:
            key = (pred.name, consts)
            if key not in index:
                rv = RV(pred.domain, name=f"{pred.name}({','.join(consts)})")
                if key in self.evidence:
                    rv.value = self.evidence[key]
                index[key] = rv
            return index[key]

        for pf in self.param_fs:
            # logical variables of this template, in first-appearance order
            lv_names: List[str] = []
            for atom in pf.atoms:
                for a in atom.args:
                    if a in self.lvs and a not in lv_names:
                        lv_names.append(a)
            domains = [self.lvs[n] for n in lv_names]
            for combo in itertools.product(*domains) if lv_names else [()]:
                subst = dict(zip(lv_names, combo))
                if pf.constraint is not None and not pf.constraint(subst):
                    continue
                nb = []
                for atom in pf.atoms:
                    consts = tuple(subst.get(a, a) for a in atom.args)
                    nb.append(get_rv(atom.pred, consts))
                factors.append(F(pf.potential, nb))

        g = Graph(list(index.values()), factors)
        g.init_nb()
        return g, index
