"""The relational layer of the port: grounding (``graph``), evidence
files (``data``) and the vectorized relational compiler (``fast``), which
grounds a ``RelationalGraph`` straight to the array IR."""

from lhvi_tpu_torch.relational.graph import RelationalGraph, Predicate, Atom, ParamF
from lhvi_tpu_torch.relational.data import load_evidence, parse_evidence_line
from lhvi_tpu_torch.relational.fast import fast_compile

__all__ = ["RelationalGraph", "Predicate", "Atom", "ParamF",
           "load_evidence", "parse_evidence_line", "fast_compile"]
