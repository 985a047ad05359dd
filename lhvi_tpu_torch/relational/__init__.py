"""The relational layer of the port: grounding (``graph``) and evidence
files (``data``). The vectorized relational compiler (the reference's
``relational/fast.py``) arrives with the pod-flagship slice."""

from lhvi_tpu_torch.relational.graph import RelationalGraph, Predicate, Atom, ParamF
from lhvi_tpu_torch.relational.data import load_evidence, parse_evidence_line

__all__ = ["RelationalGraph", "Predicate", "Atom", "ParamF",
           "load_evidence", "parse_evidence_line"]
