from lhvi_tpu_torch.fg.graph import Domain, RV, F, Graph
from lhvi_tpu_torch.fg.compile import compile_graph, CompiledFG, FactorBucket

__all__ = ["Domain", "RV", "F", "Graph", "compile_graph", "CompiledFG", "FactorBucket"]
