"""lhvi_tpu_torch — the PyTorch / CUDA port of ``lhvi_tpu``.

A second package beside the JAX reference: the same DSL, the same
compiled IR and the same engine API, with plain functions on tensors and
hand-written CUDA kernels (``ops/csrc``) for Hopper. It imports torch and
numpy and never jax, flax or ``lhvi_tpu``.

Sampler paths run in f32: importing the package turns TF32 off for
float32 matrix products and cuDNN convolutions.
"""

import torch

from lhvi_tpu_torch.fg.graph import Domain, RV, F, Graph
from lhvi_tpu_torch.fg.compile import compile_graph, CompiledFG
from lhvi_tpu_torch.lift.color import compile_lifted

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "Domain",
    "RV",
    "F",
    "Graph",
    "compile_graph",
    "compile_lifted",
    "CompiledFG",
    "__version__",
]
