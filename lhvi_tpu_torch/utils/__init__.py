"""Utilities of the port: the exact-posterior oracle, sampler diagnostics,
metrics logging and profiling, NaN checks, checkpoints and the converters
from the reference's arrays (``convert``)."""

from lhvi_tpu_torch.utils.oracle import ExactPosterior
from lhvi_tpu_torch.utils.diagnostics import split_rhat, ess, summarize
from lhvi_tpu_torch.utils.metrics import MetricsLogger, profile_trace
from lhvi_tpu_torch.utils.debug import enable_nan_checks, nan_checks

__all__ = [
    "ExactPosterior",
    "split_rhat",
    "ess",
    "summarize",
    "MetricsLogger",
    "profile_trace",
    "enable_nan_checks",
    "nan_checks",
]
