"""Sampler diagnostics: split-R̂ and effective sample size (PyTorch port of
``lhvi_tpu/utils/diagnostics.py``).

Computed on the device from the ``[S, C, n]`` sample tensors the engines
emit with ``collect="samples"``, with the reference's arithmetic: the
reference's ``vmap`` over lags is a loop over lags here.
"""

from __future__ import annotations

import torch


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split-R̂ (Gelman et al.) per dimension.

    samples: [S, C, n] (draws, chains, dims) → [n]. Values near 1 indicate
    convergence; > 1.01 is suspicious.
    """
    S, C, n = samples.shape
    half = S // 2
    x = torch.cat([samples[:half], samples[half: 2 * half]], dim=1)
    chain_mean = torch.mean(x, dim=0)  # [2C, n]
    chain_var = torch.var(x, dim=0, correction=1)  # [2C, n]
    B = half * torch.var(chain_mean, dim=0, correction=1)
    W = torch.mean(chain_var, dim=0)
    var_hat = (half - 1) / half * W + B / half
    return torch.sqrt(var_hat / torch.clamp(W, min=1e-12))


def ess(samples: torch.Tensor, max_lag: int = 200) -> torch.Tensor:
    """Effective sample size per dimension via Geyer initial-positive-pair
    autocorrelation truncation (FFT-free).

    samples: [S, C, n] → [n].
    """
    S, C, n = samples.shape
    max_lag = min(max_lag, S - 1)
    x = samples - torch.mean(samples, dim=0, keepdim=True)
    var = torch.mean(torch.var(samples, dim=0, correction=1), dim=0)  # [n]
    denom_var = torch.clamp(var, min=1e-12)
    rhos = []
    for lag in range(1, max_lag + 1):
        # the reference's roll-and-mask: lag-products of the first S − lag
        # draws
        prod = x[: S - lag] * x[lag:]
        rhos.append(torch.sum(prod, dim=(0, 1)) / ((S - lag) * C * denom_var))
    rhos = (torch.stack(rhos) if rhos
            else torch.zeros((0, n), dtype=samples.dtype,
                             device=samples.device))  # [max_lag, n]
    # Geyer: sum consecutive pairs while positive
    k = max_lag // 2
    pairs = rhos[0::2][:k] + rhos[1::2][:k]
    pos = torch.cumprod((pairs > 0).to(samples.dtype), dim=0)
    # rhos[0]·0 carries a non-finite lag-1 autocorrelation through, as the
    # reference's does
    tau = 1.0 + 2.0 * (rhos[0] * 0.0 + torch.sum(pairs * pos, dim=0))
    tau = torch.clamp(tau, min=1.0)
    return S * C / tau


def summarize(samples: torch.Tensor) -> dict:
    """{'rhat': [n], 'ess': [n], 'mean': [n], 'sd': [n]} for [S, C, n]."""
    return {
        "rhat": split_rhat(samples),
        "ess": ess(samples),
        "mean": torch.mean(samples, dim=(0, 1)),
        "sd": torch.std(samples, dim=(0, 1), correction=0),
    }
