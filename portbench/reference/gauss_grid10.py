"""Plain reference of BASELINE config 2's grid Gaussian MRF at 10 x 10
(``configs/gauss_grid10.json``).

NumPy and plain PyTorch only: nothing of the program. The model, the
inputs and the streamed diagnostics are those of the 128 x 128 grid's
reference (``reference/gauss_grid128.py``), whose helpers this module
imports; at 82 latents the posterior is solved densely:

- ``posterior``: the exact mean and variance of every latent, by one dense
  float64 solve and inverse of the latent information matrix ``J_LL``;
- ``exact_moments``: the control, exact i.i.d. draws ``x = mean + L^-T z``
  (``J_LL = L L^T``) in a stated dtype, folded into sums and the same
  streamed diagnostics as the program's answers.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.gauss_grid128 import (  # noqa: F401
    StreamedDiagnostics, make_inputs, seed_sequence)
from portbench.reference.gauss_grid128 import \
    information_form as _sparse_information_form

_DRAW_TAG = 0x6E757473  # the control's stream of draws


def information_form(cfg: dict, inputs: dict):
    """(J_LL, h_L) as dense float64 arrays, latent nodes in ascending
    order."""
    J, h = _sparse_information_form(cfg, inputs)
    return J.toarray(), np.asarray(h, np.float64)


def posterior(cfg: dict, inputs: dict):
    """Exact posterior means and variances of every latent (float64)."""
    J, h = information_form(cfg, inputs)
    return np.linalg.solve(J, h), np.diag(np.linalg.inv(J)).copy()


@contextlib.contextmanager
def _no_tf32():
    """Float32 products in full float32 on the card, whatever the process
    set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def exact_moments(cfg: dict, inputs: dict, n_chains: int, n_warmup: int,
                  n_samples: int, seed: int, dtype=torch.float32,
                  device="cpu"):
    """Posterior means, variances and diagnostics (``StreamedDiagnostics``)
    of the latents from ``n_samples`` exact i.i.d. draws of each of
    ``n_chains`` chains (``n_warmup`` is accepted and unused: exact draws
    need no warmup). The mean and the factor ``L^-T`` are formed in
    float64, then every tensor, every draw and every sum is in ``dtype``,
    as a sampler of the program would stream them; it stands in for the
    program in the control."""
    J, h = information_form(cfg, inputs)
    mean = np.linalg.solve(J, h)
    factor = np.linalg.inv(np.linalg.cholesky(J)).T  # L^-T: cov = F F^T
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    mu, ft = t(mean), t(factor.T.copy())
    n = len(mean)
    gen = torch.Generator(device).manual_seed(
        int(seed_sequence(seed, _DRAW_TAG).generate_state(1)[0]))
    s1 = torch.zeros(n, dtype=dtype, device=device)
    s2 = torch.zeros(n, dtype=dtype, device=device)
    diag = StreamedDiagnostics(n_samples, torch.zeros(
        (n_chains, n), dtype=dtype, device=device))
    with _no_tf32():
        for k in range(n_samples):
            z = torch.randn((n_chains, n), generator=gen, dtype=dtype,
                            device=device)
            x = mu + z @ ft
            s1 = s1 + torch.sum(x, dim=0)
            s2 = s2 + torch.sum(x * x, dim=0)
            diag.add(k, x)
    n_obs = n_chains * n_samples
    m = s1 / n_obs
    v = s2 / n_obs - m * m

    def host(a):
        return a.double().cpu().numpy()

    return host(m), host(v), {k: host(a) for k, a in diag.result().items()}
