"""Built-in potential library (PyTorch port of ``lhvi_tpu/potentials/library.py``).

``TablePotential``, ``GaussianPotential``, ``LinearGaussianPotential``,
``QuadraticPotential``, ``XYPotential``, ``ImageNodePotential``,
``ImageEdgePotential``, ``MLNPotential``: the same host-side parameters
and bucket keys as the reference, with torch kernels. Every type with
continuous arguments also has the reference's factor-minor
``kernel_planar`` (see ``potentials.base``), which the fused
log-potential kernel traces. All kernels are
log-space and batched (see ``potentials.base``). Parameters are stored
f32; quadratic forms accumulate in f32.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from lhvi_tpu_torch.potentials.base import Potential

_HARD_PENALTY = 1e6


def select_last(vals, idx):
    """``vals[..., idx]`` per element after broadcasting ``vals[..., V]``
    against ``idx``; out-of-range indices yield 0 (the compiler's padding
    rows carry zero weight), as the reference's ``ops/select.py`` does."""
    V = vals.shape[-1]
    shape = torch.broadcast_shapes(vals.shape[:-1], idx.shape)
    i = idx.expand(shape).long()
    ok = (i >= 0) & (i < V)
    got = torch.gather(vals.expand(shape + (V,)), -1,
                       i.clamp(0, V - 1).unsqueeze(-1)).squeeze(-1)
    return torch.where(ok, got, torch.zeros((), dtype=got.dtype,
                                            device=got.device))


class GaussianPotential(Potential):
    """Multivariate Gaussian potential over its (continuous) arguments.

    ``log φ(x) = log_coef − ½ (x−μ)ᵀ Σ⁻¹ (x−μ)``; with ``normalized=True``
    ``log_coef = −½ log((2π)^a |Σ|)`` so φ is the Gaussian density.
    """

    symmetric = False

    def __init__(self, mu: Sequence[float], sig, normalized: bool = True):
        self.mu = np.asarray(mu, np.float32)
        sig = np.asarray(sig, np.float64)
        self.sig = sig.astype(np.float32)
        self.prec = np.linalg.inv(sig).astype(np.float32)
        a = self.mu.shape[0]
        if normalized:
            sign, logdet = np.linalg.slogdet(sig)
            self.log_coef = np.float32(-0.5 * (a * np.log(2 * np.pi) + logdet))
        else:
            self.log_coef = np.float32(0.0)

    def bucket_key(self):
        return ("gaussian", self.mu.shape[0])

    def param_arrays(self):
        return {
            "mu": self.mu,
            "prec": self.prec,
            "log_coef": np.asarray(self.log_coef, np.float32),
        }

    def kernel(self, pattern):
        def log_pot(params, xc, xdi, xdv):
            d = xc - params["mu"]
            quad = torch.einsum("...i,...ij,...j->...", d, params["prec"], d)
            return params["log_coef"] - 0.5 * quad

        return log_pot

    def kernel_planar(self, pattern):
        a = self.mu.shape[0]

        def log_pot(params, slots):
            d = [slots[i] - params["mu"][i : i + 1] for i in range(a)]
            quad = 0.0
            for i in range(a):  # arity is tiny: unrolled
                for j in range(a):
                    pij = params["prec"][i * a + j : i * a + j + 1]
                    quad = quad + pij * d[i] * d[j]
            return params["log_coef"][0:1] - 0.5 * quad

        return log_pot


class LinearGaussianPotential(Potential):
    """Pairwise linear-Gaussian coupling: ``log φ(x,y) = −(y − coeff·x)² / (2σ²)``."""

    symmetric = False

    def __init__(self, coeff: float, sig: float):
        self.coeff = np.float32(coeff)
        self.sig = np.float32(sig)  # variance, matching reference naming

    def bucket_key(self):
        return ("linear_gaussian",)

    def param_arrays(self):
        return {
            "coeff": np.asarray(self.coeff),
            "sig": np.asarray(self.sig),
        }

    def kernel(self, pattern):
        def log_pot(params, xc, xdi, xdv):
            r = xc[..., 1] - params["coeff"] * xc[..., 0]
            return -(r * r) / (2.0 * params["sig"])

        return log_pot

    def kernel_planar(self, pattern):
        def log_pot(params, slots):
            r = slots[1] - params["coeff"][0:1] * slots[0]
            return -(r * r) / (2.0 * params["sig"][0:1])

        return log_pot


class QuadraticPotential(Potential):
    """General quadratic log-potential ``log φ(x) = xᵀAx + bᵀx + c``."""

    symmetric = False

    def __init__(self, A, b, c: float = 0.0):
        self.A = np.atleast_2d(np.asarray(A, np.float32))
        self.b = np.atleast_1d(np.asarray(b, np.float32))
        self.c = np.float32(c)

    def bucket_key(self):
        return ("quadratic", self.b.shape[0])

    def param_arrays(self):
        return {"A": self.A, "b": self.b, "c": np.asarray(self.c)}

    def kernel(self, pattern):
        def log_pot(params, xc, xdi, xdv):
            quad = torch.einsum("...i,...ij,...j->...", xc, params["A"], xc)
            lin = torch.einsum("...i,...i->...", params["b"], xc)
            return quad + lin + params["c"]

        return log_pot

    def kernel_planar(self, pattern):
        a = self.b.shape[0]

        def log_pot(params, slots):
            out = params["c"][0:1] + 0.0 * slots[0]
            for i in range(a):
                out = out + params["b"][i : i + 1] * slots[i]
                for j in range(a):
                    aij = params["A"][i * a + j : i * a + j + 1]
                    out = out + aij * slots[i] * slots[j]
            return out

        return log_pot


class XYPotential(Potential):
    """Product coupling ``log φ(x,y) = coeff · x · y / sig`` (attractive for
    coeff>0)."""

    symmetric = True

    def __init__(self, coeff: float = 1.0, sig: float = 1.0):
        self.coeff = np.float32(coeff)
        self.sig = np.float32(sig)

    def bucket_key(self):
        return ("xy",)

    def param_arrays(self):
        return {"coeff": np.asarray(self.coeff), "sig": np.asarray(self.sig)}

    def kernel(self, pattern):
        def log_pot(params, xc, xdi, xdv):
            return params["coeff"] * xc[..., 0] * xc[..., 1] / params["sig"]

        return log_pot

    def kernel_planar(self, pattern):
        def log_pot(params, slots):
            return (params["coeff"][0:1] * slots[0] * slots[1]
                    / params["sig"][0:1])

        return log_pot


class TablePotential(Potential):
    """Tabular potential over discrete arguments.

    ``table`` is the potential value array (one axis per argument); stored
    and evaluated in log space. Row-major flattening + stride arithmetic so
    a whole bucket gathers with one ``torch.gather``.
    """

    symmetric = False

    def __init__(self, table, log: bool = False):
        t = np.asarray(table, np.float64)
        self.shape = t.shape
        logt = t if log else np.log(np.maximum(t, 1e-300))
        self.log_table = logt.astype(np.float32).reshape(-1)
        strides = np.ones(len(self.shape), np.int32)
        for i in range(len(self.shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * self.shape[i + 1]
        self.strides = strides

    def bucket_key(self):
        return ("table", self.shape)

    def param_arrays(self):
        return {"log_table": self.log_table, "strides": self.strides}

    def kernel(self, pattern):
        def log_pot(params, xc, xdi, xdv):
            flat = torch.sum(xdi * params["strides"], dim=-1)
            return select_last(params["log_table"], flat)

        return log_pot


class MLNPotential(Potential):
    """Weighted-formula potential for (hybrid) Markov Logic.

    ``log φ(args) = w · truth(formula(args))`` where ``formula`` is a
    function over the *ordered* argument tuple (continuous slots are real
    tensors, discrete slots are domain-value tensors) returning a soft
    truth value in [0, 1]. ``w=None`` declares a hard constraint:
    violations are penalized by ``−1e6·(1−truth)``. Formulas written with
    plain arithmetic or the combinators below run in both packages.

    ``formula_name`` keys the bucket: factors with the same formula+weight
    structure batch together.
    """

    symmetric = False

    def __init__(self, formula: Callable, w: float = 1.0, formula_name: str = None):
        self.formula = formula
        self.hard = w is None
        self.w = np.float32(_HARD_PENALTY if self.hard else w)
        self.formula_name = formula_name or getattr(
            formula, "__name__", repr(formula)
        )

    def bucket_key(self):
        return ("mln", self.formula_name, self.hard)

    def param_arrays(self):
        return {"w": np.asarray(self.w)}

    def color_key(self):
        return (self.bucket_key(), float(self.w))

    def kernel(self, pattern):
        formula, hard = self.formula, self.hard

        def log_pot(params, xc, xdi, xdv):
            args, ci, di = [], 0, 0
            for is_cont in pattern:
                if is_cont:
                    args.append(xc[..., ci])
                    ci += 1
                else:
                    args.append(xdv[..., di])
                    di += 1
            truth = formula(args)
            if hard:
                return params["w"] * (truth - 1.0)
            return params["w"] * truth

        return log_pot

    def kernel_planar(self, pattern):
        formula, hard = self.formula, self.hard

        def log_pot(params, slots):
            truth = formula(list(slots))
            if hard:
                return params["w"][0:1] * (truth - 1.0)
            return params["w"][0:1] * truth

        return log_pot


class ImageNodePotential(Potential):
    """Unary image potential tying a latent pixel to its observation:
    ``log φ(x, y) = −(x−y)² / (2α)``."""

    symmetric = True

    def __init__(self, alpha: float):
        self.alpha = np.float32(alpha)

    def bucket_key(self):
        return ("image_node",)

    def param_arrays(self):
        return {"alpha": np.asarray(self.alpha)}

    def kernel(self, pattern):
        def log_pot(params, xc, xdi, xdv):
            d = xc[..., 0] - xc[..., 1]
            return -(d * d) / (2.0 * params["alpha"])

        return log_pot

    def kernel_planar(self, pattern):
        def log_pot(params, slots):
            d = slots[0] - slots[1]
            return -(d * d) / (2.0 * params["alpha"][0:1])

        return log_pot


class ImageEdgePotential(Potential):
    """Robust truncated pairwise smoothness:
    ``log φ(x, y) = −min(|x−y|, cap) / scale``."""

    symmetric = True

    def __init__(self, distance_cap: float, scale: float):
        self.cap = np.float32(distance_cap)
        self.scale = np.float32(scale)

    def bucket_key(self):
        return ("image_edge",)

    def param_arrays(self):
        return {"cap": np.asarray(self.cap), "scale": np.asarray(self.scale)}

    def kernel(self, pattern):
        def log_pot(params, xc, xdi, xdv):
            d = torch.abs(xc[..., 0] - xc[..., 1])
            return -torch.minimum(d, params["cap"]) / params["scale"]

        return log_pot

    def kernel_planar(self, pattern):
        def log_pot(params, slots):
            d = torch.abs(slots[0] - slots[1])
            return -torch.minimum(d, params["cap"][0:1]) / params["scale"][0:1]

        return log_pot


# Soft-logic combinators for MLN formulas (Łukasiewicz-style):
def land(a, b):
    return a * b


def lor(a, b):
    return a + b - a * b


def lneg(a):
    return 1.0 - a


def limp(a, b):
    """a ⇒ b."""
    return lor(lneg(a), b)


def leq(a, b, scale: float = 1.0):
    """Soft equality of two reals in [0,1]: exp(−(a−b)²/scale)."""
    d = a - b
    return torch.exp(-(d * d) / scale)
