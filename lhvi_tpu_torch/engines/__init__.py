"""Inference engines of the PyTorch port: ``hmc`` (HMC-within-Gibbs),
``nuts`` (iterative multinomial NUTS) and ``smc`` (annealed SMC)."""

__all__ = ["hmc", "nuts", "smc"]
