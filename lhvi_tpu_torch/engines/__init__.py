"""Inference engines of the PyTorch port: ``hmc`` (HMC-within-Gibbs),
``nuts`` (iterative multinomial NUTS), ``smc`` (annealed SMC) and ``vi``
(mixture-of-Gaussian variational inference, lifted and coarse-to-fine)."""

__all__ = ["hmc", "nuts", "smc", "vi"]
