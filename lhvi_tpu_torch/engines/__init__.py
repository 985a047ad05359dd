"""Inference engines of the PyTorch port: ``hmc`` (HMC-within-Gibbs, with
the ``modeswap`` move), ``nuts`` (iterative multinomial NUTS), ``smc``
(annealed SMC), ``vi`` (mixture-of-Gaussian variational inference, lifted
and coarse-to-fine), ``gabp`` (Gaussian BP), ``lbp`` (hybrid loopy BP),
``epbp`` (expectation particle BP), ``map_search`` (hybrid
MaxWalkSAT) and ``resumable`` (checkpointed, resumable HMC/NUTS)."""

__all__ = ["epbp", "gabp", "hmc", "lbp", "map_search", "modeswap", "nuts",
           "resumable", "smc", "vi"]
