from lhvi_tpu_torch.potentials.base import Potential
from lhvi_tpu_torch.potentials.library import (
    GaussianPotential,
    LinearGaussianPotential,
    QuadraticPotential,
    XYPotential,
    TablePotential,
    MLNPotential,
    ImageNodePotential,
    ImageEdgePotential,
    land,
    lor,
    lneg,
    limp,
    leq,
)

__all__ = [
    "Potential",
    "GaussianPotential",
    "LinearGaussianPotential",
    "QuadraticPotential",
    "XYPotential",
    "TablePotential",
    "MLNPotential",
    "ImageNodePotential",
    "ImageEdgePotential",
    "land",
    "lor",
    "lneg",
    "limp",
    "leq",
]
