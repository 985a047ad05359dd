"""Lifted compression of the port: colour refinement on the object graph
(``color``) and on the compiled array IR (``fast``)."""

from lhvi_tpu_torch.lift.color import color_refine, compile_lifted, lifting_report

__all__ = ["color_refine", "compile_lifted", "lifting_report"]
