"""BASELINE config 2's 10 x 10 grid Gaussian MRF, built with the port's DSL
(``models/toy.py::gaussian_grid``'s potentials) from the benchmark's inputs
and compiled by the port's ``compile_graph`` with its defaults: at 82
latents that is the dense information form, so NUTS runs K3."""

from __future__ import annotations

from portbench.models.gauss_grid128 import build as _build_grid


def build(cfg: dict, inputs: dict, device) -> dict:
    """``fg``, ``layout`` (the program's latent index of each latent node,
    in the reference's ascending node order) and ``compile_s``, as the
    128 x 128 grid's build gives them; raises where the compiler did not
    choose the dense form the configuration states."""
    built = _build_grid(cfg, inputs, device)
    fg = built["fg"]
    if not (fg.cont_pure_quad and not fg.quad_sparse
            and fg.n_cont == cfg["n_latent"]):
        raise ValueError("gauss_grid10: expected the dense information form "
                         f"over {cfg['n_latent']} latents")
    return built
