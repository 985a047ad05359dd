"""Carry the reference's compiled tables and sampler states into the port.

These functions take plain numpy arrays (read off the JAX objects with
``np.asarray``), so this module imports nothing of JAX: with them, both
packages compute the same thing from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from lhvi_tpu_torch.engines.hmc import HMCState, _StreamDiagDisc
from lhvi_tpu_torch.engines.smc import SMCState
from lhvi_tpu_torch.engines.vi import VIParams
from lhvi_tpu_torch.fg.compile import CompiledFG, _tensor

QUAD_TABLES = ("quad_J", "quad_h", "quad_c", "quad_diag", "quad_ell_col",
               "quad_ell_w", "quad_dia_offsets", "quad_dia_w", "quad_dia_pos",
               "quad_dia_inv", "cont_lo", "cont_hi", "n_cont")


def compiled_from_numpy(tables: dict, device) -> CompiledFG:
    """The port's fused-quadratic IR from the reference's arrays.

    ``tables`` holds the keys of ``QUAD_TABLES`` (``None`` where the
    reference's field is ``None``; ``quad_dia_offsets`` is a tuple of ints
    and ``n_cont`` an int). The result has no buckets and no discrete
    latents: it carries exactly the information form the HMC proposal
    reads, so the sampler runs on it as on a compiled graph.
    """
    missing = [k for k in QUAD_TABLES if k not in tables]
    if missing:
        raise KeyError(f"compiled_from_numpy: missing tables {missing}")
    device = torch.device(device)
    n = int(tables["n_cont"])

    def opt(k):
        v = tables[k]
        return None if v is None else _tensor(v, device)

    quad_J = np.asarray(tables["quad_J"], np.float32)
    sparse = tables["quad_diag"] is not None
    offsets = tables["quad_dia_offsets"]
    return CompiledFG(
        buckets=(),
        n_cont=n,
        n_disc=0,
        max_v=1,
        has_quad=True,
        lp_bucket_idx=(),
        meta=None,
        device=device,
        disc_sizes=torch.zeros(0, dtype=torch.int64, device=device),
        disc_vals=torch.zeros((0, 1), device=device),
        cont_lo=_tensor(np.asarray(tables["cont_lo"], np.float32), device),
        cont_hi=_tensor(np.asarray(tables["cont_hi"], np.float32), device),
        cont_ipoints=torch.zeros((n, 1), device=device),
        cont_counts=torch.ones(n, device=device),
        disc_counts=torch.zeros(0, device=device),
        quad_J=_tensor(quad_J, device),
        quad_h=_tensor(np.asarray(tables["quad_h"], np.float32), device),
        quad_c=_tensor(np.asarray(tables["quad_c"], np.float32), device),
        quad_diag=opt("quad_diag"),
        quad_ell_col=opt("quad_ell_col"),
        quad_ell_w=opt("quad_ell_w"),
        quad_sparse=sparse,
        quad_dia_offsets=None if offsets is None else tuple(int(o) for o in offsets),
        quad_dia_w=opt("quad_dia_w"),
        quad_dia_pos=opt("quad_dia_pos"),
        quad_dia_inv=opt("quad_dia_inv"),
    )


def hmc_state_from_numpy(state_dict: dict, device) -> HMCState:
    """The port's ``HMCState`` from a reference state's fields (e.g.
    ``{k: np.asarray(v) for k, v in state._asdict().items()}``).

    Reads the fields the port's state has: continuous positions ``xc``,
    the discrete index state ``xd`` (int64, the port's index type),
    dual-averaging and Welford accumulators, the inverse mass and the
    mode-swap acceptance accumulators. Floats become f32 and integers
    int64.
    """
    missing = [k for k in HMCState._fields if k not in state_dict]
    if missing:
        raise KeyError(f"hmc_state_from_numpy: missing fields {missing}")
    device = torch.device(device)
    out = {}
    for k in HMCState._fields:
        a = np.asarray(state_dict[k])
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        out[k] = _tensor(a, device)
    return HMCState(**out)


def smc_state_from_numpy(state_dict: dict, device) -> SMCState:
    """The port's ``SMCState`` from a reference SMC state's fields (e.g.
    ``{k: np.asarray(v) for k, v in state._asdict().items()}``): particles
    ``xc``/``xd``, log-weights ``log_w`` and ``log_z``. The reference's JAX
    key has no counterpart (the port draws from a ``torch.Generator``) and
    is not read. Floats become f32 and integers int64."""
    missing = [k for k in SMCState._fields if k not in state_dict]
    if missing:
        raise KeyError(f"smc_state_from_numpy: missing fields {missing}")
    device = torch.device(device)
    out = {}
    for k in SMCState._fields:
        a = np.asarray(state_dict[k])
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        out[k] = _tensor(a, device)
    return SMCState(**out)


def stream_diag_disc_from_numpy(acc: dict, device) -> _StreamDiagDisc:
    """The port's streamed discrete-R̂ accumulators (``_StreamDiagDisc``)
    from a reference ``_StreamDiagDisc``'s fields, as f32 tensors."""
    missing = [k for k in _StreamDiagDisc._fields if k not in acc]
    if missing:
        raise KeyError(f"stream_diag_disc_from_numpy: missing fields {missing}")
    return _StreamDiagDisc(*(
        _tensor(np.asarray(acc[k], np.float32), torch.device(device))
        for k in _StreamDiagDisc._fields))


def vi_params_from_numpy(arrays: dict, device) -> VIParams:
    """The port's ``VIParams`` from a reference ``VIParams``'s fields (e.g.
    ``{k: np.asarray(v) for k, v in params._asdict().items()}``): mixture
    log-weights, means, log-scales and categorical logits, as f32 tensors."""
    missing = [k for k in VIParams._fields if k not in arrays]
    if missing:
        raise KeyError(f"vi_params_from_numpy: missing fields {missing}")
    return VIParams(*(
        _tensor(np.asarray(arrays[k], np.float32), torch.device(device))
        for k in VIParams._fields))


def lbp_msgs_from_numpy(msgs, device) -> tuple:
    """The port's LBP message state (``HybridLBP.msgs``) from a reference
    ``HybridLBP.msgs``: one f32 ``[n_f, a, S]`` tensor per bucket."""
    return tuple(_tensor(np.asarray(m, np.float32), torch.device(device))
                 for m in msgs)


EPBP_STATE = ("q_mu", "q_var", "sup", "sup_grid", "lq", "msgs")


def epbp_state_from_numpy(state: dict, device) -> dict:
    """EPBP's final particle state from the reference's arrays (the keys
    of ``EPBP_STATE``): the proposals ``q_mu``/``q_var``, the particle and
    grid supports and their log-proposal (``sup``, ``sup_grid``, ``lq``)
    as f32 tensors, and ``msgs`` as a tuple of f32 ``[n_f, a, W]``
    tensors, one per bucket."""
    missing = [k for k in EPBP_STATE if k not in state]
    if missing:
        raise KeyError(f"epbp_state_from_numpy: missing fields {missing}")
    device = torch.device(device)
    out = {k: _tensor(np.asarray(state[k], np.float32), device)
           for k in EPBP_STATE[:-1]}
    out["msgs"] = tuple(_tensor(np.asarray(m, np.float32), device)
                        for m in state["msgs"])
    return out


def resumable_payload_from_numpy(payload: dict, device):
    """``(HMCState, sums)`` from a reference format-4 checkpoint payload of
    ``engines/resumable.py::sample_checkpointed``, as the JAX
    ``CheckpointManager`` restores it (numpy arrays).

    ``sums`` is the 17-tuple of accumulators the port's
    ``resumable.finalize`` reads (the two moment sums, the discrete counts,
    the acceptance sum, the 9 ``_StreamDiag`` and the 4 ``_StreamDiagDisc``
    arrays). The entries the reference leaves out because they are empty
    are rebuilt from the shapes the others give; a missing non-empty entry
    or another format raises ``ValueError`` as a resume would.
    """
    from lhvi_tpu_torch.engines.resumable import unpack_payload

    st, sums = payload["state"], payload["sums"]
    # the continuous width from the moment sums, the discrete one from the
    # chains' discrete state, the value count from the counts table, the
    # monitored discrete latents from their stream (each absent: empty)
    n_cont = int(np.asarray(sums["0"]).shape[0]) if "0" in sums else 0
    n_disc = int(np.asarray(st["xd"]).shape[1]) if "xd" in st else 0
    max_v = int(np.asarray(sums["2"]).shape[1])
    n_sel = int(np.asarray(sums["13"]).shape[1]) if "13" in sums else 0
    return unpack_payload(payload, torch.device(device), n_cont, n_disc,
                          max_v, n_sel, where="reference payload")
